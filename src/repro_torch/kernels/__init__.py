"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their plain
PyTorch versions; ``ops`` dispatches by device."""
