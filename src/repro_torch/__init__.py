"""PyTorch/CUDA port of the SAMD quantized paged-decode serving path.

The package mirrors the module layout of the JAX reference package
``repro`` so each port module has an obvious counterpart, but it imports
neither JAX nor anything of ``repro``: the framework-free pieces it needs
(configs, lane masks, the quantization policy) are its own copies.

Entry points default to the CUDA device; pass ``device="cpu"`` to run the
plain PyTorch version of every kernel instead (the CPU tests do). The two
hand-written Hopper kernels live in ``repro_torch.kernels`` and are built
with ``nvcc`` at first use.
"""
