"""PyTorch/CUDA port of SAMD: quantized paged-decode serving and the
paper's bit-precise convolutions.

The package mirrors the module layout of the JAX reference package
``repro`` so each port module has an obvious counterpart, but it imports
neither JAX nor anything of ``repro``: the framework-free pieces it needs
(configs, lane masks, the overflow analysis, the quantization policy) are
its own copies.

Entry points default to the CUDA device; pass ``device="cpu"`` (or CPU
tensors to ``repro_torch.kernels.ops``) to run the plain PyTorch version
of every kernel instead (the CPU tests do). The hand-written Hopper
kernels live in ``repro_torch.kernels.csrc`` and are built with ``nvcc``
at first use.
"""
