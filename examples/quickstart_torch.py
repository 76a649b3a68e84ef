"""Quickstart on the PyTorch/CUDA port: the paper's core technique in
five minutes (the twin of ``examples/quickstart.py``).

1. Bit-precise SAMD lane arithmetic embedded in uint32 words.
2. The novel op: 1D convolution computed by ONE widening multiply.
3. Constant-kernel overflow analysis choosing minimal lane widths.
4. A quantized matmul with SAMD-packed weights (the serving path): on
   the card it runs the hand-written ``samd_matmul`` kernel, which takes
   bf16 activations; on the CPU its plain PyTorch version.

Run:  PYTHONPATH=src python examples/quickstart_torch.py   (on the card)
      main(device="cpu") runs it on the CPU.
"""
import numpy as np
import torch

from repro_torch.core.conv import make_plan, samd_conv_full
from repro_torch.core.overflow import conv_output_bits, plan_for_kernel
from repro_torch.core.samd import dense_format, pack, samd_add, samd_mul
from repro_torch.core.samd import unpack
from repro_torch.quant.config import QuantConfig
from repro_torch.quant.packing import pack_weights, qmatmul


def main(argv=None, device=None):
    """Print the four sections; returns section 4's relative errors and
    size ratios by bit width."""
    del argv  # no flags, as the reference
    dev = torch.device(device or "cuda")
    rng = np.random.default_rng(0)

    def tensor(a, dtype=torch.int32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    # -- 1. lane-wise arithmetic on 3-bit signed integers ------------------
    fmt = dense_format(bits=3, signed=True)
    a = tensor(rng.integers(-4, 4, size=10))
    b = tensor(rng.integers(-4, 4, size=10))
    aw, bw = pack(a, fmt), pack(b, fmt)
    print("10 x 3-bit lanes fit in", aw.numel(), "uint32 word(s)")
    s = unpack(samd_add(aw, bw, fmt), fmt, 10)
    m = unpack(samd_mul(aw, bw, fmt), fmt, 10)
    print("  a      =", a.cpu().numpy())
    print("  b      =", b.cpu().numpy())
    print("  a+b    =", s.cpu().numpy(), "(mod 2^3, signed)")
    print("  a*b    =", m.cpu().numpy(), "(mod 2^3, signed)")

    # -- 2. convolution as long multiplication ----------------------------
    plan = make_plan(bits=2, taps=3, signed=True)
    x = tensor(rng.integers(-2, 2, size=12))
    k = tensor(rng.integers(-2, 2, size=3))
    out = samd_conv_full(x, k, plan)
    print("\nconv-as-multiplication (2-bit, 3 taps, "
          f"lane={plan.fmt.lane_width}b, {plan.fmt.lanes_per_word} "
          "values/multiply):")
    print("  samd :", out.cpu().numpy())
    print("  numpy:", np.convolve(x.cpu().numpy(), k.cpu().numpy()))

    # -- 3. deploy-time overflow analysis (paper §7) ----------------------
    kernel = np.array([[4, 3, 9, 6]])
    bits = conv_output_bits(kernel, input_bits=4, input_signed=False)
    print(f"\nknown kernel {kernel.tolist()} on 4-bit unsigned input "
          f"needs only {bits} output bits (paper's b+5 example)")
    plan = plan_for_kernel(np.array([[1, -2, 1]]), 3, True, 3)
    print(f"kernel [1,-2,1] at 3-bit: lane width {plan.fmt.lane_width} "
          f"-> {plan.fmt.lanes_per_word} outputs per multiply")

    # -- 4. SAMD-packed quantized matmul (the serving path) ---------------
    w = tensor(rng.normal(size=(512, 256)), torch.float32)
    xx = tensor(rng.normal(size=(4, 512)), torch.float32)
    exact = xx @ w
    results = {}
    for bit in (8, 4, 2):
        cfg = QuantConfig(bits=bit)
        packed, scale = pack_weights(w, cfg)
        y = qmatmul(xx.to(torch.bfloat16), packed, scale, 512, cfg).float()
        err = float((y - exact).abs().mean() / exact.abs().mean())
        ratio = w.numel() * 2 / (packed.numel() * 4)
        results[bit] = {"rel_err": err, "ratio": ratio}
        print(f"  {bit}-bit packed weights: {ratio:.1f}x smaller than "
              f"bf16, rel-err {err:.3f}")
    return results


if __name__ == "__main__":
    main()
