"""End-to-end run on the PyTorch/CUDA port: train a small LM for a few
hundred steps, checkpoint it, SAMD-quantize the result, and compare
serving quality -- the paper's full train -> freeze -> analyse -> pack ->
deploy pipeline (the twin of ``examples/train_e2e.py``, whose sizes it
keeps).

On the card the packed forwards run the ``samd_matmul`` kernel's tile
launcher (batch x sequence rows); on the CPU its plain PyTorch version.
Parameters are drawn with a ``torch.Generator`` from seed 0, so the run
starts from other weights than the reference's ``jax.random`` draw.

Run:   PYTHONPATH=src python examples/train_e2e_torch.py [--steps 200]
       main(argv, device="cpu") runs it on the CPU.
4.3M parameters by default; --big is the reference's larger config, 42.1M
parameters (8 layers, d 512, vocab 32000; the reference calls it ~100M).
"""
import argparse
import os
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.archs import get_arch
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data import SyntheticLM
from repro_torch.launch import steps as steps_mod
from repro_torch.models.model import build_template, forward
from repro_torch.models.quantize import quantize_params, tree_bytes
from repro_torch.models.spec import init_from_spec
from repro_torch.optim import adamw_init
from repro_torch.quant.config import QuantConfig
from repro_torch.tree import tree_leaves


def main(argv=None, device=None):
    """Train, checkpoint and pack as the flags say; returns the run's
    numbers (``n_params``, ``losses`` by step, ``fp_bytes``,
    ``packed_bytes`` and ``agreement`` by bit width), its final
    ``params`` and ``opt`` state and the checkpoint directory
    ``ckdir``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--big", action="store_true",
                    help="the larger config, 42.1M params (slower on CPU)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    dev = torch.device(device or "cuda")

    base = get_arch("qwen1.5-0.5b")
    if args.big:  # 42.1M params
        cfg = base.scaled(n_layers=8, d_model=512, d_ff=1408,
                          n_heads=8, n_kv_heads=8, head_dim=64,
                          vocab=32000, scan_layers=False, attn_chunk=128)
    else:        # CPU-friendly 4.3M params
        cfg = base.scaled(n_layers=4, d_model=256, d_ff=704,
                          n_heads=4, n_kv_heads=4, head_dim=64,
                          vocab=4096, scan_layers=False, attn_chunk=128)

    run = RunConfig(
        arch=cfg, shape=ShapeConfig("t", args.seq_len, args.batch, "train"),
        learning_rate=6e-4, lr_warmup=20,
    )
    template = build_template(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_from_spec(template, gen, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch {cfg.name}-reduced: {n_params/1e6:.1f}M params, "
          f"{cfg.n_layers}L d={cfg.d_model}")

    opt = adamw_init(params)
    step = steps_mod.make_train_step(cfg, run)
    data = SyntheticLM(cfg.vocab, args.seq_len, args.batch, seed=0)
    ckdir = os.path.join(tempfile.gettempdir(), "repro_torch_e2e_ckpt")
    mgr = CheckpointManager(ckdir, keep=2)

    def batch_on_device():
        return {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}

    losses = {}
    for i in range(args.steps):
        params, opt, metrics = step(params, opt, batch_on_device())
        if i % 20 == 0 or i == args.steps - 1:
            losses[i] = float(metrics["loss"])
            print(f"step {i:4d} loss {losses[i]:.4f} "
                  f"lr {float(metrics['lr']):.2e}")
        if i and i % 100 == 0:
            mgr.save(i, {"params": params, "opt": opt})
    mgr.save(args.steps, {"params": params, "opt": opt}, blocking=True)
    print(f"checkpointed to {ckdir}")

    # deployment: SAMD-pack the trained weights and measure agreement
    tokens = batch_on_device()["tokens"]
    with torch.no_grad():
        pred_fp = forward(params, tokens, cfg).float().argmax(-1)
    fp_bytes = tree_bytes(params)
    packed_bytes, agreement = {}, {}
    print("\nSAMD deployment (weight packing + next-token agreement):")
    for bits in (8, 4, 3, 2):
        q = quantize_params(params, template, QuantConfig(bits=bits))
        with torch.no_grad():
            pred_q = forward(q, tokens, cfg).float().argmax(-1)
        agree = agreement[bits] = float((pred_fp == pred_q).float().mean())
        packed = packed_bytes[bits] = tree_bytes(q)
        print(f"  {bits}-bit: params {fp_bytes/1e6:.1f}MB -> "
              f"{packed/1e6:.1f}MB, greedy-token agreement "
              f"{agree*100:.1f}%")
    return {"n_params": n_params, "losses": losses, "fp_bytes": fp_bytes,
            "packed_bytes": packed_bytes, "agreement": agreement,
            "params": params, "opt": opt, "ckdir": ckdir}


if __name__ == "__main__":
    main()
