"""Training entry point: end-to-end training on one device (the port of
``repro/launch/train.py``, with its flags and printed lines).

  * checkpoint/restart: ``--resume`` restores the latest checkpoint (step,
    params, AdamW state) and the data pipeline seeks to the restored step;
    checkpoints are the reference's format and layout, so either package
    resumes the other's run;
  * straggler watchdog: logs any step slower than ``--watchdog-factor`` x
    the running median;
  * optional gradient compression (int8 / SAMD-packed int4 with error
    feedback): ``--grad-compression 8``;
  * ``--qat-bits`` is parsed and, as in the reference, not used
    (``quant.quantizer.fake_quant`` is the QAT building block).

Parameters are drawn from ``--seed`` with a ``torch.Generator`` on the
device (the reference draws from ``jax.random``, so a fresh run starts
from other weights; a resumed run starts from the checkpoint's).

Example (on the GPU; ``main(argv, device="cpu")`` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --smoke --steps 50 --batch 8 --seq-len 128
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.archs import ARCHS, get_arch, smoke_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data import SyntheticLM
from repro_torch.distributed.compression import compress_tree, init_residuals
from repro_torch.launch import steps as steps_mod
from repro_torch.models.convert import port_layout, reference_layout
from repro_torch.models.model import build_template
from repro_torch.models.spec import init_from_spec
from repro_torch.optim import AdamWState, adamw_init, adamw_update
from repro_torch.optim import cosine_warmup


def _checkpoint_tree(params, opt: AdamWState, cfg):
    """{"params", "opt"} in the reference's layout (stacked blocks when
    ``cfg.scan_layers``), as the reference's train.py saves it."""
    return {"params": reference_layout(params, cfg),
            "opt": AdamWState(opt.step, reference_layout(opt.m, cfg),
                              reference_layout(opt.v, cfg))}


def main(argv=None, device="cuda"):
    """Train as the flags say; returns the final parameters (the port's
    layout, on ``device``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--qat-bits", type=int, default=None)
    ap.add_argument("--grad-compression", type=int, default=None,
                    choices=(4, 8))
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--watchdog-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(device)

    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    shape = ShapeConfig("custom", args.seq_len, args.batch, "train")
    run = RunConfig(arch=cfg, shape=shape, learning_rate=args.lr,
                    grad_accum=args.grad_accum)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_from_spec(build_template(cfg), gen, device=device)
    opt_state = adamw_init(params)
    residuals = init_residuals(params) if args.grad_compression else None

    if args.grad_compression:
        # compression-aware step: the deployed system compresses the
        # all-reduce payload; training dynamics must match, so the same
        # quantize -> dequantize (+ error feedback) applies to the grads
        loss_fn = steps_mod.make_loss_fn(cfg, run)

        def step_fn(params, opt_state, residuals, batch):
            lr = cosine_warmup(opt_state.step, peak_lr=run.learning_rate,
                               warmup=run.lr_warmup)
            loss, grads = steps_mod.value_and_grad(loss_fn, params, batch)
            grads, residuals = compress_tree(
                grads, residuals, bits=args.grad_compression)
            new_p, new_o, m = adamw_update(
                grads, opt_state, params, lr,
                weight_decay=run.weight_decay, grad_clip=run.grad_clip)
            return new_p, new_o, residuals, {"loss": loss, "lr": lr, **m}
    else:
        train_step = steps_mod.make_train_step(cfg, run)

    data = SyntheticLM(cfg.vocab, args.seq_len, args.batch, seed=args.seed)
    ckpt = (CheckpointManager(args.checkpoint_dir)
            if args.checkpoint_dir else None)

    start_step = 0
    if ckpt and args.resume:
        restored = ckpt.restore(_checkpoint_tree(params, opt_state, cfg),
                                device=device)
        if restored is not None:
            tree, start_step, _ = restored
            params = port_layout(tree["params"])
            opt = tree["opt"]
            opt_state = AdamWState(opt.step, port_layout(opt.m),
                                   port_layout(opt.v))
            data.seek(start_step)
            print(f"resumed from step {start_step}")

    times: list[float] = []
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(data).items()}
        t0 = time.time()
        if args.grad_compression:
            params, opt_state, residuals, metrics = step_fn(
                params, opt_state, residuals, batch)
        else:
            params, opt_state, metrics = train_step(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        times.append(dt)
        if len(times) > 20:
            times.pop(0)
        med = statistics.median(times)
        if dt > args.watchdog_factor * med and len(times) >= 5:
            print(f"[watchdog] step {step} took {dt:.3f}s "
                  f"(median {med:.3f}s) — straggler suspected")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} "
                  f"lr {metrics['lr']:.2e} {dt*1e3:.0f}ms")
        if ckpt and step > 0 and step % args.checkpoint_every == 0:
            ckpt.save(step, _checkpoint_tree(params, opt_state, cfg),
                      meta={"arch": cfg.name})
    if ckpt:
        ckpt.save(args.steps, _checkpoint_tree(params, opt_state, cfg),
                  meta={"arch": cfg.name}, blocking=True)
    print("training done")
    return params


if __name__ == "__main__":
    main()
