"""Batched serving with SAMD-packed weights on the PyTorch/CUDA port: the
continuous batching engine (the twin of ``examples/serve_quantized.py``).

The engine loads a model, SAMD-packs its weights at a chosen precision,
and serves a stream of requests with continuous batching over the paged
KV pool; the packed-vs-bf16 memory ratio and the engine's counters are
reported. On the card the packed linears run the ``samd_matmul`` kernel
(its split-K launcher at decode, its tile launcher at prefill) and
attention the paged decode kernel; ``--speculative K`` adds the draft's
ring fold and the verify kernel. The device chooses between the kernels
and their plain PyTorch versions, so the reference's ``--backend`` flag
has no counterpart here.

Run:  PYTHONPATH=src python examples/serve_quantized_torch.py [--bits 4]
      main(argv, device="cpu") runs it on the CPU.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.archs import get_arch
from repro_torch.models.quantize import tree_bytes
from repro_torch.quant.config import QuantConfig
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None, device=None):
    """Serve as the flags say; returns the engine (its ``finished``
    requests and ``stats``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=4,
                    help="SAMD weight precision (0 = bf16)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 samples (Gumbel-max)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-batch", type=int, default=3)
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="self-speculative decoding: an 8-bit SAMD draft "
                         "(a packed target is its own draft) proposes K "
                         "tokens/slot/tick, verified in one multi-token "
                         "step (0 = off)")
    args = ap.parse_args(argv)
    dev = torch.device(device or "cuda")

    cfg = get_arch("qwen1.5-0.5b").scaled(
        n_layers=4, d_model=256, vocab=2048, n_heads=4, n_kv_heads=4,
        head_dim=64, d_ff=704, scan_layers=False, attn_chunk=128,
    )
    quant = QuantConfig(bits=args.bits) if args.bits else None
    # the reference passes an 8-bit draft_quant and ignores it for a
    # packed target; the port's engine refuses it there
    eng = ServingEngine(cfg, quant=quant, max_batch=args.max_batch,
                        max_len=160, temperature=args.temperature,
                        speculative=args.speculative,
                        draft_quant=None if quant else QuantConfig(bits=8),
                        device=dev)

    n_bytes = tree_bytes(eng.params)
    print(f"engine up: {cfg.n_layers}L d={cfg.d_model}, weights "
          f"{'SAMD-' + str(args.bits) + 'bit' if quant else 'bf16'} "
          f"({n_bytes/1e6:.1f}MB), {args.max_batch} slots")

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(4, 24)))
        eng.submit(Request(rid=i, prompt=prompt,
                           max_tokens=int(rng.integers(4, 10))))
    done = eng.run_to_completion()
    dt = time.time() - t0

    total_tokens = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s on {dev.type})")
    print(f"  fused decode steps: {eng.stats['decode_steps']}, "
          f"batched prefills: {eng.stats['prefill_calls']}, "
          f"per-row forwards: {eng.stats['per_row_forward_calls']}")
    print(f"  KV: {eng.kv_mode} ({eng.num_pages} pages x {eng.page_size} "
          f"tokens, {eng.kv_cache_bytes()/1e6:.2f}MB resident, "
          f"{eng.stats['page_grants']} mid-decode grants)")
    if args.speculative:
        acc, prop = eng.stats["draft_accepted"], eng.stats["draft_proposed"]
        print(f"  speculative: K={args.speculative}, "
              f"{eng.stats['spec_ticks']} draft+verify ticks, "
              f"accept rate {acc / max(prop, 1):.2f} ({acc}/{prop})")
    for r in sorted(done, key=lambda r: r.rid):
        flags = " [truncated]" if r.truncated else ""
        flags += f" [error: {r.error}]" if r.error else ""
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> "
              f"{r.generated}{flags}")
    return eng


if __name__ == "__main__":
    main()
