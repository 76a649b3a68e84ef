#!/usr/bin/env python3
"""Run the PyTorch/CUDA port end to end on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root
    python3 chip_smoke.py --old-matmul OLD/samd_matmul.cu   # + old vs new
    python3 chip_smoke.py --old-conv OLD/samd_conv.cu       # the same, conv
    python3 chip_smoke.py --old-attention OLD/paged_attention.cu  # attention

Phases, any failure exits non-zero:
  (a) build every CUDA kernel of ``src/repro_torch/kernels/csrc`` with nvcc
      for sm_90a, one process per source, all at once;
  (b) hold each kernel launcher against its plain PyTorch version on the
      card at the serving path's shapes (stated tolerances below); the
      matmul at M = 8, 24, 32 (its split-K launcher) and 33, 1024 (its
      tile launcher), each case launching exactly the launcher of
      ``launcher_for(M)`` and bit-identical on a second call, and reading
      the packed codes exactly through both launchers; and (b')
      that the speculative verify kernel and the decode kernel's draft
      ring fold agree with theirs at each run of (e)'s own S = K + 1 and
      R = K (and at S = 2, 5 and R = 4, G = 1 and 4), rows at -1 and
      empty slots giving exact zeros;
  (c) serve full-width qwen1.5-0.5b (24 layers, seeded random weights,
      4-bit SAMD weights through the kernel route) with ``ServingEngine``:
      16 greedy requests, prompts of 32-256 tokens, 32 new tokens each,
      once with bf16 KV and once with packed int8 KV; every request must
      finish untruncated, the path's launchers (the matmul's split-K for
      decode and tile for prefill, decode attention) must have launched
      and no other, and the model's logits on a small
      input must agree with the same model run through the kernels' plain
      versions on the CPU;
  (e) serve the same workload speculatively: run A, a bf16 target with an
      8-bit SAMD draft, ``speculative=4``, bf16 KV; run B, the 4-bit
      packed-int8-KV target of (c) as its own draft, ``speculative=2``.
      Each must finish every request untruncated, launch the matmul's
      split-K launcher (and its tile launcher where the run's prefill
      runs packed weights: run B), the ring-fold decode and the verify
      launchers (and not the plain decode one), and give plain greedy decode's tokens (run A against a plain
      run of its bf16 target, run B against (c)'s int8-KV run), or part
      from them only at a token where a full forward of the prefix on the
      card has a top-1/top-2 margin under ``MODEL_TOL`` of its largest
      logit. Each prints its ms per speculative tick (median, and split
      into the engine's draft and verify steps by CUDA events around
      them), tokens/s, accept rate, mean
      tokens per slot per tick and peak memory;
  (d) time each launcher at its main-path shape beside its plain version,
      the one PyTorch call that computes the same function (``library_ms``,
      a yardstick the port never calls) and its bound: the larger of its
      bytes over 3.35 TB/s and its operations over 989 TFLOP/s (H100 SXM
      HBM3 and dense bf16 peaks). The matmul is timed at decode (M = 8,
      each run's weights), run B's verify (M = 24) and a prefill
      (M = 1024) as device time: the 24 layers' launches captured in a
      CUDA graph and replayed under CUDA events, for the kernel and for
      dense bf16 ``torch.matmul`` alike (``ms``, ``library_ms``), beside
      the host-paced times and the wrapper's host time per call; with
      ``--old-matmul SOURCE`` also a previous ``samd_matmul.cu``, in
      turns (old, new, new, old) on the same weights. Decode attention
      at (c)'s shapes and, in (d'), the verify kernel at run A's and run
      B's shapes and the ring fold at the draft's are device times the
      same way (24 layers' launches in a CUDA graph; SDPA over the KV
      gathered beforehand alike), with the host-paced times and the
      wrapper's host time per call (also inside a ``torch.cuda.device``
      context, as the wrapper entered one on every call before) beside;
      with ``--old-attention SOURCE`` also a previous
      ``paged_attention.cu`` (three launchers without the split
      arguments), in turns on the same pools. Two kernel-only rows at
      qwen3-14b's attention shape (Hkv = 8, G = 5, dh = 128, 40 layers of
      seeded pools at the same positions): decode, and the verify at
      S = 3;
  (f) run the paper's VGG-B convolutions: all 10 conv layers at their
      published shapes (3x3, padding 1, seeded f32 x and weights) at 2, 4
      and 8 bits, and conv3_1 at 4 bits with bf16 x, through
      ``ops.samd_conv2d``, each held against ``samd_conv2d_plain`` and
      ``F.conv2d`` of the dequantized weight (``CONV_F32_TOL`` for f32,
      ``BF16_TOL`` for bf16); then a 1D signal of 3,211,264 values
      (conv1_2's input activations) with 3 taps through
      ``ops.samd_conv1d``, one fused launch each (``samd_conv1d_launch``):
      int64 x for the plans 2, 3, 4 bits signed and 4 bits unsigned, int8
      x for 4 bits signed, and a view x[1:] (not 16-byte aligned), each
      bit-identical to ``samd_conv1d_plain`` and to a direct integer
      convolution. Exactly the conv launchers of the rule run
      (``samd_conv.conv2d_plan``: conv1_1's 3 cases on the im2col
      launcher, the other 28 on the direct one; the fused conv1d launcher
      6 times, the chunk launcher none), and (c) and (e) launch none. The
      chunk launcher, the TPU function's counterpart, then runs on a path
      of its own (counts reset before it): the four int64 plans' packed
      words, 4 launches, each bit-identical to its plain version and
      overlap-added to the fused output. (f') times each layer as device
      time (the call in a CUDA graph, replayed; ``F.conv2d`` alike), with
      the host-paced times beside it, the wrapper's host time per call and
      the plain version, against the bound of the kernel's route: the
      larger of its bytes over 3.35 TB/s and its operations times its bf16
      MMA terms (two for f32 x) over the 989 TFLOP/s bf16 tensor-core
      peak, the first version's f32 CUDA-core bound (67 TFLOP/s) beside
      it; with ``--old-conv SOURCE`` also a previous ``samd_conv.cu``, in
      turns (old, new, new, old) on the same inputs. For each samd_conv1d
      case (the x[1:] view aside) it times, as device time with L2 cold
      (``cold_graph_ms``), the fused op, the previous unfused composition
      (PyTorch packing, the chunk launcher, the strided overlap-add; in
      turns unfused, fused, fused, unfused), the chunk launcher alone and
      ``F.conv1d`` in f32 on the pre-cast signal, each beside its bytes
      bound, its host-paced time and the wrapper's host time per call;
  (g) serve (c)'s bf16-KV engine through the async front door
      (``AsyncServer``, the engine's tick in a worker thread,
      ``max_queue=64``): warm it through a server, measure capacity as
      the median of three closed-loop bursts of (c)'s 16 requests
      (``capacity_rps``, ``capacity_tokens_per_s``, the spread printed),
      serve the same burst through ``AsyncServer`` with the step inline
      and in a worker thread in turns (inline, thread, thread, inline:
      the tick medians and tokens/s of each side), serve 80 requests of
      the same shape directly for their reference tokens, then, with the
      launch counts reset just before them, three open-loop rows, each on
      a fresh server after
      ``engine.reset()``, with Poisson arrivals: 0.5x capacity_rps with
      the ``slo`` policy (40 requests), 2.5x ``slo`` (80) and 2.5x
      ``fifo`` with no SLO (80); the SLO is 30 / capacity_rps s. Each row
      must conserve requests (completed + rejected == offered, the
      server's completed counter alike), stream each request's own
      tokens, give a Prometheus snapshot that parses with the server's
      counters, stamp every completed request in order (submit <= admit
      <= first token <= retire), give the direct run's tokens (or part
      at a near-tie, as (e) checks) and launch exactly the matmul's
      split-K and tile launchers and decode attention; each row is
      bounded (``FRONT_DOOR_TIMEOUT_S``), so a serve loop that died exits
      non-zero. Each row prints p50 / p99 TTFT, TPOT and e2e, refusals by
      code, deadline misses, goodput, the tick median with the step in a
      thread beside (c)'s inline one, the arrival lag (submit time minus
      scheduled arrival) p50 / p99, the snapshot's key count and its
      launch counts while it served; the kernels line's ``(front door
      ...)`` entries carry the sum of the three rows' launches only.

  (h) the engine's other modes and the rest of QuantConfig: (h1) (c)'s
      4-bit bf16-KV engine (full width and depth, the same 16 requests) in
      ``kv_mode="ring"`` and with ``paged_attn="gather"``, and (h2) with
      ``decode_mode="per_row"`` on the first 4 requests, 8 tokens each;
      each gives (c)'s fused paged run's tokens (or parts at a near-tie,
      as (e) checks), launches the matmul's split-K and tile launchers
      and no attention kernel, and prints its tick median and tokens/s
      beside (c)'s (the per-row run's per-row forwards counted); (h3)
      full-width qwen3-14b (40 layers, seeded random weights, 4-bit with
      ``quantize_embeddings=True``, so its untied LM head [5120, 151936]
      runs the split-K launcher, bf16 KV, max_batch 8, max_len 512) serves
      (c)'s 16 requests, its logits held against the plain versions run on
      the card (``plain_versions``: the wrappers' CPU branch on the card's
      tensors) within ``MODEL_TOL``, and what that check sees with the
      kernels' scales x1.02 printed beside; (b) checks the matmul at its
      five (K, N) shapes, LM head included, at M = 8 and 1024 (element
      by element and by relative RMS) and its attention shape (G = 5, dh
      = 128), and its decode linears, LM head and a prefill are timed as
      in (d), dense bf16 ``torch.matmul`` and the bytes bound beside;
      (h4) the same model
      with ``group_size=128`` serves 4 requests through the dequantize
      route (no matmul launcher runs; decode attention does), with its
      tick and peak memory; (h5) every launch plan of (b)-(h) (recorded
      from the launchers' arguments) has a shared-memory estimate
      (``analysis.contracts``) at least the kernel's own (its source's
      ``*_smem_bytes`` query: the static bytes the runtime reports for the
      compiled kernel plus the dynamic bytes its launcher passes) and
      within 227 KB; ``act_bits=8`` is refused at engine
      construction exactly where K x 2^(bits-1) x 2^7 passes 2^24
      (qwen1.5-0.5b at 4 and 8 bits, qwen3-14b at 4 bits); and
      ``python -m repro_torch.analysis.certify`` reports 0 unsafe.
      (h5) runs after (i), so it covers (i)'s launch plans too.

  (i) the reference's other families at full width, seeded random
      weights, 4-bit with the LM head packed (``quantize_embeddings``),
      (c)'s workload (16 greedy requests, prompts of 32-256 tokens drawn
      from each arch's vocabulary, 32 new tokens, ``max_batch=8``,
      ``max_len=512``, ``page_size=16``): decode attention first checked
      against its plain version at olmoe-1b-7b's shape (16 heads, G = 1,
      dh = 128) and nemotron-4-15b's (8 kv-heads, G = 6), bf16 and int8
      pools; then (i1) olmoe-1b-7b (16 layers, d 2048, 64 experts top-8,
      expert d_ff 1024, vocab 50304) on the paged pool with fused
      attention, bf16 KV: the main path of this slice, its experts
      dequantized by ``materialize`` as the reference does; (i2)
      rwkv6-3b (32 layers, d 2560, d_ff 8960, vocab 65536) and (i3)
      zamba2-7b (``ZAMBA2_LAYERS`` of its 81 layers, d 3584, 32 heads of
      dh 112, ssm_state 64, shared attention after every 6th layer) on
      the ring, which ``kv_mode="auto"`` picks for them. Each run must
      finish every request untruncated and launch exactly its launchers
      (split-K, tile, and decode attention for olmoe; no per-row
      forward on the ring); its logits agree with the plain versions run
      on the card within ``MODEL_TOL`` (paged: (c)'s check; ring: per-row
      prefills into a fresh cache, then a decode token a row); the same
      engine then serves the same requests with the plain versions, and
      the kernels' greedy tokens must equal those or part where a full
      forward of the prefix has a top-1/top-2 logit margin under
      ``MODEL_TOL`` of the largest logit or, for MoE, where the routed
      expert sets of the kernels and the plain versions differ only at
      tokens whose k-th / (k+1)-th router probabilities are that close;
      (b)'s checks and (d)'s device times run at each distinct (K, N) of
      the run's own packed weights at M = 8 and at a prefill (1024 rows
      for olmoe, 256 for the per-row prefills of the ring), its LM head,
      and olmoe's decode attention over its pools. Each run prints tick
      ms, tokens/s and peak GiB (serving and built); olmoe also the
      share of a decode step's device time its experts' dequantize
      takes (CUDA events around every ``layers.materialize`` call inside
      the engine's decode steps).

  (j) training: (j1) full-width qwen1.5-0.5b (24 layers, d 1024, vocab
      151936, tied embeddings; seeded random weights on the card) takes
      ``TRAIN_STEPS`` = 20 AdamW steps of SyntheticLM (seed 0) at batch 8,
      seq 256, lr 3e-4 after a 5-step warm-up, through
      ``launch.steps.make_train_step``: every loss and gradient norm
      finite, the mean of the last 5 losses below the mean of the first
      5, no SAMD kernel launched (counts reset before); it prints the
      median step time (synchronized, steps 2-20), tokens/s, peak memory
      and the model-FLOPs share ``mfu`` (``analytic_costs.cell_cost``
      flops over the step time over 989 TFLOP/s); (j2) the same model cut
      to 2 layers: one step's loss, gradient norm and every gradient on
      the card against the port on the CPU (the CPU tests' tolerances),
      the embedding gradient bit-identical over two runs, then on the
      card remat against no remat and grad_accum=2 against one batch
      (the reference's tolerances); (j3) ``launch.train.main`` at full
      width saved at step 3 and resumed to step 6 against 6 uninterrupted
      steps (within 5e-2; the difference printed), its checkpoint's leaf
      names and dtypes the reference's stacked layout; (j4) the 20-step
      weights quantized 4-bit and served by ``ServingEngine`` (fused
      attention, bf16 KV) on 8 of (c)'s requests: untruncated, exactly
      the split-K, tile and decode-attention launchers, greedy tokens
      equal to the same engine's run under ``plain_versions()`` or
      parting at a near-tie (``check_greedy``); the 8- and 4-bit argmax
      agreement with the bf16 model on a held-out batch printed; (j5)
      tests/test_system.py's config trained 40 steps on the card: 8- and
      4-bit argmax agreement >= 0.9 and >= 0.6, forward on the card.

  (k) the paper's 64-bit SAMD words (int64 tensors holding the uint64
      bits), eager PyTorch on the card, no SAMD kernel launched: (k1)
      ``core.conv.samd_conv_full`` at ``word_bits=64`` on (f)'s five
      signals (2/3/4-bit signed and 4-bit unsigned, 3 taps, as int64)
      bit-identical to (f)'s 32-bit ``samd_conv1d`` kernel outputs and to
      the convolution in float64; (k2) ``samd_conv_multichannel`` at 64
      bits on 64 channels x 50,176 positions (conv1_2's input), 2/3/4
      bits signed, lanes from ``overflow.plan_for_kernel``, against the
      exact channel sum, printing whether a 32-bit word holds the plan
      (not at 3 and 4 bits), and ``samd_conv_grouped(word_bits=32)``
      giving the same sum; (k3) ``conv_by_scale`` (2^20 values, 4 and 8
      bits), ``samd_conv_grouped`` (64 x 16,384 values) and the codegen
      add / sub / mul (2^20 words; 3, 4, 8 bits; both spacer regimes) at
      64 bits against their 32-bit results. The first ``CPU_SLICE``
      positions (or words) of each 64-bit result, and (k1)'s chunk
      products as (hi, lo) words, are recomputed on the CPU and must be
      bit-identical (wrapping int64 multiplies and shifts on the card).
      Each case prints its device ms at 64- and 32-bit words (CUDA
      events, in turns); nothing is gated on them.
  (l) distribution on one card: an NCCL process group of world size 1
      and a (1, 1) ("data", "model") ``DeviceMesh``; (l1) ``DIST_STEPS`` =
      2 AdamW steps of (j1)'s full-width qwen1.5-0.5b (its seeded weights
      and first SyntheticLM batches) with parameters, moments and batch as
      DTensors placed by ``distributed.sharding`` (``param_pspecs``,
      ``data_pspec``, ``placements``), held to the plain step's loss,
      gradient norm and parameters within (j2)'s tolerances, every leaf
      on its placements after each step; bit-identity and the step times
      printed beside the plain ones, and ``CommDebugMode``'s collective
      counts (one card moves no bytes between ranks; the ranks are held
      on the CPU by tests/test_torch_distributed.py); (l2)
      ``compressed_psum`` at 8 and 4 bits on 2^24 floats against
      dequantize(quantize(x)); (l3) the sharded weights saved and
      restored with ``load_checkpoint(..., shardings=)``, bit-identical.
      The process group is destroyed at the end of the phase.
  (m) the multi-pod dry-run (``launch.dryrun.lower_cell``), each cell
      as rank 0 of a fake process group, every tensor fake on a cuda
      mesh: (m1) qwen3-14b train_4k on 2x16x16 (remat), (m2) qwen3-14b
      decode_32k at 4 bits with int8 KV on 16x16, (m3) olmoe-1b-7b
      prefill_32k at 4 bits, (m4) zamba2-7b long_500k; each prints its
      result dict and must be ``ok`` with no kernel launched (the matmul
      wrapper gives a fake tensor its output's shape only); (m5) (l)'s
      NCCL world-1 (1, 1) mesh with (c)'s 4-bit qwen1.5-0.5b placed
      serve-mode: one ``make_prefill_step`` and 8 ``make_serve_step``
      calls on DTensors (each rank's own packed words through the matmul
      kernels) give the ids of the same steps on plain tensors, with
      both matmul launchers counted in the DTensor run.
  (n) the port's lint and the example twins: (n1)
      ``tools/samd_lint_torch.py src/repro_torch --certify
      BENCH_serving.json`` exits 0; each twin's ``main`` on the card,
      launch counts reset just before it: (n2) ``quickstart_torch``
      (sections 1-3 printed as on the CPU, section 4's errors within 1e-3
      of the CPU's, one split-K launch a bit width), (n3)
      ``serve_quantized_torch`` at 4 bits (split-K, tile, decode
      attention; greedy tokens against the same run under the plain
      versions) and with ``--speculative 2`` (split-K, tile, ring fold,
      verify; against the first run), every request untruncated; (n4)
      ``train_e2e_torch --big`` (42.1M parameters, 200 steps): the loss
      falls, the packed forwards at 8, 4, 3 and 2 bits launch the tile
      launcher, and the last checkpoint restores onto the card
      bit-identical. In every run on the card, the first matmul launch at
      each (launcher, M, K, N, bits) the path gives is held, on the
      inputs the path gave it, against its plain version (BF16_TOL).
      Each prints its seconds.

The last three lines are the card's name and power limit from nvidia-smi,
one JSON object with every launcher's numbers, and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, the script exits non-zero with
no result.
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import functools
import gc
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
# kernel vs plain on the card: both accumulate in f32 and round the output
# to bf16 (8 significant bits), in different orders, so they may land one
# or two bf16 rounding steps apart: rtol = atol = 1e-2 of the output scale
BF16_TOL = 1e-2
# the same, as the RMS of kernel - plain over the RMS of plain: the products
# are exact and both sums f32, so outputs differ only where the two sums
# round to neighbouring bf16 values, one step (2^-8 to 2^-7 of the value)
# on a few elements; a kernel off by a systematic 1% reads 1e-2
BF16_RMS_TOL = 2.0 ** -8
# f32 conv kernel vs plain and vs F.conv2d: the same f32 products summed in
# another order (up to 4608 terms at conv5): max |kernel - reference| <=
# 1e-4 x max |reference|
CONV_F32_TOL = 1e-4
# full model through the kernels vs through the plain versions (on the CPU,
# or for qwen3-14b on the card): bf16 differences of that size compound
# over the layers. 5e-2 of the largest logit. Readings on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md section 6): sound runs 1.3-1.7%
# (qwen1.5-0.5b, 24 layers) and 4.2-4.3% (qwen3-14b, 40 layers, where (b)
# reads a relative RMS of 1.5e-5 to 5e-5 at every linear shape); with the
# kernels' scales x1.02 (``scale_controls``) 9.2-9.7% for every block
# linear, which fails, but 4.5-5.2% for one wd or the LM head, which
# this check cannot tell from sound. It catches a wrong route, layout or
# cache; an error of a few percent in one kernel is (b)'s BF16_RMS_TOL
MODEL_TOL = 5e-2
SERVE = dict(max_batch=8, max_len=512, page_size=16)
N_REQUESTS, MAX_TOKENS = 16, 32
SPLITK = "samd_matmul_splitk_launch"
TILE = "samd_matmul_tile_launch"
MM_SOURCE = "src/repro_torch/kernels/csrc/samd_matmul.cu"
DECODE = "paged_decode_attention_launch"
RING = "paged_decode_ring_attention_launch"
VERIFY = "paged_verify_attention_launch"
CONV2D = "samd_conv2d_launch"
CONV2D_IM2COL = "samd_conv2d_im2col_launch"
CHUNKS = "samd_conv_chunks_launch"
CONV1D = "samd_conv1d_launch"
PA_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
CONV_SOURCE = "src/repro_torch/kernels/csrc/samd_conv.cu"
CONV_BITS = (2, 4, 8)
# (f)'s bf16 layer and the layer whose numbers stand in the kernels line
CONV_BF16_CASE = ("conv3_1", 4)
CONV_ENTRY_CASE = ("conv3_2", 4)
# conv1_2's input activations (64 x 224 x 224) as one 1D signal, 3 taps:
# (bits, signed, x's dtype) of (f)'s samd_conv1d runs, and one more on a
# view x[1:] of the entry case's signal (not 16-byte aligned)
CONV1D_N, CONV1D_TAPS = 64 * 224 * 224, 3
CONV1D_CASES = ((2, True, torch.int64), (3, True, torch.int64),
                (4, True, torch.int64), (4, False, torch.int64),
                (4, True, torch.int8))
CONV1D_ENTRY_CASE = (4, True, torch.int64)
L2_BYTES = 50 * 2 ** 20  # H100 SXM
# the speculative serving runs of (e): (run, KV format, K); (b') checks the
# verify kernel at each run's S = K + 1 and the ring fold at its R = K
SPEC_RUNS = (("A", "bf16", 4), ("B", "int8", 2))
MATMUL_SHAPES = [(1024, 1024), (1024, 2816), (2816, 1024)]
# (b)'s rows of x: decode, run B's verify (8 x 3), both sides of the
# split-K / tile switch (32), and a prefill
MATMUL_CHECK_M = (1, 8, 24, 32, 33, 1024)
# (b)'s qwen3-14b shapes, 4-bit: (K, N) of the untied LM head, wq / wo,
# wk / wv, wg / wu and wd, at decode (M = 8) and a prefill (M = 1024)
QWEN3_MATMUL_SHAPES = ((5120, 151936), (5120, 5120), (5120, 1024),
                       (5120, 17408), (17408, 5120))
QWEN3_CHECK_M = (8, 1024)
# (h3) relative changes of the kernels' scales whose effect on the logits
# against the plain versions is printed beside MODEL_TOL
SCALE_CONTROL = 1.02
# (h2) the per-row path: the first n of (c)'s requests, this many tokens
PER_ROW_REQUESTS, PER_ROW_TOKENS = 4, 8
# (h4) qwen3-14b with group scales through the dequantize route
GROUP_SIZE, GROUP_REQUESTS, GROUP_TOKENS = 128, 4, 8
# (h5) activation bits of the lane-safety check at engine construction,
# and the largest integer float32 holds exactly
ACT_BITS, F32_EXACT = 8, 1 << 24
# (g) the async front door over (c)'s bf16-KV engine: open-loop rows of
# (load x capacity_rps, policy, requests), Poisson arrivals; the requests
# are the first n of FRONT_DOOR_N from workload(FRONT_DOOR_SEED, ...)
FRONT_DOOR_ROWS = ((0.5, "slo", 40), (2.5, "slo", 80), (2.5, "fifo", 80))
FRONT_DOOR_N, FRONT_DOOR_SEED, FRONT_DOOR_QUEUE = 80, 18, 64
# closed-loop bursts whose median is the capacity
CAPACITY_BURSTS = 3
# the burst through AsyncServer, the step inline (False) or in a thread
THREAD_AB_ORDER = (False, True, True, False)
# the SLO in units of 1 / capacity_rps (benchmarks/bench_openloop.py)
SLO_TOKEN_BUDGET = 30.0
# bound on one row's serving: a dead serve loop leaves every stream open
FRONT_DOOR_TIMEOUT_S = 240
# (i) zamba2-7b's depth in its run: its published 81 layers, no cut
ZAMBA2_LAYERS = 81
# (j) training full-width qwen1.5-0.5b: steps of SyntheticLM(seed 0) at
# batch x seq, AdamW at peak lr after a linear warm-up (stated as
# tests/test_system.py states its own): the reference's default --lr.
# From these seeded weights the 20-step loss falls at 1e-4 and 3e-4 and
# rises at 1e-3 and above (tools/train_runs.py --sweep; PERF.md)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 20, 8, 256
TRAIN_LR, TRAIN_WARMUP = 3e-4, 5
# (j2) the card against the CPU: the full-width model cut to this many
# layers, one step on batch x seq; the CPU tests' tolerances
# (tests/test_torch_train.py): loss 1e-4 and gradient norm 5e-3
# relative, every gradient leaf within 2^-4 of its largest |value|
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 64
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_GRAD_TOL = 1e-4, 5e-3, 2.0 ** -4
# (j4) the trained model served 4-bit: the first n of (c)'s requests
TRAIN_SERVE_REQUESTS = 8
# (j5) tests/test_system.py's config, trained this many steps on the card
SYSTEM_CONFIG = dict(n_layers=2, d_model=64, vocab=128, n_heads=4,
                     n_kv_heads=4, head_dim=16, d_ff=128)
SYSTEM_STEPS = 40
# (k) the 64-bit words: conv1_2's input activations as 64 channels x
# 224 * 224 positions for samd_conv_multichannel at these bits; 2^20 words
# (and 2^20 values) for the codegen ops, conv_by_scale and
# samd_conv_grouped; the first CPU_SLICE positions (or words) of each
# 64-bit result recomputed on the CPU; timed iterations of each case
WORDS64_CHANNELS, WORDS64_POSITIONS = 64, 224 * 224
WORDS64_BITS = (2, 3, 4)
WORDS64_N = 1 << 20
WORDS64_POINTWISE_BITS = (3, 4, 8)
CPU_SLICE = 4096
WORDS64_ITERS = 5
# (l) distribution on one card: (j1)'s model, batch and seq, two steps; the
# compressed all-reduce on 2^24 floats
DIST_STEPS = 2
PSUM_N = 1 << 24
# (m) the dry-run: cells traced on a fake process group of 256 or 512
# ranks with fake tensors on a cuda mesh, (tag, arch, shape, lower_cell
# keywords); (m5) lockstep serving on DTensors: (c)'s first max_batch
# prompts cut to LOCKSTEP_PROMPT tokens, then LOCKSTEP_STEPS decode steps
DRYRUN_CELLS = (
    ("m1", "qwen3-14b", "train_4k", dict(multi_pod=True, remat="block")),
    ("m2", "qwen3-14b", "decode_32k", dict(quant_bits=4, kv_bits=8)),
    ("m3", "olmoe-1b-7b", "prefill_32k", dict(quant_bits=4)),
    ("m4", "zamba2-7b", "long_500k", {}),
)
LOCKSTEP_PROMPT, LOCKSTEP_STEPS = 32, 8
DECODE_LINEARS = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                  ("attn", "wo"), ("mlp", "wg"), ("mlp", "wu"),
                  ("mlp", "wd")]


def log(*args):
    print(*args, flush=True)


class Timer:
    """Mean milliseconds per call of ``fn`` over ``iters`` calls, from CUDA
    events around the whole run (after warm-up calls)."""

    def __init__(self, device):
        self.device = device

    def __call__(self, fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(self.device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_ops, ops_per_s=BF16_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def max_err(got, want, tol):
    """Max |got - want|, raising if any element is outside
    atol + rtol * |want| with atol = tol * max|want|, rtol = tol."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = tol * want.abs().max() + tol * want.abs()
    if not torch.isfinite(got).all() or (err > limit).any():
        raise AssertionError(
            f"mismatch: max err {err.max().item():.4g}, "
            f"scale {want.abs().max().item():.4g}")
    return err.max().item()


def max_scaled_err(got, want, tol):
    """Max |got - want|, raising unless it is at most tol * max|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or err > tol * want.abs().max().item():
        raise AssertionError(
            f"mismatch: max err {err:.4g}, scale "
            f"{want.abs().max().item():.4g}, tolerance {tol}")
    return err


# -- (b) kernels against their plain versions --------------------------------

def check_samd_matmul(dev, gen):
    """Returns the max |kernel - plain| of each case group, keyed by
    (bits, spacer, signed, M), over the three weight shapes. M = 8 and 24
    (decode, run B's verify) and 32 run the split-K launcher, 33 and 1024
    the tile launcher; each case must launch exactly ``launcher_for(M)``
    and give bit-identical output on a second call."""
    from repro_torch.core import samd
    from repro_torch.kernels import samd_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.quant.config import QuantConfig
    from repro_torch.quant.packing import pack_weights, unpack_weights

    errs, n = {}, 0
    for bits in (2, 4, 8):
        for spacer in ("temporary", "permanent"):
            cfg = QuantConfig(bits=bits, spacer=spacer)
            for k, nn in MATMUL_SHAPES:
                w = torch.randn(k, nn, generator=gen, device=dev)
                for signed in (True, False):
                    if signed:
                        packed, scale = pack_weights(w, cfg)
                    else:
                        codes = torch.randint(0, 2 ** bits, (nn, k),
                                              generator=gen, device=dev)
                        fmt = samd.SAMDFormat(bits, cfg.lane_width, False)
                        packed = samd.pack(codes, fmt).t().contiguous()
                        scale = torch.rand(1, nn, generator=gen,
                                           device=dev) * 0.1
                    for m in MATMUL_CHECK_M:
                        x = torch.randn(m, k, generator=gen, device=dev)
                        x = x.to(torch.bfloat16)
                        before = ops.launch_counts()
                        got = ops.samd_matmul(x, packed, scale, k, cfg,
                                              signed=signed)
                        moved = {f for f, c in ops.launch_counts().items()
                                 if c != before[f]}
                        if moved != {mm.launcher_for(m)}:
                            raise AssertionError(f"M={m} launched {moved}")
                        again = ops.samd_matmul(x, packed, scale, k, cfg,
                                                signed=signed)
                        if not torch.equal(got, again):
                            raise AssertionError(
                                f"two calls differ at M={m} K={k} N={nn}")
                        want = mm.samd_matmul_plain(x, packed, scale, k,
                                                    cfg, signed=signed)
                        key = (bits, spacer, signed, m)
                        errs[key] = max(errs.get(key, 0.0),
                                        max_err(got, want, BF16_TOL))
                        n += 1
            # exact unpack through both launchers: one-hot rows and unit
            # scales read codes back
            k = 1024
            packed, _ = pack_weights(
                torch.randn(k, 64, generator=gen, device=dev), cfg)
            for m in (8, 1024):
                rows = torch.randperm(k, generator=gen, device=dev)[:m]
                x = torch.zeros(m, k, dtype=torch.bfloat16, device=dev)
                x[torch.arange(m, device=dev), rows] = 1
                got = ops.samd_matmul(x, packed, torch.ones(64, device=dev),
                                      k, cfg)
                codes = unpack_weights(packed, k, cfg)[rows]
                if not torch.equal(got.float(), codes.float()):
                    raise AssertionError(
                        f"codes not exact at {bits}/{spacer}, M={m}")
    log(f"  samd_matmul: {n} cases within tolerance, each launching "
        "launcher_for(M) and bit-identical on a second call, codes exact "
        f"through both launchers; max |kernel - plain| = "
        f"{max(errs.values()):.4g}; per M: " + json.dumps(
            {m: max(e for key, e in errs.items() if key[3] == m)
             for m in MATMUL_CHECK_M}))
    return errs


def rel_rms(got, want):
    """RMS of ``got - want`` over the RMS of ``want``."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def check_qwen3_shapes(dev, gen):
    """(b) at qwen3-14b's shapes: the 4-bit matmul at every linear's (K,
    N) and the LM head's, at decode (M = 8, split-K launcher) and a
    prefill (M = 1024, tile launcher), each launching ``launcher_for(M)``
    only, bit-identical on a second call, within BF16_TOL of its plain
    version element by element and within BF16_RMS_TOL as a whole; and
    decode attention at G = 5, dh = 128 (bf16 KV). Returns the max
    |kernel - plain| keyed by (K, N, M) and by "attention"."""
    from repro_torch.configs.archs import QWEN3_14B as cfg
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import samd_matmul as mm
    from repro_torch.quant.config import QuantConfig
    from repro_torch.quant.packing import pack_weights

    qcfg, errs, rms = QuantConfig(bits=4), {}, {}
    for k, n in QWEN3_MATMUL_SHAPES:
        packed, scale = pack_weights(
            torch.randn(k, n, generator=gen, device=dev) * 0.02, qcfg)
        for m in QWEN3_CHECK_M:
            x = torch.randn(m, k, generator=gen, device=dev).to(
                torch.bfloat16)
            before = ops.launch_counts()
            got = ops.samd_matmul(x, packed, scale, k, qcfg)
            moved = {f for f, c in ops.launch_counts().items()
                     if c != before[f]}
            if moved != {mm.launcher_for(m)}:
                raise AssertionError(f"K={k} N={n} M={m} launched {moved}")
            if not torch.equal(got, ops.samd_matmul(x, packed, scale, k,
                                                    qcfg)):
                raise AssertionError(f"two calls differ at K={k} N={n} M={m}")
            want = mm.samd_matmul_plain(x, packed, scale, k, qcfg)
            errs[k, n, m] = max_err(got, want, BF16_TOL)
            rms[k, n, m] = rel_rms(got, want)
            if rms[k, n, m] > BF16_RMS_TOL:
                raise AssertionError(
                    f"K={k} N={n} M={m}: relative RMS {rms[k, n, m]:.4g} "
                    f"> {BF16_RMS_TOL:.4g}")
            del x, got, want
        del packed, scale
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    args, kw = paged_case(dev, gen, 8, hkv, cfg.n_heads // hkv, dh, 16, 32,
                          False, [40, -1, 255, 16, 15, 300, 0, 490])
    got = ops.paged_decode_attention(*args, **kw)
    errs["attention"] = max_err(
        got, pa.paged_decode_attention_plain(*args, **kw), BF16_TOL)
    log("  qwen3-14b shapes: samd_matmul at M=8 (split-K) and M=1024 "
        "(tile), two calls bit-identical, and decode attention at G=5 "
        "dh=128; max |kernel - plain| = " + json.dumps(
            {str(key): e for key, e in errs.items()})
        + "; relative RMS of kernel - plain = " + json.dumps(
            {str(key): round(r, 7) for key, r in rms.items()}))
    return errs


def paged_case(dev, gen, b, hkv, g, dh, ps, n_pp, packed, lens):
    """q, pools and a page table: slot i owns ceil((lens[i]+1)/ps) distinct
    random pages followed by -1, at position lens[i]; lens[i] < 0 makes
    slot i empty (row all -1)."""
    n_pages = b * n_pp
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    pt = torch.full((b, n_pp), -1, dtype=torch.int32, device=dev)
    pos = torch.zeros(b, dtype=torch.int32, device=dev)
    for i, ln in enumerate(lens):
        if ln < 0:
            continue
        own = ln // ps + 1
        pt[i, :own] = perm[i * n_pp:i * n_pp + own]
        pos[i] = ln
    q = torch.randn(b, hkv * g, dh, generator=gen, device=dev)
    q = q.to(torch.bfloat16)
    shape = (n_pages, ps, hkv, dh)
    if packed:
        from repro_torch.quant.packing import pack_int8_lanes

        def pool():
            v = torch.randint(-127, 128, shape, generator=gen, device=dev)
            return pack_int8_lanes(v.to(torch.int8))

        def scale():
            return torch.rand(shape[:3], generator=gen, device=dev) * 0.02

        return (q, pool(), pool(), pt, pos), dict(k_scale=scale(),
                                                  v_scale=scale())
    kv = torch.randn((2,) + shape, generator=gen, device=dev)
    kv = kv.to(torch.bfloat16)
    return (q, kv[0], kv[1], pt, pos), {}


def check_paged_attention(dev, gen):
    """Returns the max |kernel - plain| of each case, keyed by (pool
    format, G)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    errs = {}
    for packed in (False, True):
        fmt = "int8" if packed else "bf16"
        for hkv, g in ((16, 1), (4, 4)):
            lens = [40, -1, 255, 16, 15, 300, 0, 511]  # slot 1 is empty
            args, kw = paged_case(dev, gen, 8, hkv, g, 64, 16, 32, packed,
                                  lens)
            got = ops.paged_decode_attention(*args, **kw)
            if not torch.equal(got, ops.paged_decode_attention(*args, **kw)):
                raise AssertionError("two decode calls differ")
            want = pa.paged_decode_attention_plain(*args, **kw)
            errs[fmt, g] = max_err(got, want, BF16_TOL)
            if not (got[1] == 0).all():
                raise AssertionError("an empty slot must emit zeros")
    log("  paged_decode_attention: empty slot exact zeros, two calls "
        "bit-identical; max |kernel - plain| per (KV, G) = " + json.dumps(
            {f"{f} G={g}": e for (f, g), e in errs.items()}))
    return errs


def ring_case(dev, gen, b, r, hkv, dh):
    """The draft's ring: slot i has its first i % (r + 1) entries written
    (slot 0 none, so it keeps its pool-only state), the rest at -1."""
    kv = torch.randn((2, b, r, hkv, dh), generator=gen, device=dev)
    epos = torch.full((b, r), -1, dtype=torch.int32, device=dev)
    for i in range(b):
        n = i % (r + 1)
        epos[i, :n] = torch.arange(n, dtype=torch.int32, device=dev) + 1000
    return dict(extra_k=kv[0].to(torch.bfloat16).contiguous(),
                extra_v=kv[1].to(torch.bfloat16).contiguous(), extra_pos=epos)


def verify_case(dev, gen, b, s, hkv, g, dh, ps, n_pp, packed, bases, specs):
    """q [B, S, H, dh], pools and a page table as the verify sees them:
    slot i sits at position bases[i] with draft budget specs[i], so its
    rows are bases[i]..bases[i] + specs[i] and -1 after, and it owns the
    pages covering that window, then -1; bases[i] < 0 makes slot i empty
    (table and rows all -1)."""
    lens = [bs + sp if bs >= 0 else -1 for bs, sp in zip(bases, specs)]
    (q, kp, vp, pt, _), kw = paged_case(dev, gen, b, hkv, g * s, dh, ps,
                                        n_pp, packed, lens)
    q = q.reshape(b, hkv, g, s, dh).permute(0, 3, 1, 2, 4).reshape(
        b, s, hkv * g, dh).contiguous()
    q_pos = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    for i, (bs, sp) in enumerate(zip(bases, specs)):
        if bs >= 0:
            q_pos[i, :sp + 1] = bs + torch.arange(sp + 1, dtype=torch.int32,
                                                  device=dev)
    return (q, kp, vp, pt, q_pos), kw


def check_verify_attention(dev, gen):
    """Holds the verify kernel against its plain version for each pool
    format at S in {2, 5} and at each speculative run's S = K + 1 (G = 1),
    and at S = 5 with G = 4; slots have ragged budgets (rows at -1), slot
    1 is empty and slot 3 has pages but every row at -1 (an inactive
    budget). Returns the max |kernel - plain| of each case, keyed by
    (pool format, S, G)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    bases = [40, -1, 250, 17, 15, 300, 0, 505]
    errs = {}
    for packed in (False, True):
        fmt = "int8" if packed else "bf16"
        sizes = sorted({2, 5} | {k + 1 for _, _, k in SPEC_RUNS})
        for s, hkv, g in [(s, 16, 1) for s in sizes] + [(5, 4, 4)]:
            specs = [min(i % s, s - 1) for i in range(8)]
            args, kw = verify_case(dev, gen, 8, s, hkv, g, 64, 16, 32,
                                   packed, bases, specs)
            args[4][3] = -1  # slot 3: pages, but no row in budget
            got = ops.paged_verify_attention(*args, **kw)
            if not torch.equal(got, ops.paged_verify_attention(*args, **kw)):
                raise AssertionError("two verify calls differ")
            want = pa.paged_verify_attention_plain(*args, **kw)
            errs[fmt, s, g] = max_err(got, want, BF16_TOL)
            dead = args[4] < 0
            if not ((got[dead] == 0).all() and (got[1] == 0).all()):
                raise AssertionError("rows at -1 must emit exact zeros")
            if not (got[~dead] != 0).any(dim=-1).all():
                raise AssertionError("a live row came out all zero")
    log("  paged_verify_attention: rows at -1 and the empty slot exact "
        "zeros, two calls bit-identical; max |kernel - plain| per (KV, S, "
        "G) = "
        + json.dumps({f"{f} S={s} G={g}": e for (f, s, g), e in
                      errs.items()}))
    return errs


def check_ring_fold(dev, gen):
    """Holds the decode kernel with the draft ring folded in against its
    plain version for each pool format at R = 4 and at each speculative
    run's R = K, G = 1 and 4, some ring entries at -1; slot 1 has no page
    (its ring alone), slot 0 no ring entry (pool only); with every ring
    entry at -1 the empty slot emits zeros. Returns the max |kernel -
    plain| of each case, keyed by (pool format, R, G)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    errs = {}
    for packed in (False, True):
        fmt = "int8" if packed else "bf16"
        for r in sorted({4} | {k for _, _, k in SPEC_RUNS}):
            for hkv, g in ((16, 1), (4, 4)):
                lens = [40, -1, 255, 16, 15, 300, 0, 511]
                args, kw = paged_case(dev, gen, 8, hkv, g, 64, 16, 32,
                                      packed, lens)
                ring = ring_case(dev, gen, 8, r, hkv, 64)
                got = ops.paged_decode_attention(*args, **kw, **ring)
                if not torch.equal(
                        got, ops.paged_decode_attention(*args, **kw, **ring)):
                    raise AssertionError("two ring-fold calls differ")
                want = pa.paged_decode_attention_plain(*args, **kw, **ring)
                errs[fmt, r, g] = max_err(got, want, BF16_TOL)
                pool_only = ops.paged_decode_attention(*args, **kw)
                if not torch.equal(got[0], pool_only[0]):
                    raise AssertionError("a slot with no ring entry must "
                                         "keep its pool-only result")
                none = dict(ring, extra_pos=torch.full_like(
                    ring["extra_pos"], -1))
                if not (ops.paged_decode_attention(*args, **kw, **none)[1]
                        == 0).all():
                    raise AssertionError("no page and no ring entry must "
                                         "emit zeros")
    log("  paged_decode_ring_attention: two calls bit-identical; max "
        "|kernel - plain| per (KV, R, G) = " + json.dumps(
            {f"{f} R={r} G={g}": e for (f, r, g), e in errs.items()}))
    return errs


# -- (c) and (e) serving -----------------------------------------------------

def workload(seed, n=N_REQUESTS, max_tokens=MAX_TOKENS, vocab=151936):
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab,
                                               size=int(rng.integers(32, 257))
                                               ).astype(np.int32),
                    max_tokens=max_tokens)
            for i in range(n)]


def time_speculative_steps(eng):
    """Wrap ``eng``'s draft and verify steps with CUDA events; returns a
    list that gets, per speculative tick, the events (start, after draft,
    after verify) and the number of active slots."""
    draft, verify = eng._draft_step, eng._verify_step
    marks = []

    def timed_draft(*args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        out = draft(*args)
        ev[1].record()
        marks.append((ev, int(eng.active.sum())))
        return out

    def timed_verify(*args):
        out = verify(*args)
        marks[-1][0][2].record()
        return out

    eng._draft_step, eng._verify_step = timed_draft, timed_verify
    return marks


def serve(label, dev, expect, seed=0, arch=None, n=N_REQUESTS,
          max_tokens=MAX_TOKENS, on_engine=None, params=None, **engine_kw):
    """Serve the first ``n`` requests of the workload (prompts drawn from
    the arch's vocabulary), ``max_tokens`` each, with
    ``ServingEngine(arch, params, **engine_kw)`` (default QWEN15_05B;
    weights drawn from ``seed`` when ``params`` is None); the
    launchers in ``expect`` must launch and no other. ``on_engine(eng)``
    runs after the engine is built, before it serves (instrumentation).
    Returns (engine, summary dict, launch counts)."""
    from repro_torch.configs.archs import QWEN15_05B
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine

    cfg = arch or QWEN15_05B
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(cfg, params, seed=seed, device=dev, **SERVE,
                        **engine_kw)
    torch.cuda.synchronize(dev)
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    marks = time_speculative_steps(eng) if eng.speculative else None
    if on_engine is not None:
        on_engine(eng)
    for r in workload(seed + 1, n, max_tokens, cfg.vocab):
        eng.submit(r)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    decode_ms, ticks = [], 0
    t0 = time.perf_counter()
    def prefill_count():
        return (eng.stats["prefill_calls"]
                + eng.stats["per_row_prefill_calls"])

    while eng.queue or any(s is not None for s in eng.slots):
        prefills = prefill_count()
        t = time.perf_counter()
        eng.step()  # ends in a host sync (the sampled ids)
        if prefill_count() == prefills:
            decode_ms.append((time.perf_counter() - t) * 1e3)
        ticks += 1
        if ticks > 2000:
            raise AssertionError("engine made no progress")
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    done = eng.finished
    if len(done) != n:
        raise AssertionError(f"{len(done)} of {n} finished")
    for r in done:
        if r.error or r.truncated or len(r.generated) != max_tokens:
            raise AssertionError(f"request {r.rid}: error={r.error} "
                                 f"truncated={r.truncated} "
                                 f"n={len(r.generated)}")
        if not all(0 <= t < cfg.vocab for t in r.generated):
            raise AssertionError(f"request {r.rid}: token out of range")
    for name, c in counts.items():
        if (c > 0) != (name in expect):
            raise AssertionError(f"{label}: launcher {name} ran {c} times; "
                                 f"expected {sorted(expect)} only")
    gen_tokens = sum(len(r.generated) for r in done)
    summary = dict(
        run=label, init_s=round(t_init, 3), serve_s=round(wall, 3),
        ticks=ticks, decode_ticks=len(decode_ms),
        decode_tick_ms_median=round(float(np.median(decode_ms)), 3),
        decode_tick_ms_mean=round(float(np.mean(decode_ms)), 3),
        tokens_per_s=round(gen_tokens / wall, 1),
        prefill_calls=prefill_count(),
        peak_mem_gib=round(torch.cuda.max_memory_allocated(dev) / 2**30, 2),
        init_peak_mem_gib=round(init_peak / 2**30, 2),
        kv_cache_gib=round(eng.kv_cache_bytes() / 2**30, 3),
        launches=counts)
    if marks:
        split = [(a.elapsed_time(b), b.elapsed_time(c))
                 for (a, b, c), _ in marks]
        slot_ticks = sum(n for _, n in marks)
        st = eng.stats
        summary.update(
            spec_ticks=st["spec_ticks"],
            accept_rate=round(st["draft_accepted"]
                              / max(1, st["draft_proposed"]), 4),
            draft_proposed=st["draft_proposed"],
            draft_accepted=st["draft_accepted"],
            # every token but each request's first (its prefill's) comes
            # from a speculative tick
            tokens_per_slot_tick=round(
                (gen_tokens - n) / max(1, slot_ticks), 3),
            draft_ms_median=round(float(np.median([d for d, _ in split])),
                                  3),
            verify_ms_median=round(float(np.median([v for _, v in split])),
                                   3),
            draft_ms_mean=round(float(np.mean([d for d, _ in split])), 3),
            verify_ms_mean=round(float(np.mean([v for _, v in split])), 3))
    log(f"  serve ({label}): " + json.dumps(summary))
    return eng, summary, counts


def check_greedy(eng, plain, dev, reqs=None, against="plain decode",
                 tol=MODEL_TOL):
    """The tokens of ``reqs`` (default: ``eng``'s finished requests)
    against plain greedy decode's (``plain``, finished requests of the
    same workload and target weights): identical, or parting at a token
    where a full forward of the prefix on the card gives a top-1/top-2
    margin under ``tol`` (MODEL_TOL unless the model's measured rounding
    sensitivity is larger) of the largest logit, or, for MoE, where the
    routed experts differ only at near-tied router probabilities.
    Returns the count of identical requests."""
    from repro_torch.models.model import forward

    want = {r.rid: (r.prompt, r.generated) for r in plain}
    reqs = eng.finished if reqs is None else reqs
    identical, margins = 0, []
    for r in reqs:
        prompt, ref = want[r.rid]
        j = next((i for i, (a, b) in enumerate(zip(ref, r.generated))
                  if a != b), None)
        if j is None:
            identical += 1
            continue
        toks = np.concatenate([prompt, np.asarray(ref[:j], np.int32)])
        lg = forward(eng.params, torch.from_numpy(toks[None]).long().to(dev),
                     eng.cfg)[0, -1].float()
        top2 = torch.topk(lg, 2).values
        margin = (top2[0] - top2[1]).item()
        limit = tol * lg.abs().max().item()
        if margin > limit and eng.cfg.family == "moe":
            router = router_near_tie(eng, toks, dev)
            if router is not None:
                margins.append(f"router {router:.5f}")
                continue
        if margin > limit:
            raise AssertionError(
                f"request {r.rid} parts from {against} at token {j} "
                f"with a top-1/top-2 margin {margin:.4g} > {limit:.4g}")
        margins.append(round(margin / lg.abs().max().item(), 5))
    log(f"  greedy vs {against}: {identical} of {len(reqs)} requests "
        f"token-identical; the others part at near-ties (margin / max "
        f"logit, or of a routed token's k-th and (k+1)-th expert "
        f"probability over its largest: {margins})")
    return identical


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper runs its plain PyTorch version on the card's
    tensors (the branch a CPU tensor takes), and no kernel launches."""
    from repro_torch.kernels import ops

    before, on_cuda = ops.launch_counts(), ops._on_cuda
    ops._on_cuda = lambda t: False
    try:
        yield
    finally:
        ops._on_cuda = on_cuda
    if ops.launch_counts() != before:
        raise AssertionError("a kernel launched inside plain_versions()")


def check_model_against_plain(eng, dev, plain_on_card=False,
                              controls=()):
    """Logits of a 24-token prefill (gather attention) and a fused decode
    token, through the kernels on the card and through the plain versions
    on the CPU (``plain_on_card``: on the card, for a model whose plain
    run would take minutes on the host's cores), for the engine's own
    weights and KV format, within MODEL_TOL. ``controls`` holds (name,
    context) pairs: under each ``context()`` the kernels' side runs once
    more, and its max |err| over the scale is printed and returned, not
    checked. Returns (max err prefill, max err decode, scale, {name:
    (prefill, decode) err / scale})."""
    from repro_torch.models.layers import QuantizedTensor
    from repro_torch.models.model import forward, init_paged_cache

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        if isinstance(tree, QuantizedTensor):
            return QuantizedTensor(tree.packed.cpu(), tree.scale.cpu(),
                                   tree.orig_shape, tree.axis, tree.cfg)
        return tree.cpu()

    cfg, ps = eng.cfg, eng.page_size
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, size=(2, 24))
    pos = np.where(np.arange(24)[None] < np.array([[24], [19]]),
                   np.arange(24)[None], -1)
    pt = np.array([[3, 1], [0, 2]], np.int32)
    dec = rng.integers(0, cfg.vocab, size=(2, 1))
    dpos = np.array([[24], [19]])

    def logits(device, params, context):
        cache = init_paged_cache(cfg, 4, ps, kv_bits=eng._kv_bits,
                                 device=device)
        t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in dict(toks=toks, pos=pos, pt=pt, dec=dec,
                              dpos=dpos).items()}
        with context():
            pre = forward(params, t["toks"], cfg, positions=t["pos"],
                          cache=cache, page_table=t["pt"], page_size=ps)
            nxt = forward(params, t["dec"], cfg, positions=t["dpos"],
                          cache=cache, page_table=t["pt"], page_size=ps,
                          paged_attn="fused")
        return pre[t["pos"] >= 0].float().cpu(), nxt.float().cpu()

    got = logits(dev, eng.params, contextlib.nullcontext)
    want = (logits(dev, eng.params, plain_versions) if plain_on_card
            else logits("cpu", to_cpu(eng.params), contextlib.nullcontext))
    errs = [max_err(a, b, MODEL_TOL) for a, b in zip(got, want)]
    for a in got:
        if a.shape[-1] != cfg.vocab:
            raise AssertionError(f"logits shape {tuple(a.shape)}")
    scale = want[0].abs().max().item()
    seen = {}
    for name, context in controls:
        seen[name] = tuple(
            round((a - b).abs().max().item() / b.abs().max().item(), 5)
            for a, b in zip(logits(dev, eng.params, context), want))
    where = "the card" if plain_on_card else "the CPU"
    log(f"  full-width logits ({cfg.name}, {cfg.n_layers} layers), kernels "
        f"on the card vs plain on {where}: max err prefill {errs[0]:.4g}, "
        f"decode {errs[1]:.4g} (scale {scale:.4g}; "
        f"{errs[0] / scale:.4g} / {errs[1] / scale:.4g} of it, limit "
        f"{MODEL_TOL})")
    if seen:
        log("  the same with the kernels' scales changed (max err / scale, "
            "prefill and decode; not checked): " + json.dumps(seen))
    return errs[0], errs[1], scale, seen


@contextlib.contextmanager
def scaled(weights, factor):
    """The packed ``weights``' scales times ``factor``, restored after."""
    saved = [w.scale.clone() for w in weights]
    for w in weights:
        w.scale.mul_(factor)
    try:
        yield
    finally:
        for w, s in zip(weights, saved):
            w.scale.copy_(s)


def scale_controls(params):
    """(name, context) controls for ``check_model_against_plain``: one
    linear of the middle layer (wd), every linear of the blocks, and the
    LM head, with scales times SCALE_CONTROL."""
    from repro_torch.models.layers import QuantizedTensor

    blocks = params["blocks"]
    linears = [w for blk in blocks for part in blk.values()
               for w in part.values() if isinstance(w, QuantizedTensor)]
    mid = blocks[len(blocks) // 2]["mlp"]["wd"]
    f = SCALE_CONTROL
    return ((f"wd of layer {len(blocks) // 2} x{f}",
             functools.partial(scaled, [mid], f)),
            (f"every block linear x{f}",
             functools.partial(scaled, linears, f)),
            (f"LM head x{f}",
             functools.partial(scaled, [params["lm_head"]], f)))


# -- (d) timing at decode shapes ---------------------------------------------

def graph_ms(fn, reps=20):
    """Device milliseconds of one call of ``fn``: captured once into a
    CUDA graph and replayed ``reps`` times back to back under CUDA events,
    so no host dispatch (wrapper, Python) sits between its launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture stream, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def old_launcher(source, symbol, argtypes):
    """``symbol`` of a previous kernel source (e.g. from a git archive of
    the parent commit), built with the port's nvcc flags and bound
    through ctypes with ``argtypes`` -> int."""
    import ctypes
    import hashlib

    from repro_torch.kernels import _build

    src = Path(source).resolve()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"libold_{src.stem}-{digest}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True,
                       text=True, timeout=600)
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _args(n_ptrs, n_ints, tail=()):
    """ctypes argument types: pointers, ints, ``tail``, then the stream."""
    import ctypes

    return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
            + list(tail) + [ctypes.c_void_p])


class OldMatmul:
    """The previous ``samd_matmul`` kernel (a ``samd_matmul.cu`` with one
    ``samd_matmul_launch(x, packed, scale, out, M, N, K, bits,
    lane_width, vpw, signed, stream)``), for a comparison on one card."""

    def __init__(self, source):
        self.fn = old_launcher(source, "samd_matmul_launch", _args(4, 7))

    def __call__(self, x, packed, scale, k, cfg):
        from repro_torch.kernels._build import ptr, stream_handle

        m, n = x.shape[0], packed.shape[1]
        out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
        err = self.fn(ptr(x), ptr(packed), ptr(scale), ptr(out), m, n, k,
                      cfg.bits, cfg.lane_width, cfg.values_per_word, 1,
                      stream_handle(x))
        if err:
            raise RuntimeError(f"old samd_matmul launch failed ({err})")
        return out


class OldAttention:
    """A previous ``paged_attention.cu`` whose three launchers take no
    split arguments (``paged_decode_attention_launch(q, k_pages, v_pages,
    k_scale, v_scale, page_table, q_pos, out, B, n_pp, ps, hkv, g, dh,
    sm_scale, packed, stream)``, the ring launcher with extra_k, extra_v,
    extra_pos before ``out`` and R after ``dh``, the verify launcher with
    S after ``dh``), for a comparison on one card."""

    def __init__(self, source):
        import ctypes

        f = [ctypes.c_float, ctypes.c_int]
        self.fns = {DECODE: old_launcher(source, DECODE, _args(8, 6, f)),
                    RING: old_launcher(source, RING, _args(11, 7, f)),
                    VERIFY: old_launcher(source, VERIFY, _args(8, 7, f))}

    def _run(self, fn, q, out, args, packed):
        from repro_torch.kernels._build import stream_handle

        err = self.fns[fn](*args, 1.0 / (q.shape[-1] ** 0.5), int(packed),
                           stream_handle(q))
        if err:
            raise RuntimeError(f"old {fn} launch failed ({err})")
        return out

    def decode(self, q, kp, vp, pt, pos, k_scale=None, v_scale=None,
               extra_k=None, extra_v=None, extra_pos=None):
        from repro_torch.kernels._build import ptr

        b, h, dh = q.shape
        hkv, ps = kp.shape[2], kp.shape[1]
        out = torch.empty_like(q)
        head = [ptr(q), ptr(kp), ptr(vp), ptr(k_scale), ptr(v_scale),
                ptr(pt), ptr(pos)]
        dims = [b, pt.shape[1], ps, hkv, h // hkv, dh]
        if extra_k is None:
            return self._run(DECODE, q, out, head + [ptr(out)] + dims,
                             k_scale is not None)
        ring = [ptr(extra_k), ptr(extra_v), ptr(extra_pos), ptr(out)]
        return self._run(RING, q, out,
                         head + ring + dims + [extra_k.shape[1]],
                         k_scale is not None)

    def verify(self, q, kp, vp, pt, q_pos, k_scale=None, v_scale=None):
        from repro_torch.kernels._build import ptr

        b, sq, h, dh = q.shape
        hkv, ps = kp.shape[2], kp.shape[1]
        out = torch.empty_like(q)
        args = [ptr(q), ptr(kp), ptr(vp), ptr(k_scale), ptr(v_scale),
                ptr(pt), ptr(q_pos), ptr(out), b, pt.shape[1], ps, hkv,
                h // hkv, dh, sq]
        return self._run(VERIFY, q, out, args, k_scale is not None)


def time_samd_matmul(dev, timer, params, label, m, old=None, linears=None):
    """Per-launch times at M = ``m`` rows over the layers' weights
    (``params``, packed) of each linear, so the weights come from HBM as
    in a tick; ``linears`` [(name, [weights])] replaces DECODE_LINEARS
    over ``params["blocks"]`` (the other families: one entry a distinct
    (K, N)). Device time (the 24 launches in a CUDA graph, replayed) of
    the kernel, of the previous kernel when ``old`` is given (in turns
    old, new, new, old) and of dense bf16 ``torch.matmul`` (the
    yardstick); host-paced time (the Timer, which also pays each call's
    host dispatch) of the kernel and the yardstick; the plain version;
    and the wrapper's host time per call (1000 calls, no sync). Returns
    the means over the linears."""
    from repro_torch.kernels import samd_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.quant.packing import dequant_weights

    keys = ("ms", "old_ms", "library_ms", "host_paced_ms",
            "library_host_paced_ms", "plain_ms", "bound_ms", "bytes", "ops")
    tot = dict.fromkeys(keys, 0.0)
    rows = []
    if linears is None:
        linears = [(name, [blk[part][name] for blk in params["blocks"]])
                   for part, name in DECODE_LINEARS]
    for name, ws in linears:
        k, nn = ws[0].orig_shape
        cfg = ws[0].cfg
        x = torch.randn(m, k, device=dev).to(torch.bfloat16)
        dense = [dequant_weights(w.packed, w.scale, k, cfg) for w in ws]
        nl = len(ws)

        def run(fn):
            return lambda: [fn(w) for w in ws]

        new = run(lambda w: ops.samd_matmul(x, w.packed, w.scale, k, cfg))
        t = dict(ms=[], old_ms=[])
        if old is not None:
            w0 = ws[0]
            max_err(old(x, w0.packed, w0.scale, k, cfg),
                    mm.samd_matmul_plain(x, w0.packed, w0.scale, k, cfg),
                    BF16_TOL)
            prev = run(lambda w: old(x, w.packed, w.scale, k, cfg))
            for who, fn in (("old_ms", prev), ("ms", new), ("ms", new),
                            ("old_ms", prev)):
                t[who].append(graph_ms(fn) / nl)
        else:
            t["ms"].append(graph_ms(new) / nl)

        def lib():
            return [torch.matmul(x, d) for d in dense]

        row = dict(
            linear=name, m=m, k=k, n=nn, launcher=mm.launcher_for(m),
            splits=mm.split_k(m, nn, k, cfg.values_per_word)[0],
            ms=float(np.mean(t["ms"])),
            old_ms=float(np.mean(t["old_ms"])) if t["old_ms"] else 0.0,
            library_ms=graph_ms(lib) / nl,
            host_paced_ms=timer(new) / nl,
            library_host_paced_ms=timer(lib) / nl,
            plain_ms=timer(run(lambda w: mm.samd_matmul_plain(
                x, w.packed, w.scale, k, cfg)), iters=3) / nl)
        row["bytes"] = (x.numel() * 2 + ws[0].packed.numel() * 4
                        + ws[0].scale.numel() * 4 + m * nn * 2)
        row["ops"] = 2 * m * k * nn
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["ops"])
        row["tflops"] = row["ops"] / row["ms"] / 1e9
        if name == linears[0][0]:
            w0 = ws[0]
            row["host_us_per_call"] = host_us_per_call(
                lambda: ops.samd_matmul(x, w0.packed, w0.scale, k, cfg))
        rows.append(row)
        for key in keys:
            tot[key] += row[key]
        del dense
    for r in rows:
        log(f"  samd_matmul ({label}) " + json.dumps(
            {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in r.items()}))
    n = len(rows)
    out = {k: v / n for k, v in tot.items()}
    out["bound_by"] = bound_ms(out["bytes"], out["ops"])[1]
    out["host_us_per_call"] = rows[0]["host_us_per_call"]
    if old is None:
        del out["old_ms"]
    log(f"  samd_matmul ({label}) mean of the {n} linears: " + json.dumps(
        {k: (round(v, 6) if isinstance(v, float) else v)
         for k, v in out.items()}))
    return out


def fill_pools(eng, args, kw):
    """Copy a case's random pools into every layer's pools of ``eng``, so
    a timing reads realistic values from HBM, layer after layer."""
    for lay in eng.cache["layers"]:
        for key, t in zip(("k", "v"), args[1:3]):
            lay[key][: t.shape[0]].copy_(t)
        for key, t in kw.items():
            lay[key][: t.shape[0]].copy_(t)


def page_mask(pt, ps, q_pos):
    """[B, Sq, n_pp * ps]: key offset <= the query's position, on an
    allocated page (q_pos [B, Sq])."""
    offs = torch.arange(pt.shape[1] * ps, device=pt.device)
    return ((offs[None, None] <= q_pos[..., None].long())
            & torch.repeat_interleave(pt >= 0, ps, dim=1)[:, None])


def kv_bytes_per_token(cfg, packed):
    per_tok = cfg.n_kv_heads * cfg.head_dim
    return 2 * (per_tok + 4 * cfg.n_kv_heads if packed else 2 * per_tok)


def timing_row(label, kern, plain, lib, n_bytes, n_ops,
               ops_per_s=BF16_OPS_PER_S, **extra):
    b_ms, by = bound_ms(n_bytes, n_ops, ops_per_s)
    row = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
               bound_by=by, bytes=n_bytes, ops=n_ops, **extra)
    log(f"  {label} " + json.dumps(
        {k: (round(v, 5) if isinstance(v, float) else v)
         for k, v in row.items()}))
    return row


def mid_positions(n):
    """The workload's first ``n`` requests halfway through their
    generation: the positions a decode tick sees mid-run."""
    return [int(len(r.prompt)) + MAX_TOKENS // 2 for r in workload(1)[:n]]


def attention_times(dev, timer, nl, kern, plain, lib, old=None,
                    check=None, host_call=None):
    """Per-launch times of an attention launcher over ``nl`` layers:
    ``kern``, ``plain``, ``lib`` (SDPA) and ``old`` (a previous kernel)
    each run the ``nl`` layers' calls once. Device time (the layers'
    launches captured in a CUDA graph and replayed) of the kernel, of
    ``old`` in turns (old, new, new, old) after ``check()`` has held it
    to the plain version, and of the yardstick; host-paced times (the
    Timer, which also pays each call's host dispatch) of the kernel and
    the yardstick; the plain version; and, with ``host_call``, the
    wrapper's host time per call (``host_us_per_call``), plain and inside
    a ``torch.cuda.device`` context as the wrapper entered one on every
    call before."""
    t = dict(ms=[], old_ms=[])
    if old is not None:
        check()
        for who, fn in (("old_ms", old), ("ms", kern), ("ms", kern),
                        ("old_ms", old)):
            t[who].append(graph_ms(fn) / nl)
    else:
        t["ms"].append(graph_ms(kern) / nl)
    out = dict(ms=float(np.mean(t["ms"])), library_ms=graph_ms(lib) / nl,
               host_paced_ms=timer(kern) / nl,
               library_host_paced_ms=timer(lib) / nl,
               plain_ms=timer(plain, iters=3) / nl)
    if old is not None:
        out["old_ms"] = float(np.mean(t["old_ms"]))
    if host_call is not None:
        def in_device_ctx():
            with torch.cuda.device(dev):
                host_call()
        out["host_us_per_call"] = host_us_per_call(host_call)
        out["host_us_per_call_device_ctx"] = host_us_per_call(in_device_ctx)
    return out


def sdpa_layers(q, dense, mask, g):
    """SDPA of ``q`` [B, H, Sq, dh] over each layer's dense K/V
    [B, Hkv, L, dh]: the library yardstick, one call a layer."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: [sdpa(q, kk, vv, attn_mask=mask, enable_gqa=g > 1)
                    for kk, vv in dense]


def time_paged_attention(eng, dev, timer, packed, gen, old=None):
    """Decode attention of 8 slots at the workload's mid-run positions over
    every layer's pools (page table width 32, as the engine's pow2 table
    takes it for positions up to 288 + 32)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    cfg, ps = eng.cfg, eng.page_size
    b, n_pp = eng.max_batch, 32
    args, kw = paged_case(dev, gen, b, cfg.n_kv_heads, 1, cfg.head_dim, ps,
                          n_pp, packed, mid_positions(b))
    q, _, _, pt, pos = args
    layers = engine_pools(eng)(args, kw)

    def attn(fn):
        return lambda: [fn(q, k, v, pt, pos, **sc) for k, v, sc in layers]

    # library yardstick: SDPA over a dense KV gathered beforehand
    dense = dense_layers(layers, pt, cfg.n_kv_heads, cfg.head_dim)
    k0, v0, scales = layers[0]
    first = (q, k0, v0, pt, pos)
    t = attention_times(
        dev, timer, len(layers), attn(ops.paged_decode_attention),
        attn(pa.paged_decode_attention_plain),
        sdpa_layers(q[:, :, None], dense, page_mask(pt, ps, pos[:, None])
                    [:, None], 1),
        old and attn(old.decode),
        lambda: max_err(old.decode(*first, **scales),
                        pa.paged_decode_attention_plain(*first, **scales),
                        BF16_TOL),
        lambda: ops.paged_decode_attention(*first, **scales))
    del dense
    tokens = int((pos + 1).sum().item())  # keys the slots' queries read
    n_bytes = (tokens * kv_bytes_per_token(cfg, packed) + 2 * q.numel() * 2
               + pt.numel() * 4 + pos.numel() * 4)
    n_ops = 4 * tokens * cfg.n_heads * cfg.head_dim
    plan = pa.attention_plan(b, cfg.n_kv_heads, 1, cfg.head_dim, n_pp, ps,
                             1, 0, packed)
    return timing_row(
        f"paged_decode_attention ({'int8' if packed else 'bf16'} KV)",
        t.pop("ms"), t.pop("plain_ms"), t.pop("library_ms"), n_bytes, n_ops,
        keys=tokens, splits=plan.splits, **t)


def time_ring_fold(eng, dev, timer, gen, label, old=None):
    """The draft's attention at the workload's mid-run positions over
    every layer of ``eng``'s pools: the pool read to ``pos - 1`` and
    the full ring of K entries (the draft's last step) folded in."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    cfg, ps, r = eng.cfg, eng.page_size, eng.speculative
    b, n_pp = eng.max_batch, 32
    packed = eng._kv_bits == 8
    pos = mid_positions(b)
    args, kw = paged_case(dev, gen, b, cfg.n_kv_heads, 1, cfg.head_dim, ps,
                          n_pp, packed, [p - 1 for p in pos])
    q, _, _, pt, bound = args
    layers = engine_pools(eng)(args, kw)
    kv = torch.randn((2, b, r, cfg.n_kv_heads, cfg.head_dim), generator=gen,
                     device=dev).to(torch.bfloat16)
    ring = dict(extra_k=kv[0].contiguous(), extra_v=kv[1].contiguous(),
                extra_pos=(torch.tensor(pos, device=dev)[:, None]
                           + torch.arange(r, device=dev)).int())

    def attn(fn):
        return lambda: [fn(q, k, v, pt, bound, **sc, **ring)
                        for k, v, sc in layers]

    # library yardstick: SDPA over the gathered pool and the ring, dense
    dense = [tuple(torch.cat([t, e.transpose(1, 2)], dim=2)
                   for t, e in zip(kv_l, (ring["extra_k"], ring["extra_v"])))
             for kv_l in dense_layers(layers, pt, cfg.n_kv_heads,
                                      cfg.head_dim)]
    mask = torch.cat([page_mask(pt, ps, bound[:, None]),
                      torch.ones((b, 1, r), dtype=torch.bool, device=dev)],
                     dim=2)[:, None]
    k0, v0, sc0 = layers[0]
    first = (q, k0, v0, pt, bound)
    extra = dict(sc0, **ring)
    t = attention_times(
        dev, timer, len(layers), attn(ops.paged_decode_attention),
        attn(pa.paged_decode_attention_plain),
        sdpa_layers(q[:, :, None], dense, mask, 1),
        old and attn(old.decode),
        lambda: max_err(old.decode(*first, **extra),
                        pa.paged_decode_attention_plain(*first, **extra),
                        BF16_TOL),
        lambda: ops.paged_decode_attention(*first, **extra))
    del dense
    keys = int((bound + 1).sum().item())
    n_bytes = (keys * kv_bytes_per_token(cfg, packed)
               + ring["extra_k"].numel() * 4 + ring["extra_pos"].numel() * 4
               + 2 * q.numel() * 2 + pt.numel() * 4 + bound.numel() * 4)
    n_ops = 4 * (keys + b * r) * cfg.n_heads * cfg.head_dim
    plan = pa.attention_plan(b, cfg.n_kv_heads, 1, cfg.head_dim, n_pp, ps,
                             1, r, packed)
    return timing_row(f"paged_decode_ring_attention ({label})", t.pop("ms"),
                      t.pop("plain_ms"), t.pop("library_ms"), n_bytes, n_ops,
                      keys=keys + b * r, splits=plan.splits, **t)


def time_verify_at(dev, timer, gen, label, fill, b, s, hkv, g, dh, ps,
                   packed, old=None, host=True):
    """The verify's attention of ``b`` slots at the workload's mid-run
    positions, S = ``s`` queries each at full draft budget, over the
    layers' pools that ``fill(args, kw)`` returns as (k, v, scales)
    filled from the case (page table width 32)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    n_pp = 32
    args, kw = verify_case(dev, gen, b, s, hkv, g, dh, ps, n_pp, packed,
                           mid_positions(b), [s - 1] * b)
    q, _, _, pt, q_pos = args
    layers = fill(args, kw)

    def attn(fn):
        return lambda: [fn(q, k, v, pt, q_pos, **sc) for k, v, sc in layers]

    dense = dense_layers(layers, pt, hkv, dh)
    k0, v0, sc0 = layers[0]
    first = (q, k0, v0, pt, q_pos)
    t = attention_times(
        dev, timer, len(layers), attn(ops.paged_verify_attention),
        attn(pa.paged_verify_attention_plain),
        sdpa_layers(q.transpose(1, 2), dense,
                    page_mask(pt, ps, q_pos)[:, None], g),
        old and attn(old.verify),
        lambda: max_err(old.verify(*first, **sc0),
                        pa.paged_verify_attention_plain(*first, **sc0),
                        BF16_TOL),
        (lambda: ops.paged_verify_attention(*first, **sc0)) if host else None)
    del dense
    keys = int((q_pos.amax(dim=1) + 1).sum().item())  # pages read per slot
    per_tok = hkv * dh
    kv_bytes = 2 * (per_tok + 4 * hkv if packed else 2 * per_tok)
    n_bytes = (keys * kv_bytes + 2 * q.numel() * 2 + pt.numel() * 4
               + q_pos.numel() * 4)
    n_ops = 4 * s * keys * hkv * g * dh
    plan = pa.attention_plan(b, hkv, s * g, dh, n_pp, ps, s, 0, packed)
    return timing_row(f"paged_verify_attention ({label})", t.pop("ms"),
                      t.pop("plain_ms"), t.pop("library_ms"), n_bytes, n_ops,
                      keys=keys, s=s, splits=plan.splits, **t)


def engine_pools(eng):
    """The layers' pools of ``eng`` as (k, v, scales), filled with a
    case's values."""
    def fill(args, kw):
        fill_pools(eng, args, kw)
        return [(lay["k"], lay["v"],
                 {n: lay[n] for n in ("k_scale", "v_scale") if n in lay})
                for lay in eng.cache["layers"]]
    return fill


def seeded_pools(n_layers, dev, gen):
    """``n_layers`` pools of their own, each with the case's table shape
    and fresh seeded values (a kernel-only row: no engine)."""
    def fill(args, kw):
        from repro_torch.quant.packing import pack_int8_lanes

        kp = args[1]
        out = []
        for _ in range(n_layers):
            if kw:
                vals = torch.randint(-127, 128, (2,) + tuple(kp.shape[:3])
                                     + (kp.shape[3] * 4,), generator=gen,
                                     device=dev).to(torch.int8)
                sc = {n: torch.rand(kp.shape[:3], generator=gen, device=dev)
                      * 0.02 for n in ("k_scale", "v_scale")}
                out.append((pack_int8_lanes(vals[0]), pack_int8_lanes(vals[1]),
                            sc))
            else:
                kv = torch.randn((2,) + tuple(kp.shape), generator=gen,
                                 device=dev).to(torch.bfloat16)
                out.append((kv[0], kv[1], {}))
        return out
    return fill


def dense_layers(layers, pt, hkv, dh):
    """Per layer, the pages of ``pt`` gathered beforehand into dense bf16
    K and V [B, Hkv, n_pp * ps, dh]: the library yardstick's input."""
    from repro_torch.quant.packing import unpack_int8_lanes

    b, n_pp = pt.shape
    safe = pt.clamp(min=0).long()
    dense = []
    for k, v, sc in layers:
        kk, vv = k[safe], v[safe]
        if sc:
            kk = unpack_int8_lanes(kk) * sc["k_scale"][safe][..., None]
            vv = unpack_int8_lanes(vv) * sc["v_scale"][safe][..., None]
        ps = k.shape[1]
        dense.append(tuple(
            t.reshape(b, n_pp * ps, hkv, dh).transpose(1, 2)
            .to(torch.bfloat16).contiguous() for t in (kk, vv)))
    return dense


def time_verify(eng, dev, timer, gen, label, old=None):
    """The verify's attention at run ``label``'s shapes over every layer
    of ``eng``'s pools."""
    cfg = eng.cfg
    return time_verify_at(dev, timer, gen, label, engine_pools(eng),
                          eng.max_batch, eng.speculative + 1,
                          cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                          cfg.head_dim, eng.page_size, eng._kv_bits == 8,
                          old)


def time_qwen3_attention(dev, timer, gen, old=None):
    """Kernel-only rows at qwen3-14b's attention shape (Hkv = 8, G = 5,
    dh = 128, bf16 KV, 40 layers of seeded pools; not a serving run):
    decode of 8 slots at the workload's mid-run positions, and the
    verify at S = 3 at the same positions."""
    from repro_torch.configs.archs import QWEN3_14B as cfg
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    hkv, dh, ps, b, n_pp = cfg.n_kv_heads, cfg.head_dim, 16, 8, 32
    g = cfg.n_heads // hkv
    args, kw = paged_case(dev, gen, b, hkv, g, dh, ps, n_pp, False,
                          mid_positions(b))
    q, _, _, pt, pos = args
    layers = seeded_pools(cfg.n_layers, dev, gen)(args, kw)

    def attn(fn):
        return lambda: [fn(q, k, v, pt, pos) for k, v, _ in layers]

    dense = dense_layers(layers, pt, hkv, dh)
    first = (q, layers[0][0], layers[0][1], pt, pos)
    t = attention_times(
        dev, timer, len(layers), attn(ops.paged_decode_attention),
        attn(pa.paged_decode_attention_plain),
        sdpa_layers(q[:, :, None], dense, page_mask(pt, ps, pos[:, None])
                    [:, None], g),
        old and attn(old.decode),
        lambda: max_err(old.decode(*first),
                        pa.paged_decode_attention_plain(*first), BF16_TOL))
    del dense, layers
    tokens = int((pos + 1).sum().item())
    n_bytes = (tokens * 2 * 2 * hkv * dh + 2 * q.numel() * 2
               + pt.numel() * 4 + pos.numel() * 4)
    rows = [timing_row(
        "paged_decode_attention (qwen3-14b shape, bf16 KV, kernel only)",
        t.pop("ms"), t.pop("plain_ms"), t.pop("library_ms"), n_bytes,
        4 * tokens * hkv * g * dh, keys=tokens,
        splits=pa.attention_plan(b, hkv, g, dh, n_pp, ps, 1, 0,
                                 False).splits, **t)]
    rows.append(time_verify_at(
        dev, timer, gen, "qwen3-14b shape, bf16 KV, S=3, kernel only",
        seeded_pools(cfg.n_layers, dev, gen), b, 3, hkv, g, dh, ps, False,
        old, host=False))
    return rows


# -- (f) the VGG-B convolutions ----------------------------------------------

def vggb_cases():
    """(layer, C_in, C_out, H, W, bits, dtype) of (f)'s samd_conv2d runs."""
    from repro_torch.configs.vggb import VGGB_LAYERS

    cases = [(*layer, bits, torch.float32) for layer in VGGB_LAYERS
             for bits in CONV_BITS]
    name, bits = CONV_BF16_CASE
    layer = next(lay for lay in VGGB_LAYERS if lay[0] == name)
    return cases + [(*layer, bits, torch.bfloat16)]


def vggb_inputs(dev, gen, c_in, c_out, h, w, bits, dtype):
    from repro_torch.quant.config import QuantConfig
    from repro_torch.quant.packing import pack_conv_weights

    cfg = QuantConfig(bits=bits)
    x = torch.randn(c_in, h, w, generator=gen, device=dev).to(dtype)
    packed, scale = pack_conv_weights(
        torch.randn(3, 3, c_in, c_out, generator=gen, device=dev), cfg)
    return x, packed, scale, cfg


def library_conv2d(x, packed, scale, cfg):
    """F.conv2d of x with the dequantized weight (the yardstick), its
    output as [OH, OW, C_out]; returns (callable, output)."""
    from repro_torch.quant.packing import dequant_conv_weights

    wt = dequant_conv_weights(packed, scale, x.shape[0], cfg, x.dtype)
    wt = wt.permute(3, 2, 0, 1).contiguous()
    x4 = x[None]

    def fn():
        return torch.nn.functional.conv2d(x4, wt, padding=1)

    return fn, fn()[0].permute(1, 2, 0)


def conv1d_signal(dev, gen, bits, signed, dtype):
    """Seeded b-bit values x [CONV1D_N] of ``dtype`` and k [CONV1D_TAPS]
    (int64), and the plan."""
    from repro_torch.core.conv import make_plan

    lo, hi = (-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed else (
        0, (1 << bits) - 1)
    x = torch.randint(lo, hi + 1, (CONV1D_N,), generator=gen, device=dev)
    k = torch.randint(lo, hi + 1, (CONV1D_TAPS,), generator=gen, device=dev)
    return x.to(dtype), k, make_plan(bits, CONV1D_TAPS, signed)


def conv2d_plan_of(x, packed, scale, cfg, padding=1):
    from repro_torch.kernels import samd_conv as sc

    c_in, h, w = x.shape
    kh, kw, cw, c_out = packed.shape
    return sc.conv2d_plan(c_in, cw, h, w, kh, kw, c_out, padding,
                          cfg.values_per_word, x.dtype == torch.bfloat16)


class OldConv:
    """A previous ``samd_conv2d`` kernel (a ``samd_conv.cu`` whose
    ``samd_conv2d_launch(x, packed, scale, out, C, H, W, KH, KW, CW, N,
    pad, bits, lane_width, vpw, signed, bcw, x_bf16, stream)`` takes
    ``bcw`` words of channels per step), for a comparison on one card."""

    def __init__(self, source):
        self.fn = old_launcher(source, "samd_conv2d_launch", _args(4, 14))

    def __call__(self, x, packed, scale, cfg, padding=1):
        from repro_torch.kernels._build import ptr, stream_handle

        c_in, h, w = x.shape
        kh, kw, cw, n = packed.shape
        vpw = cfg.values_per_word
        out = torch.empty((h + 2 * padding - kh + 1, w + 2 * padding - kw + 1,
                           n), dtype=x.dtype, device=x.device)
        err = self.fn(ptr(x), ptr(packed), ptr(scale), ptr(out), c_in, h, w,
                      kh, kw, cw, n, padding, cfg.bits, cfg.lane_width, vpw,
                      1, max(1, 16 // vpw), int(x.dtype == torch.bfloat16),
                      stream_handle(x))
        if err:
            raise RuntimeError(f"old samd_conv2d launch failed ({err})")
        return out


def cold_graph_ms(make, n_bytes, reps=10):
    """Device ms of one call with L2 cold: ``make(i)`` is the call on the
    i-th of R copies of its inputs, and R is chosen so that the calls
    between two uses of one copy move at least twice the 50 MB L2
    (``n_bytes`` a call). The R calls are captured in turn into one CUDA
    graph (every output kept alive during capture, so each call writes
    memory of its own), the graph replayed back to back; the time is per
    call. (Replays over copies, not an L2 flush between replays: no
    flush kernel or per-replay event sits in the timed stream.)"""
    copies = 1 + -(-2 * L2_BYTES // n_bytes)
    calls = [make(i) for i in range(copies)]
    return graph_ms(lambda: [c() for c in calls], reps) / copies


def copies(*ts):
    """i -> the i-th copy of the tensors ``ts`` (0: the tensors
    themselves), each made once."""
    made = {0: ts}

    def get(i):
        if i not in made:
            made[i] = tuple(t.clone() for t in ts)
        return made[i]
    return get


def host_us_per_call(fn, calls=1000):
    """Host microseconds a call of ``fn`` takes to return (no sync): the
    median over five runs of ``calls // 5`` calls, each run after a
    sync."""
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls // 5):
            fn()
        runs.append((time.perf_counter() - t0) * 1e6 / (calls // 5))
    torch.cuda.synchronize()
    return float(np.median(runs))


def unfused_conv1d(x, k, plan):
    """The previous samd_conv1d on the card: PyTorch packing, the chunk
    launcher, the strided overlap-add."""
    from repro_torch.core.conv import (
        overlap_add, pack_conv_kernel, pack_conv_operand,
    )
    from repro_torch.kernels import samd_conv as sc

    lanes = sc.samd_conv_chunks_cuda(pack_conv_operand(x, plan),
                                     pack_conv_kernel(k, plan), plan)
    return overlap_add(lanes, plan, x.shape[0] + plan.taps - 1)


def time_conv1d(case, x, k, plan, timer):
    """(f')'s rows for one samd_conv1d case: the fused op, the previous
    unfused composition (in turns: unfused, fused, fused, unfused), the
    chunk launcher alone, the composition's other two parts (its packing
    and its overlap-add) and F.conv1d in f32 on the pre-cast signal, each
    as device time with L2 cold (``cold_graph_ms``), host-paced times and
    the wrappers' host time per call beside; bounds from the bytes of
    each (x in its own dtype, int32 out; the chunk launcher's words and
    [nc, lanes + taps - 1] lanes; f32 in and out for F.conv1d). Returns
    (fused row, chunk row)."""
    from repro_torch.core.conv import (
        overlap_add, pack_conv_kernel, pack_conv_operand,
    )
    from repro_torch.kernels import ops
    from repro_torch.kernels import samd_conv as sc

    bits, signed, dtype = case
    n, taps = x.shape[0], plan.taps
    n_out = n + taps - 1
    label = f"{bits}-bit signed={signed} {str(dtype)[6:]} x"
    fused_bytes = n * x.element_size() + taps * k.element_size() + n_out * 4
    xk = copies(x, k)

    def fused(i):
        return lambda: ops.samd_conv1d(*xk(i), plan)

    def unfused(i):
        return lambda: unfused_conv1d(*xk(i), plan)

    t = dict(ms=[], unfused_ms=[])
    for who, make in (("unfused_ms", unfused), ("ms", fused), ("ms", fused),
                      ("unfused_ms", unfused)):
        t[who].append(cold_graph_ms(make, fused_bytes))
    xf = copies(x.float()[None, None])
    kf = k.flip(0).float()[None, None]

    def lib(i):
        return lambda: torch.nn.functional.conv1d(*xf(i), kf,
                                                  padding=taps - 1)
    lib_bytes = (n + taps + n_out) * 4
    lib_ms = cold_graph_ms(lib, lib_bytes)

    def pack(i):
        x_i, k_i = xk(i)
        return lambda: (pack_conv_operand(x_i, plan),
                        pack_conv_kernel(k_i, plan))
    lanes = copies(sc.samd_conv_chunks_cuda(pack_conv_operand(x, plan),
                                            pack_conv_kernel(k, plan), plan))

    def add(i):
        return lambda: overlap_add(*lanes(i), plan, n_out)
    parts = dict(
        unfused_pack_ms=cold_graph_ms(pack, fused_bytes),
        unfused_overlap_add_ms=cold_graph_ms(
            add, (lanes(0)[0].numel() + n_out) * 4))
    fused_row = timing_row(
        f"samd_conv1d {label}", float(np.mean(t["ms"])),
        timer(lambda: sc.samd_conv1d_plain(x, k, plan), iters=3), lib_ms,
        fused_bytes, 0, unfused_ms=float(np.mean(t["unfused_ms"])), **parts,
        host_paced_ms=timer(fused(0), iters=20),
        unfused_host_paced_ms=timer(unfused(0), iters=10),
        library_host_paced_ms=timer(lib(0), iters=20),
        host_us_per_call=host_us_per_call(fused(0), 200),
        unfused_host_us_per_call=host_us_per_call(unfused(0), 50),
        library_bound_ms=bound_ms(lib_bytes, 0)[0])

    xw, kw = pack_conv_operand(x, plan), pack_conv_kernel(k, plan)
    nc = xw.shape[0]
    chunk_bytes = nc * 4 + 4 + nc * plan.out_lanes_per_chunk * 4
    xw_i = copies(xw)

    def chunks(i):
        return lambda: sc.samd_conv_chunks_cuda(*xw_i(i), kw, plan)
    chunk_row = timing_row(
        f"samd_conv_chunks {label} (L={plan.fmt.lane_width})",
        cold_graph_ms(chunks, chunk_bytes),
        timer(lambda: sc.samd_conv_chunks_plain(xw, kw, plan), iters=3),
        lib_ms, chunk_bytes, 0, words=nc, host_paced_ms=timer(chunks(0)),
        host_us_per_call=host_us_per_call(chunks(0), 200))
    for row in (fused_row, chunk_row):
        if row["ms"] < row["bound_ms"]:
            raise AssertionError(f"samd_conv1d {label}: {row['ms']} ms "
                                 "under its bound")
    return fused_row, chunk_row


def time_conv2d(name, bits, dtype, args, out, timer, old, host=False):
    """One (f) case's times: device time (the call captured in a CUDA
    graph and replayed) of the kernel, of the previous kernel when
    ``old`` is given (in turns old, new, new, old) and of F.conv2d (the
    yardstick); host-paced times of the kernel and the yardstick; the
    plain version; with ``host``, the wrapper's host time per call (1000
    calls, no sync). The bound is the route's: the operations of each
    bf16 MMA the kernel issues (two x terms for f32 x) over 989 TFLOP/s,
    or the bytes over 3.35 TB/s; the f32 CUDA-core bound (67 TFLOP/s) of
    the first version stands beside it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import samd_conv as sc

    x, packed, scale, cfg = args
    plan = conv2d_plan_of(*args)

    def new():
        return ops.samd_conv2d(*args)

    t = dict(ms=[], old_ms=[])
    if old is not None:
        check = (functools.partial(max_scaled_err, tol=CONV_F32_TOL)
                 if dtype == torch.float32
                 else functools.partial(max_err, tol=BF16_TOL))
        check(old(x, packed, scale, cfg), sc.samd_conv2d_plain(*args))

        def prev():
            return old(x, packed, scale, cfg)
        for who, fn in (("old_ms", prev), ("ms", new), ("ms", new),
                        ("old_ms", prev)):
            t[who].append(graph_ms(fn))
    else:
        t["ms"].append(graph_ms(new))
    lib_fn, _ = library_conv2d(x, packed, scale, cfg)
    n_bytes = ((x.numel() + out.numel()) * x.element_size()
               + packed.numel() * 4 + scale.numel() * 4)
    kh, kw, _, c_out = packed.shape
    oh, ow, _ = out.shape
    n_ops = 2 * oh * ow * c_out * x.shape[0] * kh * kw
    # bf16 x times a code that bf16 holds (all of (f)'s, 8 bits or fewer)
    # is one exact bf16 MMA; f32 x runs two (hi and lo terms)
    mmas = plan.terms
    extra = dict(layer=name, bits=bits, launcher=plan.launcher,
                 splits=plan.splits, blocks=plan.blocks, mma_terms=mmas)
    if old is not None:
        extra["old_ms"] = float(np.mean(t["old_ms"]))
    extra.update(
        host_paced_ms=timer(new, iters=10),
        library_host_paced_ms=timer(lib_fn, iters=10),
        bound_f32_cores_ms=(bound_ms(n_bytes, n_ops, F32_OPS_PER_S)[0]
                            if dtype == torch.float32 else None))
    if host:
        extra["host_us_per_call"] = host_us_per_call(new)
    ms = float(np.mean(t["ms"]))
    row = timing_row(
        f"samd_conv2d {name} {bits}-bit {str(dtype)[6:]}", ms,
        timer(lambda: sc.samd_conv2d_plain(*args), iters=3),
        graph_ms(lib_fn), n_bytes, n_ops, BF16_OPS_PER_S / mmas,
        tflops=n_ops / ms / 1e9, **extra)
    if row["ms"] < row["bound_ms"]:
        raise AssertionError(f"{name}: {row['ms']} ms under its bound")
    return row


def run_vggb(dev, gen, timer, card, old=None):
    """Phase (f): the main path through the conv2d launchers and the
    fused conv1d launcher, then every result against its references;
    the chunk launcher on its own path (the four int64 plans' packed
    words) against its plain version; then the timings. Returns the
    kernels-line entries."""
    from repro_torch.core.conv import (
        overlap_add, pack_conv_kernel, pack_conv_operand,
    )
    from repro_torch.kernels import ops
    from repro_torch.kernels import samd_conv as sc

    cases = vggb_cases()
    inputs = [vggb_inputs(dev, gen, *c[1:]) for c in cases]
    signals = [conv1d_signal(dev, gen, *case) for case in CONV1D_CASES]
    entry = CONV1D_CASES.index(CONV1D_ENTRY_CASE)
    x, k, plan = signals[entry]
    signals.append((x[1:], k, plan))  # not 16-byte aligned
    ops.reset_launch_counts()
    outs = [ops.samd_conv2d(*args) for args in inputs]
    outs1d = [ops.samd_conv1d(*sig) for sig in signals]
    torch.cuda.synchronize(dev)
    counts = ops.launch_counts()
    want = {CONV1D: len(signals)}
    for args in inputs:  # conv2d_plan's launcher for each case
        fn = conv2d_plan_of(*args).launcher
        want[fn] = want.get(fn, 0) + 1
    if counts != {fn: want.get(fn, 0) for fn in counts}:
        raise AssertionError(f"(f) launched {counts}, expected {want}")
    log(f"  (f) launches: {json.dumps(counts)}")

    errs = {}
    for (name, c_in, c_out, h, w, bits, dtype), args, out in zip(
            cases, inputs, outs):
        if out.shape != (h, w, c_out) or out.dtype != dtype:
            raise AssertionError(f"{name}: out {tuple(out.shape)} {out.dtype}")
        plain = sc.samd_conv2d_plain(*args)
        x, packed, scale, cfg = args
        _, lib = library_conv2d(x.float(), packed, scale, cfg)
        check = (functools.partial(max_scaled_err, tol=CONV_F32_TOL)
                 if dtype == torch.float32
                 else functools.partial(max_err, tol=BF16_TOL))
        errs[name, bits, dtype] = (check(out, plain), check(out, lib),
                                   plain.float().abs().max().item())
    log("  samd_conv2d: " + json.dumps(
        {f"{n} {b}-bit {str(d)[6:]}": [float(f"{v:.3g}") for v in e]
         for (n, b, d), e in errs.items()})
        + " (max |kernel - plain|, max |kernel - F.conv2d|, max |plain|)")

    conv1d_err = 0
    for (x, k, plan), out in zip(signals, outs1d):
        n = x.shape[0]
        direct = torch.zeros(n + CONV1D_TAPS - 1, dtype=torch.int64,
                             device=dev)
        for j in range(CONV1D_TAPS):
            direct[j:j + n] += k[j] * x.long()
        plain = sc.samd_conv1d_plain(x, k, plan)
        conv1d_err = max(conv1d_err, (out - plain).abs().max().item())
        if not (out.dtype == torch.int32 and torch.equal(out, plain)
                and torch.equal(out.long(), direct)):
            raise AssertionError(
                f"samd_conv1d {plan.fmt.bits}-bit signed={plan.fmt.signed} "
                f"{x.dtype} (offset {x.storage_offset()}): not "
                "bit-identical")
    names = [f"{b}-bit signed={sg} {str(d)[6:]}" for b, sg, d in CONV1D_CASES]
    log(f"  samd_conv1d: {len(signals)} signals of {CONV1D_N} values "
        f"({', '.join(names)}, and the entry case's x[1:]) bit-identical "
        "to samd_conv1d_plain and to a direct integer convolution")

    # the chunk launcher, the counterpart of the TPU function, on its own
    # path: the int64 plans' packed words, then against its plain version
    int64 = [(sig, out) for sig, out, case in zip(signals, outs1d,
                                                  CONV1D_CASES)
             if case[2] == torch.int64]
    words = [(pack_conv_operand(x, plan), pack_conv_kernel(k, plan), plan)
             for (x, k, plan), _ in int64]
    ops.reset_launch_counts()
    chunk_lanes = [sc.samd_conv_chunks_cuda(*w) for w in words]
    torch.cuda.synchronize(dev)
    chunk_counts = ops.launch_counts()
    if chunk_counts != {fn: len(words) if fn == CHUNKS else 0
                        for fn in chunk_counts}:
        raise AssertionError(f"(f) chunk path launched {chunk_counts}")
    lane_err = 0
    for (xw, kw, plan), lanes, (_, out) in zip(words, chunk_lanes, int64):
        plain_lanes = sc.samd_conv_chunks_plain(xw, kw, plan)
        lane_err = max(lane_err, (lanes - plain_lanes).abs().max().item())
        if not (torch.equal(lanes, plain_lanes) and torch.equal(
                overlap_add(lanes, plan, out.shape[0]), out)):
            raise AssertionError(f"samd_conv_chunks {plan.fmt.bits}-bit "
                                 f"signed={plan.fmt.signed}: not "
                                 "bit-identical")
    log(f"  samd_conv_chunks: {len(words)} launches "
        f"{json.dumps({CHUNKS: chunk_counts[CHUNKS]})}, bit-identical to "
        "its plain version, overlap-added to the fused outputs")

    log(f"(f') conv kernel times (card: {card})")
    rows = {}
    for (name, c_in, c_out, h, w, bits, dtype), args, out in zip(
            cases, inputs, outs):
        rows[name, bits, dtype] = time_conv2d(
            name, bits, dtype, args, out, timer, old,
            host=(name, bits) == CONV_ENTRY_CASE and dtype == torch.float32)
    for b in CONV_BITS:
        sel = [r for key, r in rows.items()
               if key[1] == b and key[2] == torch.float32]
        log(f"  VGG-B 10 layers {b}-bit f32: kernel "
            f"{sum(r['ms'] for r in sel):.4f} ms"
            + (f", previous kernel {sum(r['old_ms'] for r in sel):.4f}"
               if old is not None else "")
            + f", plain {sum(r['plain_ms'] for r in sel):.4f}, F.conv2d "
            f"{sum(r['library_ms'] for r in sel):.4f}, bound "
            f"{sum(r['bound_ms'] for r in sel):.4f} (f32 CUDA-core bound "
            f"{sum(r['bound_f32_cores_ms'] for r in sel):.4f}) (device "
            "times)")

    conv1d_rows = {}
    for case, (x, k, plan) in zip(CONV1D_CASES, signals):
        conv1d_rows[case] = time_conv1d(case, x, k, plan, timer)
    log("  samd_conv1d device ms (L2 cold) fused / unfused / chunk "
        "launcher / F.conv1d / fused bound: " + json.dumps({
            f"{b}-bit signed={sg} {str(d)[6:]}": [
                round(r[key], 5) for r, key in (
                    (f, "ms"), (f, "unfused_ms"), (c, "ms"),
                    (f, "library_ms"), (f, "bound_ms"))]
            for (b, sg, d), (f, c) in conv1d_rows.items()}))

    name, bits = CONV_ENTRY_CASE
    _, c_in, c_out, h, w, _, _ = next(c for c in cases
                                      if c[0] == name and c[5] == bits)
    bits1d, signed1d, dtype1d = CONV1D_ENTRY_CASE
    fused_row, chunk_row = conv1d_rows[CONV1D_ENTRY_CASE]
    # (k) holds the 64-bit words against these: kept in host memory so
    # that the later phases' device peaks are their own
    results = {case: (x.cpu(), k.cpu(), out.cpu()) for case, (x, k, _), out
               in zip(CONV1D_CASES, signals, outs1d)}
    return results, [
        kernel_entry(
            f"samd_conv2d (VGG-B {name}, {bits}-bit, f32)", CONV_SOURCE,
            "src/repro/kernels/samd_conv.py:192", counts[CONV2D],
            errs[name, bits, torch.float32][0],
            rows[name, bits, torch.float32],
            f"{name}: x [{c_in}, {h}, {w}] f32, 3x3, padding 1, {bits}-bit "
            f"packed weights, C_out {c_out}; library: F.conv2d of the "
            "dequantized weight (f32, no TF32); ms, old_ms and library_ms "
            "are device times"),
        kernel_entry(
            "samd_conv2d im2col (VGG-B conv1_1, 4-bit, f32)", CONV_SOURCE,
            "src/repro/kernels/samd_conv.py:192", counts[CONV2D_IM2COL],
            errs["conv1_1", 4, torch.float32][0],
            rows["conv1_1", 4, torch.float32],
            "conv1_1: x [3, 224, 224] f32, 3x3, padding 1, 4-bit packed "
            "weights, C_out 64 (27 products a pixel); library: F.conv2d of "
            "the dequantized weight (f32, no TF32); device times"),
        kernel_entry(
            f"samd_conv1d fused ({bits1d}-bit signed plan, "
            f"{str(dtype1d)[6:]} x)", CONV_SOURCE,
            "src/repro/kernels/samd_conv.py:105", counts[CONV1D],
            conv1d_err, fused_row,
            f"{CONV1D_N} values, {CONV1D_TAPS} taps -> int32; launches: "
            f"{len(signals)} signals of (f); library: F.conv1d in f32 on "
            "the pre-cast signal; device times, L2 cold"),
        kernel_entry(
            f"samd_conv_chunks ({bits1d}-bit signed plan)", CONV_SOURCE,
            "src/repro/kernels/samd_conv.py:105", chunk_counts[CHUNKS],
            lane_err, chunk_row,
            f"{CONV1D_N} values' {chunk_row['words']} "
            "chunk words, per launch; launches: its own path (the int64 "
            "plans' words); library: "
            "F.conv1d in f32 of the whole conv; device times, L2 cold"),
    ]


# -- (g) the async front door -------------------------------------------------

def time_decode_ticks(eng):
    """Wrap ``eng.step`` (in whichever thread runs it): returns a list
    that gets the host ms of every step that decoded and ran no prefill,
    as (c) counts its decode ticks."""
    step = eng.step
    ms = []

    def timed():
        st = eng.stats
        before = (st["prefill_calls"], st["decode_steps"])
        t = time.perf_counter()
        out = step()  # ends in a host sync (the sampled ids)
        if (st["prefill_calls"], st["decode_steps"]) == (before[0],
                                                         before[1] + 1):
            ms.append((time.perf_counter() - t) * 1e3)
        return out

    eng.step = timed
    return ms


async def drive_open_loop(server, reqs, arrivals):
    """Submit each request at its arrival (seconds after the start) and
    collect every stream, within ``FRONT_DOOR_TIMEOUT_S``: a serve loop
    that died leaves its streams open, so a timeout exits non-zero, with
    the loop's own exception where it raised one. Returns (completed
    requests, refusals, arrival lags in s: submit time minus scheduled
    arrival)."""
    from repro_torch.serving import RejectedRequest

    completed, rejected, lags = [], [], []
    t0 = server.clock()

    async def one(req, at):
        delay = at - (server.clock() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        lags.append(server.clock() - t0 - at)
        try:
            stream = server.submit(req.prompt, req.max_tokens, rid=req.rid)
        except RejectedRequest as rej:
            rejected.append(rej)
            return
        toks = await stream.collect()
        if toks != stream.request.generated:
            raise AssertionError(f"request {req.rid}: the stream carried "
                                 "other tokens than the request holds")
        completed.append(stream.request)

    await server.start()
    try:
        await asyncio.wait_for(
            asyncio.gather(*(one(r, at) for r, at in zip(reqs, arrivals))),
            FRONT_DOOR_TIMEOUT_S)
    except asyncio.TimeoutError:
        # stop() re-raises an exception that ended the serve loop
        await asyncio.wait_for(server.stop(drain=False), 30)
        raise AssertionError(f"front door: streams still open after "
                             f"{FRONT_DOOR_TIMEOUT_S} s") from None
    await asyncio.wait_for(server.stop(), FRONT_DOOR_TIMEOUT_S)
    return completed, rejected, lags


def front_door_row(eng, dev, reqs, direct, load, policy, capacity_rps,
                   capacity_tps, seed, inline_tick_ms, expect):
    """One open-loop row on a fresh server over ``eng`` (reset first):
    Poisson arrivals at ``load`` x capacity, the step in a worker thread.
    Asserts conservation, streams, the snapshot, the stamps, the tokens
    against ``direct`` (``check_greedy``'s rule) and the launchers;
    returns the printed summary."""
    from repro_torch.kernels import ops
    from repro_torch.serving import AsyncServer
    from repro_torch.serving.metrics import (
        parse_prometheus, percentile, summarize,
    )

    slo_s = SLO_TOKEN_BUDGET / capacity_rps
    offered_rps = load * capacity_rps
    eng.reset()
    server = AsyncServer(eng, policy=policy, max_queue=FRONT_DOOR_QUEUE,
                         default_slo_s=slo_s if policy == "slo" else None,
                         capacity_tokens_per_s=capacity_tps,
                         step_in_thread=True)
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / offered_rps, size=len(reqs)))
    ticks = time_decode_ticks(eng)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    try:
        completed, rejected, lags = asyncio.run(
            drive_open_loop(server, reqs, arrivals))
    finally:
        del eng.step  # the engine's own step again
    wall = time.perf_counter() - t0
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    label = f"{load}x {policy}"
    if len(completed) + len(rejected) != len(reqs):
        raise AssertionError(f"{label}: {len(completed)} completed + "
                             f"{len(rejected)} rejected != {len(reqs)}")
    if server.counters["completed"] != len(completed):
        raise AssertionError(f"{label}: counters {server.counters}")
    snap = parse_prometheus(server.metrics_snapshot())
    for k, v in server.counters.items():
        if snap[f"samd_server_{k}_total"] != v:
            raise AssertionError(f"{label}: snapshot {k} != {v}")
    for r in completed:
        if r.error or r.truncated or len(r.generated) != MAX_TOKENS:
            raise AssertionError(f"{label}: request {r.rid}: error="
                                 f"{r.error} truncated={r.truncated}")
        if not r.t_submit <= r.t_admit <= r.t_first_token <= r.t_retire:
            raise AssertionError(f"{label}: request {r.rid} stamps out of "
                                 "order")
    for name, c in counts.items():
        if (c > 0) != (name in expect):
            raise AssertionError(f"{label}: launcher {name} ran {c} times; "
                                 f"expected {sorted(expect)} only")
    identical = check_greedy(eng, direct, dev, reqs=completed,
                             against="the direct engine run")
    counts = {k: v for k, v in counts.items() if v}
    summ = summarize(completed, slo_s=slo_s)
    lag_ms = [v * 1e3 for v in lags]
    row = dict(
        row=label, offered_rps=round(offered_rps, 3),
        slo_s=round(slo_s, 4), n_requests=len(reqs),
        completed=len(completed), rejected=len(rejected),
        rejected_by_code={c: sum(r.code == c for r in rejected)
                          for c in ("queue_full", "infeasible", "slo")},
        deadline_misses=summ["deadline_misses"],
        **{k: (round(summ[k], 3) if summ[k] is not None else None)
           for k in ("p50_ttft_ms", "p99_ttft_ms", "p50_tpot_ms",
                     "p99_tpot_ms", "p50_e2e_ms", "p99_e2e_ms")},
        goodput_tokens_per_s=round(
            sum(len(r.generated) for r in completed) / wall, 1),
        serve_s=round(wall, 3),
        thread_tick_ms_median=(round(float(np.median(ticks)), 3)
                               if ticks else None),
        inline_tick_ms_median_c=inline_tick_ms,
        decode_ticks=len(ticks),
        arrival_lag_ms_p50=round(percentile(lag_ms, 50), 3),
        arrival_lag_ms_p99=round(percentile(lag_ms, 99), 3),
        token_identical=identical, snapshot_keys=len(snap),
        launches=counts)
    log(f"  front door ({label}): " + json.dumps(row))
    return row


def capacity_burst(eng):
    """One closed-loop burst of ``workload(1)`` straight through the
    engine, as ``benchmarks/bench_openloop.measure_capacity`` runs it;
    resets the engine after. Returns (requests/s, tokens/s)."""
    burst = workload(1)
    t0 = time.perf_counter()
    for r in burst:
        eng.submit(r)
    done = eng.run_to_completion()
    dt = time.perf_counter() - t0
    if len(done) != len(burst) or any(r.error for r in done):
        raise AssertionError("front door: the capacity burst failed")
    eng.reset()
    return len(burst) / dt, sum(len(r.generated) for r in done) / dt


def thread_against_inline(eng):
    """The capacity burst through ``AsyncServer``, every request at time
    0, with the step inline and in a worker thread in the turns of
    ``THREAD_AB_ORDER``: the same work both ways in one call. Returns
    each side's decode-tick median (ticks of both its runs pooled) and
    its runs' tokens/s."""
    from repro_torch.serving import AsyncServer

    burst = workload(1)
    out = {False: ([], []), True: ([], [])}
    for in_thread in THREAD_AB_ORDER:
        ticks = time_decode_ticks(eng)
        t0 = time.perf_counter()
        try:
            done, rejected, _ = asyncio.run(drive_open_loop(
                AsyncServer(eng, max_queue=FRONT_DOOR_QUEUE,
                            step_in_thread=in_thread),
                burst, [0.0] * len(burst)))
        finally:
            del eng.step
        dt = time.perf_counter() - t0
        if rejected or len(done) != len(burst):
            raise AssertionError("front door: the A/B burst lost requests")
        out[in_thread][0].extend(ticks)
        out[in_thread][1].append(
            round(sum(len(r.generated) for r in done) / dt, 1))
        eng.reset()
    res = {}
    for in_thread, side in ((False, "inline"), (True, "thread")):
        ticks, tps = out[in_thread]
        res[f"{side}_tick_ms_median"] = round(float(np.median(ticks)), 3)
        res[f"{side}_decode_ticks"] = len(ticks)
        res[f"{side}_tokens_per_s"] = tps
    res["order"] = ["thread" if t else "inline" for t in THREAD_AB_ORDER]
    log("  step inline against in a thread (the capacity burst through "
        "AsyncServer): " + json.dumps(res))
    return res


def run_front_door(eng, dev, inline_tick_ms, expect):
    """(g): warm ``eng`` through a server, measure capacity (the median
    of ``CAPACITY_BURSTS`` closed-loop bursts of ``workload(1)``), serve
    that burst through a server with the step inline and in a thread in
    turns, serve ``FRONT_DOOR_N`` requests directly for their reference
    tokens, then the open-loop rows of ``FRONT_DOOR_ROWS``, with the
    launch counts reset just before them. Returns (summary, the sum of
    the rows' launch counts, each taken while its row served)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import AsyncServer

    eng.reset()
    warm = workload(FRONT_DOOR_SEED)[:2]
    asyncio.run(drive_open_loop(AsyncServer(eng, step_in_thread=True),
                                warm, [0.0, 0.0]))
    eng.reset()
    bursts = [capacity_burst(eng) for _ in range(CAPACITY_BURSTS)]
    capacity_rps = float(np.median([rps for rps, _ in bursts]))
    capacity_tps = float(np.median([tps for _, tps in bursts]))
    log(f"  capacity (median of {CAPACITY_BURSTS} closed-loop bursts of "
        f"{len(workload(1))} requests): {capacity_rps:.3f} requests/s, "
        f"{capacity_tps:.1f} tokens/s (bursts: "
        f"{[round(t, 1) for _, t in bursts]} tokens/s); "
        f"SLO {SLO_TOKEN_BUDGET / capacity_rps:.3f} s")
    ab = thread_against_inline(eng)
    reqs = workload(FRONT_DOOR_SEED, FRONT_DOOR_N)
    for r in workload(FRONT_DOOR_SEED, FRONT_DOOR_N):
        eng.submit(r)
    direct = eng.run_to_completion()
    if len(direct) != FRONT_DOOR_N or any(r.error for r in direct):
        raise AssertionError("front door: the direct run failed")
    # the main path: the open-loop rows through AsyncServer; each row's
    # launches are counted while it serves, so the forwards that check a
    # near-tie after the row are not among them
    ops.reset_launch_counts()
    rows = [front_door_row(eng, dev, reqs[:n], direct, load, policy,
                           capacity_rps, capacity_tps, FRONT_DOOR_SEED,
                           inline_tick_ms, expect)
            for load, policy, n in FRONT_DOOR_ROWS]
    counts = {k: sum(row["launches"].get(k, 0) for row in rows)
              for k in ops.launch_counts()}
    for name, c in counts.items():
        if (c > 0) != (name in expect):
            raise AssertionError(f"(g): launcher {name} ran {c} times; "
                                 f"expected {sorted(expect)} only")
    return dict(capacity_rps=capacity_rps,
                capacity_tokens_per_s=capacity_tps,
                capacity_bursts_tokens_per_s=[t for _, t in bursts],
                thread_against_inline=ab, rows=rows), counts


# -- (h) the engine's other modes, qwen3-14b, group scales, the analysis ------

class LaunchLog:
    """Records the arguments of every launch the matmul and conv sources
    make (wrapping their ``Kernel.launch``; the counts stay the
    wrappers'): the plans (h5) checks, and launches by shape."""

    def __init__(self):
        from repro_torch.kernels import samd_conv, samd_matmul

        self.plans = collections.Counter()
        for kern in (samd_matmul.KERNEL, samd_conv.KERNEL):
            launch = kern.launch

            def record(fn, *args, _launch=launch):
                _launch(fn, *args)
                self.plans[self.key(fn, args)] += 1

            kern.launch = record

    @staticmethod
    def key(fn, args):
        """The plan of one launch from its launcher's arguments (their
        order is the wrappers'): matmul (M, N, K, vpw, splits); conv2d
        (C_in, H, W, KH, KW, CW, C_out, pad, bits, lane width, vpw,
        signed, bf16 x, splits, step_k, steps); conv1d (tile chunks,
        lanes, x's type code)."""
        if fn in (SPLITK, TILE):
            return (fn, args[4], args[5], args[6], args[9], args[11])
        if fn in (CONV2D, CONV2D_IM2COL):
            return (fn,) + tuple(args[6:22])
        if fn == CONV1D:
            return (fn, args[8], args[12], args[16])
        return (fn,)

    def matmul(self):
        """(launcher, M, N, K, vpw, splits) -> launches."""
        return collections.Counter(
            {key: c for key, c in self.plans.items()
             if key[0] in (SPLITK, TILE)})


def serve_modes(dev, c_done, c_sum):
    """(h1) (c)'s 4-bit bf16-KV engine in ring and gather mode, (h2) its
    per-row path; tokens against (c)'s fused paged run (``c_done``, its
    finished requests, taken before (g) reset and reused the engine).
    Returns {mode: (summary, counts)}."""
    from repro_torch.quant.config import QuantConfig

    out = {}
    for mode, kw, extra in (
            ("ring", dict(kv_mode="ring"), {}),
            ("gather", dict(paged_attn="gather"), {}),
            ("per-row", dict(decode_mode="per_row"),
             dict(n=PER_ROW_REQUESTS, max_tokens=PER_ROW_TOKENS))):
        eng, summary, counts = serve(f"4-bit, bf16 KV, {mode}", dev,
                                     {SPLITK, TILE},
                                     quant=QuantConfig(bits=4), **kw, **extra)
        summary["identical"] = check_greedy(
            eng, c_done, dev, against="(c)'s fused paged run")
        summary["stats"] = dict(eng.stats)
        if mode == "per-row" and not eng.stats["per_row_forward_calls"]:
            raise AssertionError("the per-row path made no per-row forward")
        out[mode] = (summary, counts)
        del eng
    keys = ("decode_tick_ms_median", "decode_tick_ms_mean", "tokens_per_s",
            "peak_mem_gib", "kv_cache_gib")
    log("  modes beside (c)'s fused paged run: " + json.dumps(
        {"(c) fused paged": {k: c_sum[k] for k in keys if k in c_sum}}
        | {m: {k: sm[k] for k in keys} for m, (sm, _) in out.items()}))
    return out


def time_lm_head(dev, timer, head, m, arch="qwen3-14b"):
    """The packed LM head at M = ``m`` rows: device time of one launch in
    a CUDA graph beside dense bf16 ``torch.matmul`` on its dequantized
    weight, host-paced times, the plain version, the bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import samd_matmul as mm
    from repro_torch.quant.packing import dequant_weights

    k, n = head.orig_shape
    cfg = head.cfg
    x = torch.randn(m, k, device=dev).to(torch.bfloat16)
    dense = dequant_weights(head.packed, head.scale, k, cfg)

    def kern():
        return ops.samd_matmul(x, head.packed, head.scale, k, cfg)

    def lib():
        return torch.matmul(x, dense)

    n_bytes = (x.numel() * 2 + head.packed.numel() * 4
               + head.scale.numel() * 4 + m * n * 2)
    row = timing_row(
        f"samd_matmul ({arch} LM head, M={m})", graph_ms(kern),
        timer(lambda: mm.samd_matmul_plain(x, head.packed, head.scale, k,
                                           cfg), iters=3),
        graph_ms(lib), n_bytes, 2 * m * k * n, k=k, n=n,
        launcher=mm.launcher_for(m),
        splits=mm.split_k(m, n, k, cfg.values_per_word)[0],
        host_paced_ms=timer(kern), library_host_paced_ms=timer(lib),
        dense_bf16_bound_ms=bound_ms(x.numel() * 2 + k * n * 2
                                     + m * n * 2, 2 * m * k * n)[0],
        host_us_per_call=host_us_per_call(kern))
    del dense
    return row


def serve_qwen3(dev, timer, launch_log):
    """(h3) full-width qwen3-14b, 4-bit, the untied LM head packed: (c)'s
    16 requests; its logits against the plain versions; (d)'s device
    times of its decode linears, its LM head and a prefill. Returns
    (summary, counts, launches by matmul shape, timings)."""
    from repro_torch.configs.archs import QWEN3_14B
    from repro_torch.models.layers import QuantizedTensor
    from repro_torch.quant.config import QuantConfig

    before = launch_log.matmul()
    eng, summary, counts = serve(
        "qwen3-14b, 4-bit, LM head packed, bf16 KV", dev,
        {SPLITK, TILE, DECODE}, arch=QWEN3_14B,
        quant=QuantConfig(bits=4, quantize_embeddings=True))
    shapes = launch_log.matmul() - before
    head = eng.params["lm_head"]
    if not isinstance(head, QuantizedTensor):
        raise AssertionError("qwen3-14b's LM head was not packed")
    head_launches = {key: c for key, c in shapes.items()
                     if key[2] == QWEN3_14B.vocab}
    if not any(key[0] == SPLITK for key in head_launches):
        raise AssertionError("the LM head never ran the split-K launcher")
    summary["lm_head_launches"] = {f"{key[0]} M={key[1]}": c
                                   for key, c in head_launches.items()}
    pre, dec, scale, seen = check_model_against_plain(
        eng, dev, plain_on_card=True, controls=scale_controls(eng.params))
    summary["model_errs"] = dict(prefill=pre, decode=dec, scale=scale,
                                 scale_controls=seen)
    log("  qwen3-14b serving: " + json.dumps(summary))
    t = dict(decode=time_samd_matmul(dev, timer, eng.params,
                                     "qwen3-14b decode, M=8", 8),
             head=time_lm_head(dev, timer, head, 8),
             prefill=time_samd_matmul(dev, timer, eng.params,
                                      "qwen3-14b prefill, M=1024", 1024))
    del eng, head
    torch.cuda.empty_cache()
    return summary, counts, shapes, t


def serve_group_scales(dev):
    """(h4) the same qwen3-14b with ``group_size`` scales: every linear,
    the LM head too, through the dequantize route, so no matmul launcher
    runs; decode attention does."""
    from repro_torch.configs.archs import QWEN3_14B
    from repro_torch.models.layers import QuantizedTensor
    from repro_torch.quant.config import QuantConfig

    eng, summary, counts = serve(
        f"qwen3-14b, 4-bit, group_size={GROUP_SIZE}, LM head packed, "
        "bf16 KV", dev, {DECODE}, arch=QWEN3_14B, n=GROUP_REQUESTS,
        max_tokens=GROUP_TOKENS,
        quant=QuantConfig(bits=4, group_size=GROUP_SIZE,
                          quantize_embeddings=True))
    grouped = [w for blk in eng.params["blocks"] for part in blk.values()
               for w in part.values() if isinstance(w, QuantizedTensor)]
    grouped.append(eng.params["lm_head"])
    if not all(w.scale.shape[0] == w.k // GROUP_SIZE for w in grouped):
        raise AssertionError("a linear has no group scales")
    del eng
    torch.cuda.empty_cache()
    return summary, counts


def check_analysis(dev, launch_log):
    """(h5) every launch plan the run used: the shared-memory estimate of
    ``analysis.contracts`` is at least the kernel's own (the static bytes
    the runtime reports for the compiled kernel plus the dynamic bytes
    its launcher passes, from the source's ``*_smem_bytes`` query) and
    within the card's 227 KB; ``act_bits`` refused at engine
    construction exactly where K x 2^(bits-1) x 2^(act_bits-1) passes
    2^24 (the f32 exactness bound, counted here without the port's
    analysis);
    ``certify`` finds nothing unsafe."""
    import io

    from repro_torch.analysis import certify, contracts
    from repro_torch.analysis.lanes import LaneSafetyError
    from repro_torch.configs.archs import QWEN3_14B, QWEN15_05B
    from repro_torch.kernels import samd_conv
    from repro_torch.kernels import samd_matmul as mm
    from repro_torch.quant.config import QuantConfig
    from repro_torch.serving.engine import ServingEngine

    def own(kern, fn, *args):
        got = kern.query(fn, *args)
        if got < 0:
            raise AssertionError(f"{fn}{args} gave {got}")
        return got

    limit, rows = contracts.SMEM_LIMIT_BYTES, []
    for (fn, m, n, k, vpw, splits), c in sorted(launch_log.matmul().items()):
        rows.append((fn, f"M={m} N={n} K={k} vpw={vpw} splits={splits}",
                     contracts.matmul_smem_bytes(fn, m, vpw, splits),
                     own(mm.KERNEL, "samd_matmul_smem_bytes",
                         int(fn == TILE), m, vpw, splits), c))
    for key, c in sorted(launch_log.plans.items()):
        fn = key[0]
        if fn in (CONV2D, CONV2D_IM2COL):
            (c_in, h, w, kh, kw, cw, n, pad, bits, _, vpw, signed, x_bf16,
             splits, _, _) = key[1:]
            plan = samd_conv.conv2d_plan(c_in, cw, h, w, kh, kw, n, pad,
                                         vpw, bool(x_bf16), fn)
            wide = bits > (9 if signed else 8)
            rows.append((fn, f"C={c_in} {h}x{w} N={n} vpw={vpw} "
                         f"x_bf16={x_bf16} splits={splits}",
                         contracts.conv2d_smem_bytes(plan, vpw, wide),
                         own(samd_conv.KERNEL, "samd_conv2d_smem_bytes", vpw,
                             int(x_bf16), int(wide),
                             int(fn == CONV2D_IM2COL)), c))
        elif fn == CONV1D:
            tile_chunks, lanes, x_code = key[1:]
            isz = (1, 1, 2, 4, 8)[x_code]
            rows.append((fn, f"tile={tile_chunks} lanes={lanes} x={isz}B",
                         contracts.conv1d_smem_bytes(types.SimpleNamespace(
                             tile_chunks=tile_chunks, lanes=lanes), isz),
                         own(samd_conv.KERNEL, "samd_conv1d_smem_bytes",
                             tile_chunks, lanes, x_code), c))
    bad = [r for r in rows if not r[3] <= r[2] <= limit]
    groups = collections.defaultdict(lambda: [0, 0, []])
    for fn, what, est, own, c in rows:
        g = groups[fn, est, own]
        g[0] += 1
        g[1] += c
        g[2].append(what)
    for (fn, est, own), (n_plans, c, whats) in sorted(groups.items()):
        log(f"  smem {fn}: estimate {est} B, kernel {own} B: {n_plans} "
            f"plans, {c} launches (e.g. {whats[0]})")
    if bad:
        raise AssertionError(f"shared-memory estimates below the kernel's "
                             f"own or over {limit} B: {bad}")
    log(f"  shared memory: {len(rows)} launch plans, every estimate >= the "
        f"kernel's own bytes and <= {limit} B")

    verdicts = []
    for arch, bits in ((QWEN15_05B, 4), (QWEN15_05B, 8), (QWEN3_14B, 4)):
        qcfg = QuantConfig(bits=bits, act_bits=ACT_BITS,
                           quantize_embeddings=not arch.tie_embeddings)
        depths = {arch.d_model, arch.d_ff, arch.n_heads * arch.head_dim}
        unsafe = any(k << (bits - 1) << (ACT_BITS - 1) > F32_EXACT
                     for k in depths)
        try:
            eng = ServingEngine(arch, None, quant=qcfg, max_batch=1,
                                max_len=16, device=dev)
            raised = None
            del eng
        except LaneSafetyError as e:
            raised = e.verdict
        torch.cuda.empty_cache()
        if (raised is not None) != unsafe:
            raise AssertionError(
                f"{arch.name} bits={bits} act_bits={ACT_BITS}: expected "
                f"{'a refusal' if unsafe else 'an engine'}, got {raised}")
        verdicts.append(dict(arch=arch.name, bits=bits, act_bits=ACT_BITS,
                             max_depth=max(depths), refused=unsafe,
                             status=raised.status if raised else "safe",
                             depth=raised.depth if raised else None))
    log("  act_bits at engine construction: " + json.dumps(verdicts))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = certify.main(["--bench", str(ROOT / "BENCH_serving.json")])
    text = buf.getvalue().strip().splitlines()[-1]
    log(f"  {text}")
    if rc != 0 or "0 unsafe" not in text:
        raise AssertionError(f"certify: {text}")
    return dict(smem_plans=len(rows), act_bits=verdicts, certify=text)


# -- (i) the reference's other families at full width -----------------------

def run_families(dev, timer, gen, launch_log,
                 layers=(None, None, ZAMBA2_LAYERS)):
    """(i): decode attention at olmoe's and nemotron's shapes, then
    ``serve_family`` for olmoe-1b-7b (paged), rwkv6-3b and zamba2-7b
    (ring), each at ``layers`` (None: its published depth). Returns
    ({arch: summary}, the kernels line's entries)."""
    from repro_torch.configs.archs import OLMOE_1B_7B, RWKV6_3B, ZAMBA2_7B

    attn = check_family_attention(dev, gen)
    families, entries = {}, []
    for (cfg, expect, prefill_m, attn_err), n in zip((
            (OLMOE_1B_7B, {SPLITK, TILE, DECODE}, 1024,
             attn["olmoe-1b-7b", "bf16"]),
            (RWKV6_3B, {SPLITK, TILE}, 256, None),
            (ZAMBA2_7B, {SPLITK, TILE}, 256, None)), layers):
        cfg = cfg.scaled(n_layers=n or cfg.n_layers)
        t0 = time.perf_counter()
        summary, counts, head_n, errs, t = serve_family(
            dev, timer, gen, launch_log, cfg, expect, prefill_m)
        summary["phase_s"] = round(time.perf_counter() - t0, 1)
        families[cfg.name] = summary
        entries += family_entries(cfg, counts, head_n, errs, t, attn_err,
                                  prefill_m)
    return families, entries


def check_family_attention(dev, gen):
    """Decode attention at olmoe-1b-7b's shape (16 heads, G = 1, dh =
    128) and nemotron-4-15b's (8 kv-heads, G = 6, dh = 128), bf16 and
    packed int8 pools, against the plain version; two calls
    bit-identical, an empty slot exact zeros. Returns the max |kernel -
    plain| keyed by (arch, KV format)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    errs = {}
    for arch, hkv, g in (("olmoe-1b-7b", 16, 1), ("nemotron-4-15b", 8, 6)):
        for packed in (False, True):
            args, kw = paged_case(dev, gen, 8, hkv, g, 128, 16, 32, packed,
                                  [40, -1, 255, 16, 15, 300, 0, 490])
            got = ops.paged_decode_attention(*args, **kw)
            if not torch.equal(got, ops.paged_decode_attention(*args, **kw)):
                raise AssertionError(f"{arch}: two decode calls differ")
            if not (got[1] == 0).all():
                raise AssertionError(f"{arch}: an empty slot must emit 0")
            errs[arch, "int8" if packed else "bf16"] = max_err(
                got, pa.paged_decode_attention_plain(*args, **kw), BF16_TOL)
    log("  paged_decode_attention at olmoe's (G=1) and nemotron's (G=6) "
        "shapes, dh=128: max |kernel - plain| = " + json.dumps(
            {f"{a} {f}": e for (a, f), e in errs.items()}))
    return errs


def packed_linears(params):
    """The packed 2D linears of a parameter tree (the matmul launchers'
    weights), grouped by (K, N) in tree order."""
    from repro_torch.models.layers import QuantizedTensor

    groups = collections.defaultdict(list)

    def visit(node):
        if isinstance(node, QuantizedTensor):
            if len(node.orig_shape) == 2 and node.axis == 0:
                groups[tuple(node.orig_shape)].append(node)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)

    visit(params)
    return dict(groups)


def check_linears(dev, gen, groups, ms):
    """(b) at a served model's shapes, on its own packed weights: the
    first weight of each (K, N) at each M of ``ms``, launching
    ``launcher_for(M)`` only, bit-identical on a second call, within
    BF16_TOL of its plain version element by element and BF16_RMS_TOL as
    a whole. Returns the max |kernel - plain| keyed by (K, N, M)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import samd_matmul as mm

    errs, rms = {}, {}
    for (k, n), ws in groups.items():
        w = ws[0]
        for m in ms:
            x = torch.randn(m, k, generator=gen, device=dev).to(
                torch.bfloat16)
            before = ops.launch_counts()
            got = ops.samd_matmul(x, w.packed, w.scale, k, w.cfg)
            moved = {f for f, c in ops.launch_counts().items()
                     if c != before[f]}
            if moved != {mm.launcher_for(m)}:
                raise AssertionError(f"K={k} N={n} M={m} launched {moved}")
            if not torch.equal(got, ops.samd_matmul(x, w.packed, w.scale,
                                                    k, w.cfg)):
                raise AssertionError(f"two calls differ at K={k} N={n}")
            want = mm.samd_matmul_plain(x, w.packed, w.scale, k, w.cfg)
            errs[k, n, m] = max_err(got, want, BF16_TOL)
            rms[k, n, m] = rel_rms(got, want)
            if rms[k, n, m] > BF16_RMS_TOL:
                raise AssertionError(f"K={k} N={n} M={m}: relative RMS "
                                     f"{rms[k, n, m]:.4g}")
    log("  samd_matmul at the run's (K, N, M), its own weights: max |kernel "
        "- plain| = " + json.dumps({str(key): e for key, e in errs.items()})
        + "; relative RMS = " + json.dumps(
            {str(key): round(r, 7) for key, r in rms.items()}))
    return errs


class DequantProbe:
    """CUDA events around each decode step of ``eng`` and around every
    ``layers.materialize`` call inside one (the experts' dequantize in
    ``moe_block``): the dequantize share of a decode tick's device
    time. ``close()`` restores both."""

    def __init__(self, eng):
        from repro_torch.models import layers

        self.ticks, self._eng, self._layers = [], eng, layers
        self._materialize, self._step = layers.materialize, eng._decode_step
        current = []

        def events():
            return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        def timed_materialize(w, dtype=torch.bfloat16):
            if not current:
                return self._materialize(w, dtype)
            a, b = events()
            a.record()
            out = self._materialize(w, dtype)
            b.record()
            current[-1].append((a, b))
            return out

        def timed_step(*args):
            a, b = events()
            current.append([])
            a.record()
            out = self._step(*args)
            b.record()
            self.ticks.append((a, b, current.pop()))
            return out

        layers.materialize = timed_materialize
        eng._decode_step = timed_step

    def close(self):
        self._layers.materialize = self._materialize
        self._eng._decode_step = self._step

    def summary(self):
        torch.cuda.synchronize()
        tick = [a.elapsed_time(b) for a, b, _ in self.ticks]
        deq = [sum(x.elapsed_time(y) for x, y in spans)
               for _, _, spans in self.ticks]
        return dict(
            decode_steps=len(tick),
            materialize_calls_per_step=len(self.ticks[0][2]),
            step_device_ms_median=round(float(np.median(tick)), 3),
            dequant_ms_median=round(float(np.median(deq)), 3),
            dequant_share=round(sum(deq) / sum(tick), 4))


def routes(eng, toks, dev, context):
    """Each MoE layer's (router probabilities, chosen experts) of a full
    forward of ``toks`` under ``context``."""
    from repro_torch.models import layers
    from repro_torch.models.model import forward

    rec, orig = [], layers.top_k_lower_first

    def record(probs, k):
        vals, idx = orig(probs, k)
        rec.append((probs.float(), idx))
        return vals, idx

    layers.top_k_lower_first = record
    try:
        with context():
            forward(eng.params, torch.from_numpy(toks[None]).long().to(dev),
                    eng.cfg)
    finally:
        layers.top_k_lower_first = orig
    return rec


def router_near_tie(eng, toks, dev):
    """The router's counterpart of the logit near-tie: over every layer
    of a full forward of ``toks`` through the kernels and through the
    plain versions, the tokens whose expert SETS differ; the largest of
    their k-th / (k+1)-th probability margins over the token's largest
    probability, if every one is under MODEL_TOL, else None (no set
    differs, or one differs at a clear margin)."""
    k = eng.cfg.top_k
    worst = []
    for (pk, ik), (_, ip) in zip(
            routes(eng, toks, dev, contextlib.nullcontext),
            routes(eng, toks, dev, plain_versions)):
        differ = (ik.sort(-1).values != ip.sort(-1).values).any(-1)
        if differ.any():
            srt = pk[differ].sort(-1, descending=True).values
            worst.append(((srt[:, k - 1] - srt[:, k]) / srt[:, 0])
                         .max().item())
    if not worst or max(worst) > MODEL_TOL:
        return None
    return max(worst)


@contextlib.contextmanager
def regrouped_plain():
    """The plain versions with the matmul's f32 sums regrouped (K blocks
    of 32 words instead of 128): a control that moves nothing but where
    f32 rounds, so what it does to the logits is the model's own
    sensitivity to rounding."""
    from repro_torch.kernels import samd_matmul as mm

    plain = mm.samd_matmul_plain
    mm.samd_matmul_plain = functools.partial(plain, block_kw=32)
    try:
        with plain_versions():
            yield
    finally:
        mm.samd_matmul_plain = plain


def teacher_forced(eng, dev, toks):
    """Every block of a full forward of ``toks`` (no cache) through the
    kernels on the plain versions' own input to it: the plain run
    records each block's input and output; the kernels' run computes
    each block on the recorded input and passes the recorded output on,
    so no block inherits another's rounding. Returns ([(block, kernels'
    output, plain output)], kernels' logits, plain logits); the logits
    differ only in the LM head."""
    from repro_torch.models import layers, ssm
    from repro_torch.models.model import forward

    sites = [(ssm, "rwkv6_time_mix"), (ssm, "rwkv6_channel_mix"),
             (ssm, "mamba2_block"), (layers, "attention_block"),
             (layers, "mlp_block"), (layers, "moe_block")]
    saved = {(mod, name): getattr(mod, name) for mod, name in sites}
    plain_io, kern_out = [], []

    def run(record, context):
        for (mod, name), fn in saved.items():
            def wrapped(p, x, *args, _fn=fn, _name=name, **kw):
                if record:
                    out = _fn(p, x, *args, **kw)
                    plain_io.append((_name, x, out))
                    return out
                name_i, x_i, out_i = plain_io[len(kern_out)]
                assert name_i == _name, (name_i, _name)
                kern_out.append(_fn(p, x_i, *args, **kw))
                return out_i
            setattr(mod, name, wrapped)
        try:
            with context():
                return forward(eng.params, toks, eng.cfg).float()
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)

    want = run(True, plain_versions)
    got = run(False, contextlib.nullcontext)
    if len(kern_out) != len(plain_io):
        raise AssertionError("the two runs called different blocks")

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    blocks = [(name, first(k), first(out))
              for (name, _, out), k in zip(plain_io, kern_out)]
    return blocks, got, want


def check_ring_model_against_plain(eng, dev):
    """The ring families' logits through the kernels and through the
    plain versions, both on the card.

    Free-running: per-row prefills of 24 and 19 tokens into a fresh
    ``init_cache`` (as the engine admits), then one decode token a row
    at its own position; beside it the same through ``regrouped_plain``
    (the control). Random-weight recurrent stacks amplify a one-step
    bf16 rounding difference with depth (PERF.md section 6), so the
    kernels must agree within ``max(MODEL_TOL, 2 x the control's
    error)`` of the scale. Teacher-forced: every block on the plain
    versions' own input (``teacher_forced``), each within MODEL_TOL of
    its output's scale, and the logits through the LM head likewise.
    Returns a dict of the errors (over the scale) and ``tol``, the
    near-tie tolerance the greedy check uses."""
    from repro_torch.models.model import forward, init_cache
    from repro_torch.serving.engine import _row_views

    cfg = eng.cfg
    rng = np.random.default_rng(7)
    lens = (24, 19)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 24))).to(dev)
    dec = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 1))).to(dev)
    pos = torch.tensor(lens, device=dev)

    def logits(context):
        cache = init_cache(cfg, 2, 32, device=dev)
        with context():
            pre = [forward(eng.params, toks[i:i + 1, :n], cfg,
                           cache=_row_views(cache, i), cache_index=0)[0]
                   for i, n in enumerate(lens)]
            nxt = forward(eng.params, dec, cfg, positions=pos[:, None],
                          cache=cache, cache_index=pos)
        return torch.cat(pre).float(), nxt.float()

    got = logits(contextlib.nullcontext)
    want = logits(plain_versions)
    control = logits(regrouped_plain)
    if got[1].shape != (2, 1, cfg.vocab):
        raise AssertionError(f"logits shape {tuple(got[1].shape)}")
    scale = want[0].abs().max().item()

    def rel(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b)) / scale

    control_err = rel(control, want)
    tol = max(MODEL_TOL, 2 * control_err)
    errs = [max_err(a, b, tol) / scale for a, b in zip(got, want)]
    blocks, tf_got, tf_want = teacher_forced(eng, dev, toks[:1])
    worst = collections.defaultdict(float)
    for name, k_out, p_out in blocks:
        e = max_err(k_out, p_out, MODEL_TOL) / p_out.abs().max().item()
        worst[name] = max(worst[name], e)
    tf_logits = max_err(tf_got, tf_want, MODEL_TOL) / scale
    out = dict(prefill=errs[0], decode=errs[1], control=control_err,
               tol=tol, blocks=len(blocks), block_worst=dict(worst),
               teacher_forced_logits=tf_logits)
    log(f"  full-width logits ({cfg.name}, {cfg.n_layers} layers, ring and "
        f"recurrent state), kernels vs plain on the card, max err over the "
        f"scale {scale:.4g}: prefill {errs[0]:.4g}, decode {errs[1]:.4g}; "
        f"the regrouped-sum control {control_err:.4g}, so the limit is "
        f"{tol:.4g}; teacher-forced, each of {len(blocks)} blocks within "
        f"{MODEL_TOL} (worst by kind {json.dumps(worst)}), the logits "
        f"{tf_logits:.4g}")
    return out


def serve_family(dev, timer, gen, launch_log, cfg, expect, prefill_m):
    """(i) one full-width family run: ``cfg`` 4-bit with its LM head
    packed serves (c)'s 16 requests (``expect``: the launchers it must
    launch, and no other); its logits against the plain versions on the
    card; the same engine then serves the same requests with the plain
    versions (``reset()`` between) and the kernels' greedy tokens must
    equal those or part at a near-tie (logit or router); (b)'s checks
    and (d)'s device times at its (K, N) on its own weights, at decode
    (M = 8) and at ``prefill_m`` rows, its LM head, and (olmoe) decode
    attention. Returns (summary, counts, LM-head launches, errs,
    timings)."""
    from repro_torch.quant.config import QuantConfig

    probe = []
    before = launch_log.matmul()
    eng, summary, counts = serve(
        f"{cfg.name} ({cfg.n_layers} layers), 4-bit, LM head packed",
        dev, expect, arch=cfg,
        quant=QuantConfig(bits=4, quantize_embeddings=True),
        on_engine=(lambda e: probe.append(DequantProbe(e)))
        if cfg.family == "moe" else None)
    shapes = launch_log.matmul() - before
    stats, kern_done = dict(eng.stats), list(eng.finished)
    if probe:
        probe[0].close()
        summary["dequant"] = probe[0].summary()
    summary["kv_mode"] = eng.kv_mode
    summary["stats"] = {k: stats[k] for k in (
        "decode_steps", "prefill_calls", "per_row_prefill_calls",
        "per_row_forward_calls")}
    if eng.kv_mode == "ring" and stats["per_row_forward_calls"]:
        raise AssertionError(f"{cfg.name}: per-row forwards on the ring")
    head_n = sum(c for key, c in shapes.items()
                 if key[0] == SPLITK and key[2] == cfg.vocab)
    if not head_n:
        raise AssertionError(f"{cfg.name}: the LM head never ran split-K")
    if eng.kv_mode == "paged":
        pre, dec, scale, _ = check_model_against_plain(eng, dev,
                                                       plain_on_card=True)
        summary["model_errs"] = dict(prefill=pre / scale,
                                     decode=dec / scale)
        tol = MODEL_TOL
    else:
        summary["model_errs"] = check_ring_model_against_plain(eng, dev)
        tol = summary["model_errs"]["tol"]
    eng.reset()
    with plain_versions():
        for r in workload(1, vocab=cfg.vocab):
            eng.submit(r)
        plain_done = eng.run_to_completion()
    if any(r.error or r.truncated or len(r.generated) != MAX_TOKENS
           for r in plain_done):
        raise AssertionError(f"{cfg.name}: the plain run fell short")
    summary["identical"] = check_greedy(
        eng, plain_done, dev, reqs=kern_done,
        against="the plain versions' run on the card", tol=tol)
    log(f"  {cfg.name} serving: " + json.dumps(summary))
    groups = packed_linears(eng.params)
    errs = check_linears(dev, gen, groups, (eng.max_batch, prefill_m))
    body = [(f"K={k} N={n}", ws) for (k, n), ws in groups.items()
            if n != cfg.vocab]
    t = dict(
        decode=time_samd_matmul(dev, timer, None,
                                f"{cfg.name} decode, M={eng.max_batch}",
                                eng.max_batch, linears=body),
        head=time_lm_head(dev, timer, eng.params["lm_head"],
                          eng.max_batch, cfg.name),
        prefill=time_samd_matmul(dev, timer, None,
                                 f"{cfg.name} prefill, M={prefill_m}",
                                 prefill_m, linears=body))
    if DECODE in expect:
        t["attention"] = time_paged_attention(eng, dev, timer, False, gen)
    del eng
    torch.cuda.empty_cache()
    return summary, counts, head_n, errs, t


def family_entries(cfg, counts, head_n, errs, t, attn_err, prefill_m):
    """The kernels line's entries of one (i) run."""
    tag = f"{cfg.name}, {cfg.n_layers} layers"
    mm_src = "src/repro/kernels/samd_matmul.py:123"
    body_errs = [e for (k, n, m), e in errs.items() if n != cfg.vocab]
    out = [
        kernel_entry(
            f"samd_matmul split-K ({tag}, decode linears, M=8)", MM_SOURCE,
            mm_src, counts[SPLITK] - head_n,
            max(e for (k, n, m), e in errs.items()
                if n != cfg.vocab and m == 8), t["decode"],
            f"(i) 4-bit, mean per launch over the distinct (K, N) of the "
            f"layers' linears; device times"),
        kernel_entry(
            f"samd_matmul split-K ({tag}, LM head, M=8)", MM_SOURCE, mm_src,
            head_n, errs[cfg.d_model, cfg.vocab, 8], t["head"],
            f"(i) K={cfg.d_model} N={cfg.vocab}, 4-bit "
            "(quantize_embeddings); device times"),
        kernel_entry(
            f"samd_matmul tile ({tag}, prefill)", MM_SOURCE, mm_src,
            counts[TILE], max(body_errs + [errs[cfg.d_model, cfg.vocab,
                                                prefill_m]]),
            t["prefill"], f"(i) prefills, the LM head's included; numbers "
            f"of M={prefill_m} over the distinct (K, N) of the layers"),
    ]
    if attn_err is not None:
        out.append(kernel_entry(
            f"paged_decode_attention ({tag}, bf16 KV)", PA_SOURCE,
            "src/repro/kernels/paged_attention.py:294", counts[DECODE],
            attn_err, t["attention"],
            f"(i) decode B=8 H=Hkv={cfg.n_kv_heads} G=1 dh={cfg.head_dim} "
            "ps=16 n_pp=32, per layer of the run's pools; device times"))
    return out


# -- (j) training ------------------------------------------------------------

def to_device(tree, dev):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(dev), tree)


def train_batch(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train_run(cfg, params, dev, steps, batch, seq, lr, warmup, seed=0):
    """``steps`` steps of ``launch.steps.make_train_step`` on
    SyntheticLM(seed) batches. Returns (params, [(loss, grad_norm, lr, ms
    of the step, synchronized)])."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import adamw_init

    run = RunConfig(arch=cfg, shape=ShapeConfig("train", seq, batch,
                                                "train"),
                    learning_rate=lr, lr_warmup=warmup)
    step = steps_mod.make_train_step(cfg, run)
    data = SyntheticLM(cfg.vocab, seq, batch, seed=seed)
    opt = adamw_init(params)
    rows = []
    for _ in range(steps):
        b = train_batch(next(data), dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        rows.append((m["loss"].item(), m["grad_norm"].item(),
                     m["lr"].item(), ms))
    return params, rows


def seeded_params(cfg, dev, seed=0):
    from repro_torch.models.model import build_template
    from repro_torch.models.spec import init_from_spec

    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_from_spec(build_template(cfg), gen, device=dev)


def grads_on(cfg, params, batch, dev, **run_kw):
    """(raw loss, gradients) of the port's loss on ``dev``."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch import steps as steps_mod

    b, s = batch["tokens"].shape
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", s, b, "train"),
                    **run_kw)
    return steps_mod.value_and_grad(steps_mod.make_loss_fn(cfg, run),
                                    to_device(params, dev),
                                    train_batch(batch, dev))


def leaf_errs(got, want, tol):
    """{leaf: max |got - want| / max |want|}, raising if one is over
    ``tol``."""
    from repro_torch.tree import named_leaves

    errs = {}
    for (name, g), (_, w) in zip(named_leaves(got), named_leaves(want)):
        g, w = g.float().cpu(), w.float().cpu()
        scale = max(w.abs().max().item(), 1e-30)
        errs[name] = (g - w).abs().max().item() / scale
        if not torch.isfinite(g).all() or errs[name] > tol:
            raise AssertionError(f"gradient {name}: {errs[name]:.4g} of its "
                                 f"scale, limit {tol}")
    return errs


def check_training_numerics(dev):
    """(j2) the full-width model cut to TRAIN_CHECK_LAYERS layers: one
    step's loss, gradient norm and every gradient on the card against the
    port on the CPU (the CPU tests' tolerances); the embedding gradient
    bit-identical over two runs on the card; remat against no remat and
    grad_accum=2 against one batch on the card (the reference's
    tolerances)."""
    from repro_torch.configs.archs import QWEN15_05B
    from repro_torch.data import SyntheticLM
    from repro_torch.optim.adamw import global_norm
    from repro_torch.tree import named_leaves

    cfg = QWEN15_05B.scaled(n_layers=TRAIN_CHECK_LAYERS)
    log(f"  (j2) {cfg.name} at full width (d {cfg.d_model}, vocab "
        f"{cfg.vocab}), depth cut {QWEN15_05B.n_layers} -> {cfg.n_layers} "
        f"layers; batch {TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SEQ}")
    params = seeded_params(cfg, "cpu", seed=1)
    batch = next(SyntheticLM(cfg.vocab, TRAIN_CHECK_SEQ, TRAIN_CHECK_BATCH,
                             seed=1))
    loss_c, g_c = grads_on(cfg, params, batch, "cpu")
    loss_d, g_d = grads_on(cfg, params, batch, dev)
    loss_d2, g_d2 = grads_on(cfg, params, batch, dev)
    emb = [dict(named_leaves(g))["embed"] for g in (g_d, g_d2)]
    if not torch.equal(emb[0], emb[1]) or loss_d.item() != loss_d2.item():
        raise AssertionError("the embedding gradient (or the loss) differs "
                             "between two runs on the card")
    gn_c, gn_d = global_norm(g_c).item(), global_norm(g_d).item()
    loss_rel = abs(loss_d.item() - loss_c.item()) / abs(loss_c.item())
    gn_rel = abs(gn_d - gn_c) / gn_c
    if loss_rel > TRAIN_LOSS_TOL or gn_rel > TRAIN_GNORM_TOL:
        raise AssertionError(f"card vs CPU: loss {loss_rel:.3g}, grad norm "
                             f"{gn_rel:.3g} relative")
    errs = leaf_errs(g_d, g_c, TRAIN_GRAD_TOL)
    worst = max(errs, key=errs.get)
    out = dict(loss_cpu=loss_c.item(), loss_card=loss_d.item(),
               loss_rel=loss_rel, grad_norm_cpu=gn_c, grad_norm_card=gn_d,
               grad_norm_rel=gn_rel, worst_grad_leaf=worst,
               worst_grad_rel=errs[worst], embed_grad_deterministic=True)
    # remat against no remat, on the card
    loss_r, g_r = grads_on(cfg, params, batch, dev, remat="block")
    if abs(loss_r.item() - loss_d.item()) >= 1e-4:
        raise AssertionError("remat changed the loss")
    remat_err = 0.0
    for (name, a), (_, b) in zip(named_leaves(g_d), named_leaves(g_r)):
        err = (a.float() - b.float()).abs().max().item()
        if err > max(1e-3, 2.0 ** -7 * a.float().abs().max().item()):
            raise AssertionError(f"remat gradient {name}: {err:.4g}")
        remat_err = max(remat_err, err)
    out.update(remat_max_grad_err=remat_err,
               remat_bit_identical=all(torch.equal(a, b) for (_, a), (_, b)
                                       in zip(named_leaves(g_d),
                                              named_leaves(g_r))))
    # grad_accum=2 against one batch of twice the rows, one step
    out.update(accum_against_full_batch(cfg, params, dev))
    log("  (j2) card vs CPU, remat, accumulation: " + json.dumps(out))
    return out


def accum_against_full_batch(cfg, params, dev):
    """One train step with grad_accum=2 against grad_accum=1 on the same
    batch, on the card: loss within 2e-2 relative, every parameter within
    5e-2 (tests/test_models.py's bounds)."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import adamw_init
    from repro_torch.tree import named_leaves

    b, s = 2 * TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ
    batch = train_batch(next(SyntheticLM(cfg.vocab, s, b, seed=2)), dev)
    p = to_device(params, dev)
    outs = []
    for accum in (1, 2):
        run = RunConfig(arch=cfg, shape=ShapeConfig("t", s, b, "train"),
                        grad_accum=accum, learning_rate=TRAIN_LR,
                        lr_warmup=TRAIN_WARMUP)
        outs.append(steps_mod.make_train_step(cfg, run)(
            p, adamw_init(p), batch))
    (p1, _, m1), (p2, _, m2) = outs
    l1, l2 = m1["loss"].item(), m2["loss"].item()
    diff = max((a.float() - c.float()).abs().max().item()
               for (_, a), (_, c) in zip(named_leaves(p1), named_leaves(p2)))
    if abs(l1 - l2) >= 2e-2 * abs(l1) or diff >= 5e-2:
        raise AssertionError(f"grad_accum=2: loss {l2} vs {l1}, params "
                             f"{diff:.4g} apart")
    return dict(accum_loss=l2, full_batch_loss=l1, accum_max_param_diff=diff)


def check_checkpoint_resume(dev):
    """(j3) ``launch.train.main`` at full width: a run saved at step 3 and
    resumed to step 6 against 6 uninterrupted steps (the reference
    test's 5e-2 on every parameter; the maximum difference printed), and
    the checkpoint's leaf names and dtypes against the reference's
    layout (stacked blocks: qwen1.5-0.5b has ``scan_layers``)."""
    import shutil

    from repro_torch.configs.archs import QWEN15_05B
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.model import build_template
    from repro_torch.tree import named_leaves

    ck = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(ck, ignore_errors=True)
    args = ["--arch", QWEN15_05B.name, "--batch", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--log-every", "1"]
    t0 = time.perf_counter()
    full = train_main(args + ["--steps", "6"], device=dev)
    train_main(args + ["--steps", "3", "--checkpoint-dir", str(ck),
                       "--checkpoint-every", "3"], device=dev)
    with open(ck / "ckpt_00000003" / "manifest.json") as f:
        manifest = json.load(f)
    resumed = train_main(args + ["--steps", "6", "--checkpoint-dir",
                                 str(ck), "--resume"], device=dev)
    wall = time.perf_counter() - t0
    diff = max((a.float() - b.float()).abs().max().item()
               for (_, a), (_, b) in zip(named_leaves(full),
                                         named_leaves(resumed)))
    identical = all(torch.equal(a, b) for (_, a), (_, b) in
                    zip(named_leaves(full), named_leaves(resumed)))
    if diff >= 5e-2:
        raise AssertionError(f"resumed run {diff:.4g} from the full run")
    tmpl = named_leaves(build_template(QWEN15_05B, stacked=True))
    names = ["opt/0"] + [f"opt/{i}/{n}" for i in (1, 2) for n, _ in tmpl]
    names += [f"params/{n}" for n, _ in tmpl]
    want_dtypes = {f"params/{n}": "bfloat16" for n, sp in tmpl
                   if sp.dtype == torch.bfloat16}
    if (sorted(manifest["leaves"]) != sorted(names)
            or manifest["dtypes"] != want_dtypes or manifest["step"] != 3):
        raise AssertionError("checkpoint leaves or dtypes are not the "
                             "reference's")
    n_bytes = sum(p.stat().st_size for p in (ck / "ckpt_00000003").iterdir())
    shutil.rmtree(ck, ignore_errors=True)
    out = dict(resume_max_param_diff=diff, resume_bit_identical=identical,
               checkpoint_leaves=len(names), checkpoint_gib=round(
                   n_bytes / 2**30, 3), wall_s=round(wall, 1))
    log("  (j3) checkpoint at step 3, resume to 6: " + json.dumps(out))
    return out


def argmax_agreement(cfg, params, dev, tokens):
    """{bits: share of positions whose argmax the SAMD-packed model
    (``quantize_params``) gives as the bf16 model does} for 8 and 4 bits,
    forward on ``dev``, and the launches the packed forwards made."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_template, forward
    from repro_torch.models.quantize import quantize_params
    from repro_torch.quant.config import QuantConfig

    out = {}
    before = ops.launch_counts()
    with torch.no_grad():
        pred = forward(params, tokens, cfg).float().argmax(-1)
        for bits in (8, 4):
            q = quantize_params(params, build_template(cfg),
                                QuantConfig(bits=bits))
            pred_q = forward(q, tokens, cfg).float().argmax(-1)
            out[bits] = (pred == pred_q).float().mean().item()
    after = ops.launch_counts()
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}


def run_training(dev, card):
    """Phase (j): train full-width qwen1.5-0.5b, check the step's
    numerics, checkpoint and resume, then serve what was trained
    through the kernels. Returns (summary, the trained-serve run's
    launch counts)."""
    from repro_torch.configs.archs import QWEN15_05B, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.analytic_costs import cell_cost
    from repro_torch.quant.config import QuantConfig

    cfg = QWEN15_05B
    t_phase = time.perf_counter()
    params = seeded_params(cfg, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    params, rows = train_run(cfg, params, dev, TRAIN_STEPS, TRAIN_BATCH,
                             TRAIN_SEQ, TRAIN_LR, TRAIN_WARMUP)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [r[0] for r in rows]
    if not all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in rows):
        raise AssertionError(f"non-finite loss or grad norm: {rows}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"the loss did not fall: {losses}")
    if any(counts.values()):
        raise AssertionError(f"a SAMD kernel launched in training: {counts}")
    # the first step builds cuBLAS handles and workspaces: the median
    # is over the steady steps
    ms = float(np.median([r[3] for r in rows[1:]]))
    flops = cell_cost(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                       "train")).flops
    train = dict(
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
        step_ms_median=ms, first_step_ms=rows[0][3],
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
        model_flops_per_step=flops, mfu=flops / (ms / 1e3) / BF16_OPS_PER_S,
        peak_mem_gib=round(peak / 2**30, 3), losses=losses,
        grad_norms=[r[1] for r in rows], lrs=[r[2] for r in rows],
        first5_mean=float(np.mean(losses[:5])),
        last5_mean=float(np.mean(losses[-5:])), launches=counts,
        card=card)
    log("  (j1) train: " + json.dumps(train))
    numerics = check_training_numerics(dev)
    resume = check_checkpoint_resume(dev)

    # (j4) serve the 20-step weights 4-bit through the kernels
    eng, served, s_counts = serve(
        "(j4) trained 4-bit, bf16 KV", dev, {SPLITK, TILE, DECODE},
        n=TRAIN_SERVE_REQUESTS, params=params, quant=QuantConfig(bits=4))
    kern_done = list(eng.finished)
    eng.reset()
    with plain_versions():
        for r in workload(1, TRAIN_SERVE_REQUESTS, MAX_TOKENS, cfg.vocab):
            eng.submit(r)
        plain_done = eng.run_to_completion()
    if any(r.error or r.truncated or len(r.generated) != MAX_TOKENS
           for r in plain_done):
        raise AssertionError("(j4) the plain run fell short")
    identical = check_greedy(eng, plain_done, dev, reqs=kern_done,
                             against="the plain versions' run on the card")
    data = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    data.seek(TRAIN_STEPS)
    held_out = train_batch(next(data), dev)["tokens"][:2]
    full_agree, full_launches = argmax_agreement(cfg, params, dev, held_out)
    del eng
    # (j5) tests/test_system.py's config trained 40 steps on the card
    small = smoke_config("qwen1.5-0.5b").scaled(**SYSTEM_CONFIG)
    sp, srows = train_run(small, seeded_params(small, dev), dev,
                          SYSTEM_STEPS, 8, 64, 1e-3, 10)
    data = SyntheticLM(small.vocab, 64, 8, seed=0)
    data.seek(SYSTEM_STEPS)
    agree, small_launches = argmax_agreement(
        small, sp, dev, train_batch(next(data), dev)["tokens"])
    if agree[8] < 0.9 or agree[4] < 0.6:
        raise AssertionError(f"argmax agreement {agree}")
    out = dict(train=train, numerics=numerics, resume=resume,
               serve=dict(served, greedy_identical=identical,
                          requests=TRAIN_SERVE_REQUESTS),
               full_width_argmax_agreement=full_agree,
               full_width_agreement_launches=full_launches,
               system_config_argmax_agreement=agree,
               system_config_launches=small_launches,
               system_config_losses=[r[0] for r in srows],
               phase_s=round(time.perf_counter() - t_phase, 1))
    log("  (j) " + json.dumps({k: v for k, v in out.items()
                               if k not in ("train", "numerics", "resume",
                                            "serve")}))
    return out, s_counts


# -- (k) the paper's 64-bit SAMD words ---------------------------------------

def conv_direct_f64(x, k):
    """The full convolution of integer x [..., n] with k [..., taps] in
    float64 on x's device (exact: every sum here is far below 2^53)."""
    n, taps = x.shape[-1], k.shape[-1]
    out = torch.zeros(x.shape[:-1] + (n + taps - 1,), dtype=torch.float64,
                      device=x.device)
    for j in range(taps):
        out[..., j:j + n] += k[..., j:j + 1].double() * x.double()
    return out


def same_on_cpu(fn, *args):
    """``fn`` on the card's ``args`` and on their CPU copies: every output
    (a tensor or a tuple of them) bit-identical. Returns the card's."""
    got = fn(*args)
    want = fn(*[a.cpu() if isinstance(a, torch.Tensor) else a
                for a in args])
    for g, w in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (got, want))):
        if g.dtype != w.dtype or not torch.equal(g.cpu(), w):
            raise AssertionError(f"{getattr(fn, '__name__', fn)}: the card "
                                 "and the CPU differ")
    return got


def words_pair_ms(timer, fn64, fn32):
    """Device ms of one call at 64-bit and at 32-bit words (CUDA events),
    in turns 64, 32, 32, 64; each the mean of its two runs."""
    t = {64: [], 32: []}
    for wb in (64, 32, 32, 64):
        t[wb].append(timer(fn64 if wb == 64 else fn32,
                           iters=WORDS64_ITERS, warmup=1))
    return {"ms_64": float(np.mean(t[64])), "ms_32": float(np.mean(t[32]))}


def run_words64(dev, timer, results):
    """Phase (k): the 64-bit words (int64 tensors holding uint64 bits) on
    the card. (k1) samd_conv_full at word_bits=64 on (f)'s five signals
    against (f)'s 32-bit samd_conv1d kernel outputs and a float64
    convolution; (k2) samd_conv_multichannel at word_bits=64 on 64
    channels x 50,176 positions with lanes from plan_for_kernel, against
    the exact channel sum, and samd_conv_grouped at 32-bit words where a
    32-bit word cannot hold the plan; (k3) conv_by_scale,
    samd_conv_grouped and the codegen add / sub / mul at 64 against 32
    bits. A slice of each 64-bit result (and of the chunk products'
    (hi, lo) words) is recomputed on the CPU. No SAMD kernel launches."""
    from repro_torch.core import codegen, conv, overflow, samd
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    out = {"full": [], "multichannel": [], "conv_by_scale": [],
           "grouped": [], "pointwise": []}
    s = CPU_SLICE
    for (bits, signed, dtype), (x, k, out32) in results.items():
        x, k, out32 = x.to(dev).long(), k.to(dev), out32.to(dev)
        plan64 = conv.make_plan(bits, CONV1D_TAPS, signed, word_bits=64)
        plan32 = conv.make_plan(bits, CONV1D_TAPS, signed)
        got = conv.samd_conv_full(x, k, plan64)
        if not (got.dtype == torch.int32 and torch.equal(got, out32)
                and torch.equal(got.double(), conv_direct_f64(x, k))):
            raise AssertionError(f"(k1) {bits}-bit signed={signed}: the "
                                 "64-bit words differ")
        xw = conv.pack_conv_operand(x[:s], plan64)
        kw = conv.pack_conv_kernel(k, plan64)
        same_on_cpu(conv.chunk_products, xw, kw, plan64)
        if not torch.equal(same_on_cpu(conv.samd_conv_full, x[:s], k,
                                       plan64)[:s], got[:s]):
            raise AssertionError("(k1) the CPU's slice differs")
        out["full"].append(dict(
            bits=bits, signed=signed, x_dtype_in_f=str(dtype)[6:],
            lane_width=plan64.fmt.lane_width,
            lanes_per_word_64=plan64.lanes_per_chunk,
            lanes_per_word_32=plan32.lanes_per_chunk, values=x.numel(),
            bit_identical_to_f_kernel=True, **words_pair_ms(
                timer, lambda: conv.samd_conv_full(x, k, plan64),
                lambda: conv.samd_conv_full(x, k, plan32))))
    gen = torch.Generator(device=dev).manual_seed(22)
    c, n = WORDS64_CHANNELS, WORDS64_POSITIONS
    for bits in WORDS64_BITS:
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        x = torch.randint(lo, hi + 1, (c, n), generator=gen, device=dev)
        k = torch.randint(lo, hi + 1, (c, CONV1D_TAPS), generator=gen,
                          device=dev)
        kn = k.cpu().numpy()
        plan = overflow.plan_for_kernel(kn, bits, True, bits, word_bits=64)
        try:
            overflow.plan_for_kernel(kn, bits, True, bits, word_bits=32)
            fits32 = "yes"
        except ValueError as e:
            fits32 = f"no: {e}"
        got = conv.samd_conv_multichannel(x, k, plan)
        want = conv_direct_f64(x, k).sum(0)
        grouped = conv.samd_conv_grouped(x, k, bits, word_bits=32)
        if not (torch.equal(got.double(), want)
                and torch.equal(grouped, got)):
            raise AssertionError(f"(k2) {bits}-bit: the channel sum differs")
        if not torch.equal(same_on_cpu(conv.samd_conv_multichannel,
                                       x[:, :s], k, plan)[:s], got[:s]):
            raise AssertionError("(k2) the CPU's slice differs")
        t = words_pair_ms(
            timer, lambda: conv.samd_conv_multichannel(x, k, plan),
            lambda: conv.samd_conv_grouped(x, k, bits, word_bits=32))
        out["multichannel"].append(dict(
            bits=bits, channels=c, positions=n, lane_width=plan.fmt.lane_width,
            lanes_per_word_64=plan.lanes_per_chunk, fits_32_bit_word=fits32,
            ms_64_multichannel=t["ms_64"], ms_32_grouped=t["ms_32"]))
    for bits in (4, 8):
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        x = torch.randint(lo, hi + 1, (WORDS64_N,), generator=gen, device=dev)
        k = torch.randint(lo, hi + 1, (CONV1D_TAPS,), generator=gen,
                          device=dev)
        got = conv.conv_by_scale(x, k, bits, True, word_bits=64)
        if not torch.equal(got, conv.conv_by_scale(x, k, bits, True)):
            raise AssertionError(f"(k3) conv_by_scale {bits}-bit differs")
        if not torch.equal(same_on_cpu(conv.conv_by_scale, x[:s], k, bits,
                                       True, 64)[:s], got[:s]):
            raise AssertionError("(k3) the CPU's slice differs")
        out["conv_by_scale"].append(dict(bits=bits, values=WORDS64_N,
                                         **words_pair_ms(
            timer, lambda: conv.conv_by_scale(x, k, bits, True, word_bits=64),
            lambda: conv.conv_by_scale(x, k, bits, True))))
    for bits in WORDS64_BITS:
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        x = torch.randint(lo, hi + 1, (c, WORDS64_N // c), generator=gen,
                          device=dev)
        k = torch.randint(lo, hi + 1, (c, CONV1D_TAPS), generator=gen,
                          device=dev)
        got = conv.samd_conv_grouped(x, k, bits, word_bits=64)
        if not torch.equal(got, conv.samd_conv_grouped(x, k, bits)):
            raise AssertionError(f"(k3) samd_conv_grouped {bits}-bit differs")
        if not torch.equal(same_on_cpu(conv.samd_conv_grouped, x[:, :s], k,
                                       bits, 64)[:s], got[:s]):
            raise AssertionError("(k3) the CPU's slice differs")
        out["grouped"].append(dict(bits=bits, channels=c, values=WORDS64_N,
                                   **words_pair_ms(
            timer, lambda: conv.samd_conv_grouped(x, k, bits, word_bits=64),
            lambda: conv.samd_conv_grouped(x, k, bits))))
    for bits in WORDS64_POINTWISE_BITS:
        for regime in ("temporary", "permanent"):
            ops64 = codegen.generate_pointwise(bits, regime, True, 64)
            ops32 = codegen.generate_pointwise(bits, regime, True, 32)
            f64, f32 = ops64["add"].fmt, ops32["add"].fmt
            nv = WORDS64_N * f64.lanes_per_word
            lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
            a, b = (torch.randint(lo, hi + 1, (nv,), generator=gen,
                                  device=dev) for _ in range(2))
            w64 = samd.pack(a, f64), samd.pack(b, f64)
            w32 = samd.pack(a, f32), samd.pack(b, f32)
            for name in ("add", "sub", "mul"):
                fn64, fn32 = ops64[name].fn, ops32[name].fn
                r64 = fn64(*w64)
                if not torch.equal(samd.unpack(r64, f64, nv),
                                   samd.unpack(fn32(*w32), f32, nv)):
                    raise AssertionError(f"(k3) {name} {bits}-bit {regime}: "
                                         "64- and 32-bit lanes differ")
                if not torch.equal(same_on_cpu(fn64, w64[0][:s],
                                               w64[1][:s]), r64[:s]):
                    raise AssertionError("(k3) the CPU's slice differs")
                out["pointwise"].append(dict(
                    op=name, bits=bits, regime=regime, words_64=WORDS64_N,
                    lanes_per_word_64=f64.lanes_per_word,
                    lanes_per_word_32=f32.lanes_per_word,
                    **words_pair_ms(timer, lambda: fn64(*w64),
                                    lambda: fn32(*w32))))
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"(k) launched a SAMD kernel: {counts}")
    out["phase_s"] = round(time.perf_counter() - t_phase, 1)
    for key in ("full", "multichannel", "conv_by_scale", "grouped"):
        log(f"  (k) {key}: " + json.dumps(out[key]))
    log("  (k) codegen add / sub / mul, 2^20 words: " + json.dumps(
        out["pointwise"]))
    return out


# -- (l) distribution on one card ---------------------------------------------

def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def full_tree(tree):
    """A tree of DTensors gathered whole (for the comparison after a
    step, never inside one)."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.full_tensor(), tree)


def run_distributed(dev):
    """Phase (l): an NCCL process group of world size 1 and a (1, 1)
    ("data", "model") DeviceMesh on the card. (l1) DIST_STEPS AdamW steps
    of (j1)'s full-width qwen1.5-0.5b (its seeded weights and SyntheticLM
    batches) with parameters, moments and batch as DTensors placed by the
    sharding rules, against the plain step: loss, gradient norm and every
    parameter within (j2)'s tolerances, every leaf on its placements;
    (l2) compressed_psum at 8 and 4 bits on 2^24 floats against
    dequantize(quantize(x)); (l3) the sharded weights saved, and restored
    with ``shardings=``. One card moves no bytes between ranks; the
    collectives' counts are printed."""
    import shutil

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs.archs import QWEN15_05B
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import build_template
    from repro_torch.optim import adamw_init
    from repro_torch.tree import named_leaves

    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = make_test_mesh(1, 1, device="cuda")
        cfg = QWEN15_05B
        tmpl = build_template(cfg)
        run = RunConfig(arch=cfg, shape=ShapeConfig("train", TRAIN_SEQ,
                                                    TRAIN_BATCH, "train"),
                        learning_rate=TRAIN_LR, lr_warmup=TRAIN_WARMUP)
        step = steps_mod.make_train_step(cfg, run)
        data = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
        batches = [train_batch(next(data), dev) for _ in range(DIST_STEPS)]
        params = seeded_params(cfg, dev)
        layouts = sh.placements(sh.param_pspecs(tmpl, mesh), mesh)
        blay = sh.placements(sh.data_pspec(TRAIN_BATCH, mesh), mesh)
        dp = sh.distribute(params, layouts)
        ops.reset_launch_counts()

        def steps_of(p, batches_):
            o, rows = adamw_init(p), []
            for b in batches_:
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                p, o, m = step(p, o, b)
                torch.cuda.synchronize(dev)
                rows.append((m["loss"], m["grad_norm"],
                             (time.perf_counter() - t0) * 1e3))
            return p, o, rows

        want_p, want_o, want_rows = steps_of(params, batches)
        del params, want_o
        db = [{k: sh.distribute(v, blay) for k, v in b.items()}
              for b in batches]
        with CommDebugMode() as comm:
            got_p, got_o, got_rows = steps_of(dp, db)
        del dp
        rows = []
        for (gl, gg, gms), (wl, wg, wms) in zip(got_rows, want_rows):
            gl, gg = gl.full_tensor().item(), gg.full_tensor().item()
            wl, wg = wl.item(), wg.item()
            rows.append(dict(loss=gl, loss_plain=wl, grad_norm=gg,
                             grad_norm_plain=wg, ms=gms, ms_plain=wms))
            if (abs(gl - wl) > TRAIN_LOSS_TOL * abs(wl)
                    or abs(gg - wg) > TRAIN_GNORM_TOL * wg):
                raise AssertionError(f"(l1) loss {gl} / {wl}, grad norm "
                                     f"{gg} / {wg}")
        for tree in (got_p, got_o.m, got_o.v):
            for (name, t), (_, lay) in zip(named_leaves(tree),
                                           named_leaves(layouts)):
                if not (isinstance(t, DTensor)
                        and t.placements == lay.placements):
                    raise AssertionError(f"(l1) {name} left its placements")
        full_p = full_tree(got_p)
        errs = leaf_errs(full_p, want_p, TRAIN_GRAD_TOL)
        identical = all(torch.equal(a, b) for (_, a), (_, b) in
                        zip(named_leaves(full_p), named_leaves(want_p)))
        worst = max(errs, key=errs.get)
        counts = ops.launch_counts()
        if any(counts.values()):
            raise AssertionError(f"(l1) a SAMD kernel launched: {counts}")
        collectives = {str(k).split(".")[-1]: v
                       for k, v in comm.get_comm_counts().items()}
        out = dict(mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                   backend=dist.get_backend(), steps=rows,
                   worst_param_leaf=worst, worst_param_rel=errs[worst],
                   params_bit_identical=identical,
                   collectives=collectives,
                   collectives_total=comm.get_total_counts())
        log("  (l1) sharded train steps: " + json.dumps(out))
        del full_p, want_p, got_o

        gen = torch.Generator(device=dev).manual_seed(23)
        x = torch.randn(PSUM_N, generator=gen, device=dev)
        psum = {}
        for bits in (8, 4):
            if bits == 8:
                want = comp.dequantize_int8(*comp.quantize_int8(x))
            else:
                q, scale = comp.quantize_int4_packed(x)
                want = comp.dequantize_int4_packed(q, scale, PSUM_N, x.shape)
            got = comp.compressed_psum(x, mesh["data"], bits)
            if not torch.equal(got, want):
                raise AssertionError(f"(l2) compressed_psum {bits}-bit")
            psum[bits] = dict(values=PSUM_N, bit_identical=True,
                              max_abs_quant_err=(want - x).abs().max().item())
        log("  (l2) compressed_psum: " + json.dumps(psum))

        ck = ROOT / "build" / "chip_smoke_sharded_checkpoint"
        shutil.rmtree(ck, ignore_errors=True)
        t0 = time.perf_counter()
        save_checkpoint(str(ck), {"params": got_p}, step=DIST_STEPS)
        restored, at, _ = load_checkpoint(str(ck), {"params": tmpl},
                                          shardings={"params": layouts})
        ck_s = time.perf_counter() - t0
        for (name, t), (_, g), (_, lay) in zip(
                named_leaves(restored["params"]), named_leaves(got_p),
                named_leaves(layouts)):
            if not (at == DIST_STEPS and t.placements == lay.placements
                    and torch.equal(t.full_tensor(), g.full_tensor())):
                raise AssertionError(f"(l3) {name} did not restore")
        n_bytes = sum(f.stat().st_size for f in ck.iterdir())
        shutil.rmtree(ck, ignore_errors=True)
        out.update(compressed_psum=psum, checkpoint=dict(
            leaves=len(named_leaves(tmpl)), gib=round(n_bytes / 2**30, 3),
            save_and_restore_s=round(ck_s, 1), bit_identical=True))
        log("  (l3) checkpoint: " + json.dumps(out["checkpoint"]))
    finally:
        dist.destroy_process_group()
    out["phase_s"] = round(time.perf_counter() - t_phase, 1)
    return out


def run_dryrun(dev):
    """Phase (m): (m1)-(m4) ``launch.dryrun.lower_cell`` on DRYRUN_CELLS
    (fake tensors on a cuda mesh of a fake group; no kernel may launch:
    the matmul wrapper's fake path gives shapes only), each result printed
    and ``ok``; (m5) ``lockstep_on_dtensors``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    out = {}
    for tag, arch, shape, kw in DRYRUN_CELLS:
        ops.reset_launch_counts()
        r = dryrun.lower_cell(arch, shape, device="cuda", verbose=False,
                              **kw)
        log(f"  ({tag}) " + json.dumps(r))
        if r["status"] != "ok":
            raise AssertionError(f"({tag}) {r['cell']}: {r['status']}")
        if any(ops.launch_counts().values()):
            raise AssertionError(f"({tag}) a kernel launched on fake "
                                 f"tensors: {ops.launch_counts()}")
        out[tag] = {k: r[k] for k in ("cell", "mesh", "quant_bits",
                                      "kv_bits", "trace_s",
                                      "collective_bytes", "dominant")}
    out["m5"] = lockstep_on_dtensors(dev)
    return out


def lockstep_on_dtensors(dev):
    """(m5) an NCCL group of world size 1 and a (1, 1) ("data", "model")
    mesh, as (l)'s: (c)'s 4-bit qwen1.5-0.5b placed serve-mode
    (``param_pspecs(..., mode="serve")``, its ring by ``cache_pspecs``),
    one ``make_prefill_step`` of (c)'s first max_batch prompts (cut to
    LOCKSTEP_PROMPT tokens) and LOCKSTEP_STEPS ``make_serve_step`` calls
    on DTensors: the same ids as the steps on plain tensors, with the
    matmul launchers counted in the DTensor run (launch counts reset just
    before it). Returns the counts and both runs' step times."""
    import torch.distributed as dist

    from repro_torch.configs.archs import QWEN15_05B
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import build_template, init_cache
    from repro_torch.models.quantize import quantize_params
    from repro_torch.quant.config import QuantConfig

    cfg, q, b = QWEN15_05B, QuantConfig(bits=4), SERVE["max_batch"]
    tmpl = build_template(cfg)
    params = quantize_params(seeded_params(cfg, dev), tmpl, q)
    shape = ShapeConfig("decode", LOCKSTEP_PROMPT + LOCKSTEP_STEPS, b,
                        "decode")
    run = RunConfig(arch=cfg, shape=shape, quant=q)
    prefill = steps_mod.make_prefill_step(cfg, run)
    serve_step = steps_mod.make_serve_step(cfg, run)
    prompts = torch.from_numpy(np.stack([
        r.prompt[:LOCKSTEP_PROMPT] for r in workload(1, b)])).to(dev)

    def ids(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def decode(p, tokens, cache):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = [prefill(p, {"tokens": tokens}, cache)[0]]
        for pos in range(LOCKSTEP_PROMPT, shape.seq_len):
            out.append(serve_step(p, out[-1][:, None], cache, pos)[0])
        got = torch.stack([ids(t) for t in out], dim=1)
        torch.cuda.synchronize(dev)
        return got, (time.perf_counter() - t0) * 1e3 / len(out)

    want, plain_ms = decode(params, prompts,
                            init_cache(cfg, b, shape.seq_len, device=dev))
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = make_test_mesh(1, 1, device="cuda")
        dp = sh.distribute(params, sh.placements(
            sh.param_pspecs(tmpl, mesh, q, mode="serve"), mesh))
        cache = sh.distribute(
            init_cache(cfg, b, shape.seq_len, device=dev),
            sh.placements(sh.cache_pspecs(cfg, shape, mesh), mesh))
        tokens = sh.distribute(prompts, sh.placements(
            sh.data_pspec(b, mesh), mesh))
        ops.reset_launch_counts()
        got, ms = decode(dp, tokens, cache)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
    finally:
        dist.destroy_process_group()
    if not torch.equal(got, want):
        raise AssertionError(f"(m5) DTensor ids {got.tolist()} != plain "
                             f"{want.tolist()}")
    if not (counts.get(SPLITK) and counts.get(TILE)):
        raise AssertionError(f"(m5) launches {counts}")
    out = dict(steps=1 + LOCKSTEP_STEPS, batch=b, ids_identical=True,
               launches=counts, step_ms=ms, step_ms_plain=plain_ms)
    log("  (m5) lockstep steps on DTensors: " + json.dumps(out))
    return out


# -- (n) the port's lint and the example twins --------------------------------

LINT_CMD = ("tools/samd_lint_torch.py", "src/repro_torch", "--certify",
            "BENCH_serving.json")
SERVE_EXAMPLE_RUNS = (("4-bit", [], {SPLITK, TILE, DECODE}),
                      ("4-bit, --speculative 2", ["--speculative", "2"],
                       {SPLITK, TILE, RING, VERIFY}))
QUICKSTART_ERR_TOL = 1e-3
TRAIN_E2E_ARGV = ["--big"]  # the reference's larger config, 42.1M params


@contextlib.contextmanager
def first_matmul_calls():
    """Wraps ``ops.samd_matmul`` (the one way into the matmul launchers)
    and yields (calls, launches): for each (launcher, M, K, N, bits) the
    path gives it, copies of the first call's inputs and output; and the
    calls made by launcher."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import samd_matmul as mm

    calls, launches, inner = {}, collections.Counter(), ops.samd_matmul

    def recording(x, packed, scale, k, cfg, *, signed=True):
        out = inner(x, packed, scale, k, cfg, signed=signed)
        if x.is_cuda:
            m = x.numel() // k
            key = (mm.launcher_for(m), m, k, out.shape[-1], cfg.bits)
            launches[key[0]] += 1
            if key not in calls:
                calls[key] = (x.reshape(m, k).clone(), packed, scale, k,
                              cfg, signed, out.reshape(m, -1).clone())
        return out

    ops.samd_matmul = recording
    try:
        yield calls, launches
    finally:
        ops.samd_matmul = inner


def hold_matmuls(tag, calls):
    """Each call of ``first_matmul_calls`` against ``samd_matmul_plain``
    on the same inputs, within BF16_TOL; returns the max |kernel - plain|
    by launcher."""
    from repro_torch.kernels import samd_matmul as mm

    errs, by_key = {}, {}
    for key, (x, packed, scale, k, cfg, signed, out) in calls.items():
        want = mm.samd_matmul_plain(x, packed, scale, k, cfg, signed=signed)
        try:
            by_key[str(key)] = max_err(out, want, BF16_TOL)
        except AssertionError as e:
            raise AssertionError(f"({tag}) samd_matmul at {key}: {e}")
        errs[key[0]] = max(errs.get(key[0], 0.0), by_key[str(key)])
    log(f"  ({tag}) samd_matmul on the path's own inputs, max |kernel - "
        "plain| by (launcher, M, K, N, bits): " + json.dumps(by_key))
    return errs


def example(main, argv, dev, reset=True):
    """``main(argv, device=dev)`` of an example twin with its printed
    lines captured; returns (its result, the lines, seconds, the launch
    counts after it: reset just before it unless ``reset`` is false, and
    on the card with the launch counts reset the max |kernel - plain| by
    matmul launcher of ``hold_matmuls``, else {})."""
    import io

    from repro_torch.kernels import ops

    buf = io.StringIO()
    if reset:
        ops.reset_launch_counts()
    t0 = time.perf_counter()
    with first_matmul_calls() as (calls, launches), \
            contextlib.redirect_stdout(buf):
        result = main(argv, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    counts, lines = ops.launch_counts(), buf.getvalue().splitlines()
    if not (reset and dev.type == "cuda"):
        return result, lines, seconds, counts, {}
    tag = f"{main.__module__} {' '.join(argv or [])}".strip()
    for fn, n in launches.items():
        if counts[fn] != n:
            raise AssertionError(f"({tag}) {counts[fn]} {fn} launches, "
                                 f"{n} calls through ops.samd_matmul")
    return result, lines, seconds, counts, hold_matmuls(tag, calls)


def launched(tag, counts, expect):
    """Raise unless every launcher of ``expect`` launched and no other."""
    on = {fn for fn, n in counts.items() if n}
    if on != set(expect):
        raise AssertionError(f"({tag}) launched {sorted(on)}, expected "
                             f"{sorted(expect)}: {counts}")


def run_examples(dev, card):
    """Phase (n): (n1) ``tools/samd_lint_torch.py`` over the port with
    ``--certify`` must exit 0; then each example twin's ``main`` on the
    card, launch counts reset just before each: (n2) quickstart, its
    sections 1-3 printed as on the CPU, section 4's errors within
    QUICKSTART_ERR_TOL of the CPU's and its split-K launcher launched
    once a bit width; (n3) serve_quantized at 4 bits and with
    ``--speculative 2``, every request finished untruncated, the path's
    launchers launched, the greedy tokens against the same example run
    under ``plain_versions()`` (or, speculative, against the first run)
    by ``check_greedy``; (n4) train_e2e ``--big`` (the reference's larger
    configuration, 42.1M parameters, 200 steps), the loss falling, the
    packed forwards through the tile launcher, and the last checkpoint
    restored by ``CheckpointManager.restore`` with no device named (the
    card) bit-identical to the final parameters and AdamW state. Returns
    the summary, each run's launch counts and the max |kernel - plain| of
    the matmul launchers over every run's own inputs."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.tree import named_leaves

    sys.path.insert(0, str(ROOT / "examples"))
    import quickstart_torch
    import serve_quantized_torch
    import train_e2e_torch

    out, counts, errs = {}, {}, {}

    def held(run_errs):
        for fn, e in run_errs.items():
            errs[fn] = max(errs.get(fn, 0.0), e)

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *LINT_CMD], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    out["n1_lint"] = dict(
        rc=res.returncode, seconds=round(time.perf_counter() - t0, 1),
        stderr=[x for x in res.stderr.splitlines()
                if x.startswith(("samd-lint-torch", "note: certify"))])
    log("  (n1) " + json.dumps(out["n1_lint"]))
    if res.returncode != 0:
        raise AssertionError(f"(n1) the lint failed:\n{res.stdout}\n"
                             f"{res.stderr}")

    got, lines, sec, c, e = example(quickstart_torch.main, None, dev)
    held(e)
    want, cpu_lines, _, _, _ = example(quickstart_torch.main, None,
                                       torch.device("cpu"))
    for line in lines:
        log(f"  (n2) | {line}")
    launched("n2", c, {SPLITK})
    if c[SPLITK] != len(got):
        raise AssertionError(f"(n2) {c[SPLITK]} split-K launches for "
                             f"{len(got)} bit widths")
    if lines[:12] != cpu_lines[:12]:
        raise AssertionError("(n2) sections 1-3 differ from the CPU's")
    for bits, r in got.items():
        if (r["ratio"] != want[bits]["ratio"] or abs(
                r["rel_err"] - want[bits]["rel_err"]) > QUICKSTART_ERR_TOL):
            raise AssertionError(f"(n2) {bits}-bit: {r} against the CPU's "
                                 f"{want[bits]}")
    counts["quickstart"] = c
    out["n2_quickstart"] = dict(seconds=round(sec, 2), launches=c,
                                results=got, cpu=want)
    log("  (n2) " + json.dumps(out["n2_quickstart"]))

    first = None
    for label, argv, expect in SERVE_EXAMPLE_RUNS:
        eng, lines, sec, c, e = example(serve_quantized_torch.main, argv,
                                        dev)
        held(e)
        for line in lines:
            log(f"  (n3) | {line}")
        launched(f"n3 {label}", c, expect)
        if len(eng.finished) != 6 or any(
                r.truncated or r.error or not r.generated
                for r in eng.finished):
            raise AssertionError(f"(n3) {label}: a request fell short")
        if first is None:
            with plain_versions():
                plain, _, _, _, _ = example(serve_quantized_torch.main,
                                            argv, dev, reset=False)
            ident = check_greedy(eng, plain.finished, dev,
                                 against="the example under plain versions")
            first = eng
        else:
            ident = check_greedy(eng, first.finished, dev,
                                 against="the first run's greedy decode")
        counts[f"serve {label}"] = c
        out[f"n3_serve {label}"] = dict(
            seconds=round(sec, 2), launches=c, stats=dict(eng.stats),
            greedy_identical=ident, requests=len(eng.finished))
        log(f"  (n3) {label}: " + json.dumps(out[f"n3_serve {label}"]))

    res, lines, sec, c, e = example(train_e2e_torch.main, TRAIN_E2E_ARGV,
                                    dev)
    held(e)
    for line in lines:
        log(f"  (n4) | {line}")
    losses = [res["losses"][k] for k in sorted(res["losses"])]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"(n4) the loss did not fall: {losses}")
    launched("n4", c, {TILE})
    like = {"params": res["params"], "opt": res["opt"]}
    t0 = time.perf_counter()
    tree, at, _ = CheckpointManager(res["ckdir"]).restore(like)
    restore_s = time.perf_counter() - t0
    for (name, a), (_, b) in zip(named_leaves(tree), named_leaves(like),
                                 strict=True):
        if not (a.device == b.device and a.dtype == b.dtype
                and torch.equal(a, b)):
            raise AssertionError(f"(n4) {name} did not restore")
    shutil.rmtree(res["ckdir"], ignore_errors=True)
    counts["train_e2e"] = c
    out["n4_train_e2e"] = dict(
        seconds=round(sec, 1), n_params=res["n_params"], losses=losses,
        restored_step=at, restore_s=round(restore_s, 2),
        fp_bytes=res["fp_bytes"], packed_bytes=res["packed_bytes"],
        agreement=res["agreement"], launches=c, card=card)
    log("  (n4) " + json.dumps(out["n4_train_e2e"]))
    out["matmul_err"] = errs
    return out, counts, errs


def kernel_entry(name, source, replaces, launches, err, t, shape):
    """One launcher's object in the kernels line; ``t`` is its
    ``timing_row``."""
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "library_ms": t["library_ms"], "shape": shape}
    for key in ("old_ms", "unfused_ms", "host_paced_ms",
                "library_host_paced_ms", "host_us_per_call",
                "host_us_per_call_device_ctx"):
        if key in t:
            entry[key] = t[key]
    return entry


def kernel_name(mangled):
    """A compiled kernel's name for the build log: demangled and cut to
    its template arguments (the matmul's are <vpw, warps, n16 tiles a
    warp, m8 tiles, stages>) where ``c++filt`` is installed."""
    import shutil

    if not shutil.which("c++filt"):
        return mangled
    name = subprocess.run(["c++filt", mangled], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ").strip()


def nvidia_smi():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-matmul", metavar="SOURCE",
                    help="a previous samd_matmul.cu (e.g. from a git "
                    "archive of the parent commit) to time in turns with "
                    "the kernel in (d)")
    ap.add_argument("--old-conv", metavar="SOURCE",
                    help="a previous samd_conv.cu (e.g. from a git archive "
                    "of the parent commit) to time in turns with the "
                    "conv2d kernel in (f')")
    ap.add_argument("--old-attention", metavar="SOURCE",
                    help="a previous paged_attention.cu (e.g. from a git "
                    "archive of the parent commit) to time in turns with "
                    "the attention kernel in (d) and (d')")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    from repro_torch.quant.config import QuantConfig

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(dev)

    log("(a) build")
    t0 = time.perf_counter()
    ops.build_kernels()
    log(f"  built {[k.name for k in ops.KERNELS]} in "
        f"{time.perf_counter() - t0:.1f} s")
    for k in ops.KERNELS:
        fn = ""
        for line in k.build_log.splitlines():
            if "Compiling entry function" in line:
                fn = kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log(f"  {k.name} {fn}: {line.strip()}")

    launch_log = LaunchLog()

    log("(b) kernels against their plain versions")
    err_mm = check_samd_matmul(dev, gen)
    err_q3 = check_qwen3_shapes(dev, gen)
    err_pa = check_paged_attention(dev, gen)
    err_verify = check_verify_attention(dev, gen)
    err_ring = check_ring_fold(dev, gen)

    log("(c) serve full-width qwen1.5-0.5b, 4-bit SAMD weights")
    runs, c_done = {}, {}
    for kv_bits, fmt in ((None, "bf16"), (8, "int8")):
        eng, summary, counts = serve(
            f"4-bit, {fmt} KV", dev, {SPLITK, TILE, DECODE},
            quant=QuantConfig(bits=4, kv_bits=kv_bits))
        check_model_against_plain(eng, dev)
        runs[fmt] = (eng, summary, counts)
        c_done[fmt] = list(eng.finished)  # (g) resets and reuses the engine

    log("(e) speculative serving")
    spec_k = {run: k for run, _, k in SPEC_RUNS}
    plain, _, _ = serve("bf16 target, plain decode", dev, {DECODE})
    plain = plain.finished
    eng_a, sum_a, counts_a = serve(
        f"run A: bf16 target, 8-bit draft, K={spec_k['A']}, bf16 KV", dev,
        {SPLITK, RING, VERIFY}, speculative=spec_k["A"],
        draft_quant=QuantConfig(bits=8))
    check_greedy(eng_a, plain, dev)
    eng_b, sum_b, counts_b = serve(
        f"run B: 4-bit target as its own draft, K={spec_k['B']}, int8 KV",
        dev, {SPLITK, TILE, RING, VERIFY}, speculative=spec_k["B"],
        quant=QuantConfig(bits=4, kv_bits=8))
    check_greedy(eng_b, runs["int8"][0].finished, dev)
    runs["A"] = (eng_a, sum_a, counts_a)
    runs["B"] = (eng_b, sum_b, counts_b)

    log(f"(d) kernel times at the main path's shapes (card: {card})")
    old = OldMatmul(args.old_matmul) if args.old_matmul else None

    # one entry per launcher per serving run that launches it, with that
    # run's own launch count, timed on that run's own weights and pools;
    # the matmul's times are device times (CUDA graph), its yardstick's too
    kernels = []
    decode_t = {}  # the split-K timing row of each run, for (g) too
    for key, label, bits in (("bf16", "bf16 KV run", 4),
                             ("int8", "int8 KV run", 4),
                             ("A", "run A draft", 8),
                             ("B", "run B draft", 4)):
        eng, _, counts = runs[key]
        params = eng._draft_params if eng.speculative else eng.params
        m = eng.max_batch
        mm_t = decode_t[key] = time_samd_matmul(
            dev, timer, params, f"{label}, M={m}", m, old)
        kernels.append(kernel_entry(
            f"samd_matmul split-K ({label}, M={m})", MM_SOURCE,
            "src/repro/kernels/samd_matmul.py:123", counts[SPLITK],
            err_mm[bits, "temporary", True, m], mm_t,
            f"decode M={m}, mean per launch over wq,wk,wv,wo,wg,wu,wd of 24 "
            f"layers, {bits}-bit; ms and library_ms are device times"))
    # run B's verify: its 4-bit target's linears at 8 slots x (K + 1) rows
    eng_b, _, counts_b = runs["B"]
    m = eng_b.max_batch * (spec_k["B"] + 1)
    mm_t = time_samd_matmul(dev, timer, eng_b.params, f"run B verify, M={m}",
                            m, old)
    kernels.append(kernel_entry(
        f"samd_matmul split-K (run B verify, M={m})", MM_SOURCE,
        "src/repro/kernels/samd_matmul.py:123", counts_b[SPLITK],
        err_mm[4, "temporary", True, m], mm_t,
        f"verify M={m}, 4-bit, mean over the 7 linears of 24 layers; "
        "launches: run B's split-K total (draft and verify)"))
    # prefill: (c)'s 4-bit weights (the same seed as run B's target)
    prefill_t = mm_t = time_samd_matmul(dev, timer, runs["bf16"][0].params,
                                        "prefill, M=1024", 1024, old)
    for key, label in (("bf16", "bf16 KV run"), ("int8", "int8 KV run"),
                       ("B", "run B")):
        kernels.append(kernel_entry(
            f"samd_matmul tile ({label} prefill)", MM_SOURCE,
            "src/repro/kernels/samd_matmul.py:123", runs[key][2][TILE],
            err_mm[4, "temporary", True, 1024], mm_t,
            "M=1024, 4-bit, mean over the 7 linears of 24 layers (the "
            "run's prefills are 8 x its prompt bucket rows)"))
    old_pa = OldAttention(args.old_attention) if args.old_attention else None
    attn_t = {}
    for fmt in ("bf16", "int8"):
        eng, _, counts = runs[fmt]
        pa_t = attn_t[fmt] = time_paged_attention(eng, dev, timer,
                                                  fmt == "int8", gen, old_pa)
        kernels.append(kernel_entry(
            f"paged_decode_attention ({fmt} KV)", PA_SOURCE,
            "src/repro/kernels/paged_attention.py:294", counts[DECODE],
            err_pa[fmt, 1], pa_t,
            "decode B=8 H=Hkv=16 dh=64 ps=16 n_pp=32, per layer; ms and "
            "library_ms are device times"))
    log("(d') the speculative launchers at runs A and B's shapes")
    # each entry's max_abs_err is (b')'s at that run's own shape
    spec_t = {}  # run -> (ring fold, verify) timing rows, for (n) too
    for key, fmt, r in SPEC_RUNS:
        eng, _, counts = runs[key]
        assert eng.speculative == r and (eng._kv_bits == 8) == (fmt == "int8")
        t = time_ring_fold(eng, dev, timer, gen, f"run {key}, {fmt} KV",
                           old_pa)
        kernels.append(kernel_entry(
            f"paged_decode_ring_attention (run {key}, {fmt} KV)", PA_SOURCE,
            "src/repro/kernels/paged_attention.py:294", counts[RING],
            err_ring[fmt, r, 1], t, f"draft decode B=8 H=Hkv=16 dh=64 ps=16 "
            f"n_pp=32, pool to pos-1 + ring R={r}, per layer; device times"))
        spec_t[key] = (t, time_verify(eng, dev, timer, gen,
                                      f"run {key}, {fmt} KV", old_pa))
        t = spec_t[key][1]
        kernels.append(kernel_entry(
            f"paged_verify_attention (run {key}, {fmt} KV)", PA_SOURCE,
            "src/repro/kernels/paged_attention.py:584", counts[VERIFY],
            err_verify[fmt, r + 1, 1], t, f"verify B=8 S={r + 1} H=Hkv=16 "
            "dh=64 ps=16 n_pp=32, per layer; device times"))
    q3_attn = time_qwen3_attention(dev, timer, gen, old_pa)[0]

    log("(f) the VGG-B convolutions through samd_conv2d and samd_conv1d")
    conv1d_results, entries = run_vggb(
        dev, gen, timer, card,
        OldConv(args.old_conv) if args.old_conv else None)
    kernels += entries

    log(f"(g) the async front door over (c)'s bf16-KV engine (card: "
        f"{card})")
    eng, summary, _ = runs["bf16"]
    front, counts = run_front_door(eng, dev,
                                   summary["decode_tick_ms_median"],
                                   {SPLITK, TILE, DECODE})
    # (g)'s launchers run (c)'s bf16-KV engine at (c)'s shapes: their
    # numbers are (b)'s and (d)'s for that run, their launches the
    # open-loop rows' own
    kernels.append(kernel_entry(
        f"samd_matmul split-K (front door, M={eng.max_batch})", MM_SOURCE,
        "src/repro/kernels/samd_matmul.py:123", counts[SPLITK],
        err_mm[4, "temporary", True, eng.max_batch], decode_t["bf16"],
        "(g): (c)'s bf16 KV engine through AsyncServer; launches of the "
        "three open-loop rows; numbers of the bf16 KV run's decode row"))
    kernels.append(kernel_entry(
        "samd_matmul tile (front door prefill)", MM_SOURCE,
        "src/repro/kernels/samd_matmul.py:123", counts[TILE],
        err_mm[4, "temporary", True, 1024], prefill_t,
        "(g): prefills of 8 x bucket rows; launches of the three open-loop "
        "rows; numbers of the M=1024 row"))
    kernels.append(kernel_entry(
        "paged_decode_attention (front door, bf16 KV)", PA_SOURCE,
        "src/repro/kernels/paged_attention.py:294", counts[DECODE],
        err_pa["bf16", 1], attn_t["bf16"],
        "(g): launches of the three open-loop rows; numbers of (c)'s bf16 "
        "KV decode row"))

    log(f"(h) the engine's other modes, full-width qwen3-14b, group scales "
        f"and the lane-safety analysis (card: {card})")
    modes = serve_modes(dev, c_done["bf16"], runs["bf16"][1])
    pr_t = time_samd_matmul(dev, timer, runs["bf16"][0].params,
                            "per-row decode, M=1", 1)
    for mode, (_, counts) in modes.items():
        m = 1 if mode == "per-row" else SERVE["max_batch"]
        kernels.append(kernel_entry(
            f"samd_matmul split-K ({mode} run, M={m})", MM_SOURCE,
            "src/repro/kernels/samd_matmul.py:123", counts[SPLITK],
            err_mm[4, "temporary", True, m],
            pr_t if mode == "per-row" else decode_t["bf16"],
            f"(h): (c)'s 4-bit bf16-KV engine, {mode}; numbers of the "
            f"M={m} decode row of (c)'s weights"))
        kernels.append(kernel_entry(
            f"samd_matmul tile ({mode} run prefill)", MM_SOURCE,
            "src/repro/kernels/samd_matmul.py:123", counts[TILE],
            err_mm[4, "temporary", True, 1024], prefill_t,
            f"(h): {mode} prefills; numbers of the M=1024 row"))
    q3_sum, q3_counts, q3_shapes, q3_t = serve_qwen3(dev, timer, launch_log)
    head_n = sum(c for key, c in q3_shapes.items()
                 if key[0] == SPLITK and key[2] == 151936)
    kernels.append(kernel_entry(
        "samd_matmul split-K (qwen3-14b decode linears, M=8)", MM_SOURCE,
        "src/repro/kernels/samd_matmul.py:123", q3_counts[SPLITK] - head_n,
        max(e for key, e in err_q3.items()
            if key[-1:] == (8,) and key[1] != 151936),
        q3_t["decode"], "(h3) full-width qwen3-14b, 4-bit, mean per launch "
        "over wq,wk,wv,wo,wg,wu,wd of 40 layers; device times"))
    kernels.append(kernel_entry(
        "samd_matmul split-K (qwen3-14b LM head, M=8)", MM_SOURCE,
        "src/repro/kernels/samd_matmul.py:123", head_n,
        err_q3[5120, 151936, 8], q3_t["head"],
        "(h3) K=5120 N=151936, 4-bit (quantize_embeddings); device times"))
    kernels.append(kernel_entry(
        "samd_matmul tile (qwen3-14b prefill)", MM_SOURCE,
        "src/repro/kernels/samd_matmul.py:123", q3_counts[TILE],
        max(e for key, e in err_q3.items() if key[-1:] == (1024,)),
        q3_t["prefill"],
        "(h3) prefills of 8 x bucket rows, the LM head's included; numbers "
        "of M=1024 over the 7 linears of 40 layers"))
    kernels.append(kernel_entry(
        "paged_decode_attention (qwen3-14b, bf16 KV)", PA_SOURCE,
        "src/repro/kernels/paged_attention.py:294", q3_counts[DECODE],
        err_q3["attention"], q3_attn,
        "(h3) decode B=8 Hkv=8 G=5 dh=128 ps=16 n_pp=32; numbers of (d)'s "
        "qwen3-14b kernel-only row"))
    g_sum, g_counts = serve_group_scales(dev)
    kernels.append(kernel_entry(
        f"paged_decode_attention (qwen3-14b group_size={GROUP_SIZE})",
        PA_SOURCE, "src/repro/kernels/paged_attention.py:294",
        g_counts[DECODE], err_q3["attention"], q3_attn,
        "(h4) the group-scaled run (its linears dequantize, no matmul "
        "launcher); numbers of (d)'s qwen3-14b kernel-only row"))
    log(f"(i) the reference's other families at full width (card: {card})")
    # (i)'s peaks are its own: drop the engines of (c)-(h)
    runs = {key: (None,) + run[1:] for key, run in runs.items()}
    del eng, eng_a, eng_b
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  allocated before (i): "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")

    families, entries = run_families(dev, timer, gen, launch_log)
    kernels += entries
    analysis = check_analysis(dev, launch_log)

    log(f"(j) training full-width qwen1.5-0.5b, then serving it (card: "
        f"{card})")
    gc.collect()
    torch.cuda.empty_cache()
    training, counts = run_training(dev, card)
    # (j4) serves the trained weights with (c)'s engine shapes: its
    # launchers' numbers are (b)'s and (d)'s for (c)'s bf16 KV run, their
    # launches (j4)'s own
    kernels.append(kernel_entry(
        f"samd_matmul split-K (trained model, M={SERVE['max_batch']})",
        MM_SOURCE, "src/repro/kernels/samd_matmul.py:123", counts[SPLITK],
        err_mm[4, "temporary", True, SERVE["max_batch"]], decode_t["bf16"],
        "(j4): full-width qwen1.5-0.5b trained 20 steps, 4-bit, bf16 KV; "
        "numbers of (c)'s bf16 KV decode row"))
    kernels.append(kernel_entry(
        "samd_matmul tile (trained model prefill)", MM_SOURCE,
        "src/repro/kernels/samd_matmul.py:123", counts[TILE],
        err_mm[4, "temporary", True, 1024], prefill_t,
        "(j4): prefills of 8 x bucket rows; numbers of the M=1024 row"))
    kernels.append(kernel_entry(
        "paged_decode_attention (trained model, bf16 KV)", PA_SOURCE,
        "src/repro/kernels/paged_attention.py:294", counts[DECODE],
        err_pa["bf16", 1], attn_t["bf16"],
        "(j4): launches of the trained model's serving run; numbers of "
        "(c)'s bf16 KV decode row"))
    log(f"(k) the paper's 64-bit SAMD words (card: {card})")
    gc.collect()
    torch.cuda.empty_cache()
    words64 = run_words64(dev, timer, conv1d_results)
    log(f"(l) distribution on one card: DTensor, NCCL (card: {card})")
    gc.collect()
    torch.cuda.empty_cache()
    distributed = run_distributed(dev)
    log(f"(m) the dry-run on fake groups of 256 and 512 ranks, then "
        f"lockstep serving on DTensors (card: {card})")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry = run_dryrun(dev)
    dry["phase_s"] = round(time.perf_counter() - t0, 1)
    counts = dry["m5"]["launches"]
    kernels.append(kernel_entry(
        f"samd_matmul split-K (sharded lockstep decode, "
        f"M={SERVE['max_batch']})", MM_SOURCE,
        "src/repro/kernels/samd_matmul.py:123", counts[SPLITK],
        err_mm[4, "temporary", True, SERVE["max_batch"]], decode_t["bf16"],
        "(m5): (c)'s 4-bit weights as DTensors on a (1, 1) mesh, each "
        "rank's own words; numbers of (c)'s bf16 KV decode row"))
    kernels.append(kernel_entry(
        "samd_matmul tile (sharded lockstep prefill)", MM_SOURCE,
        "src/repro/kernels/samd_matmul.py:123", counts[TILE],
        err_mm[4, "temporary", True, 1024], prefill_t,
        f"(m5): one prefill of {SERVE['max_batch']} x {LOCKSTEP_PROMPT} "
        "rows; numbers of the M=1024 row"))
    log(f"(n) the port's lint and the example twins (card: {card})")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    examples, ex_counts, ex_err = run_examples(dev, card)
    examples["phase_s"] = round(time.perf_counter() - t0, 1)
    serve_c = [c for key, c in ex_counts.items() if key.startswith("serve")]
    spec_c = ex_counts["serve 4-bit, --speculative 2"]
    kernels.append(kernel_entry(
        "samd_matmul split-K (examples)", MM_SOURCE,
        "src/repro/kernels/samd_matmul.py:123",
        ex_counts["quickstart"][SPLITK] + sum(c[SPLITK] for c in serve_c),
        ex_err[SPLITK], decode_t["bf16"],
        "(n2) quickstart M=4 at 8/4/2 bits, (n3) serve_quantized decode "
        "M=3 and verify M=9, d 256; max_abs_err over every (M, K, N, "
        "bits) of these runs on their own inputs, times of (c)'s bf16 KV "
        "decode row"))
    kernels.append(kernel_entry(
        "samd_matmul tile (examples)", MM_SOURCE,
        "src/repro/kernels/samd_matmul.py:123",
        sum(c[TILE] for c in serve_c) + ex_counts["train_e2e"][TILE],
        ex_err[TILE], prefill_t,
        "(n3) serve_quantized prefills (M=96 and 48, d 256), (n4) "
        "train_e2e --big's packed forwards (M=1024, K and N 512 or 1408, "
        "8/4/3/2 bits); max_abs_err "
        "over every (M, K, N, bits) of these runs on their own inputs, "
        "times of the M=1024 row"))
    kernels.append(kernel_entry(
        "paged_decode_attention (serve_quantized example)", PA_SOURCE,
        "src/repro/kernels/paged_attention.py:294",
        ex_counts["serve 4-bit"][DECODE], err_pa["bf16", 1], attn_t["bf16"],
        "(n3) B=3 H=Hkv=4 dh=64 ps=16; numbers of (c)'s bf16 KV decode "
        "row"))
    kernels.append(kernel_entry(
        "paged_decode_ring_attention (serve_quantized --speculative 2)",
        PA_SOURCE, "src/repro/kernels/paged_attention.py:294", spec_c[RING],
        err_ring["bf16", 2, 1], spec_t["A"][0],
        "(n3) B=3 H=Hkv=4 dh=64, ring R=2; numbers of run A's bf16 ring "
        "row"))
    kernels.append(kernel_entry(
        "paged_verify_attention (serve_quantized --speculative 2)",
        PA_SOURCE, "src/repro/kernels/paged_attention.py:584",
        spec_c[VERIFY], err_verify["bf16", 3, 1], spec_t["A"][1],
        "(n3) B=3 S=3 H=Hkv=4 dh=64; numbers of run A's bf16 verify row"))
    log("serving: " + json.dumps([runs[k][1] for k in runs]))
    log("front door: " + json.dumps(front))
    log("modes: " + json.dumps({m: sm for m, (sm, _) in modes.items()}))
    log("qwen3-14b: " + json.dumps(dict(q3_sum, group_scales=g_sum)))
    log("analysis: " + json.dumps(analysis))
    log("families: " + json.dumps(families))
    log("training: " + json.dumps(training))
    log("64-bit words: " + json.dumps(words64))
    log("distribution: " + json.dumps(distributed))
    log("dry-run: " + json.dumps(dry))
    log("examples: " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk != "results"}
         if isinstance(v, dict) else v for k, v in examples.items()}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
