"""Deterministic synthetic LM data pipeline (host-sharded, pull-based).

  * Each host draws only its own shard of the global batch, seeded by
    (seed, step, host_id), so no host ever holds the global batch.
  * ``prefetch`` keeps a small queue of ready batches per host, so a slow
    step on one host does not stall the input side (the step-time
    watchdog lives in launch/train.py).
  * The stream is a deterministic function of (seed, step), so a restart
    replays the same data: checkpointed training resumes exactly.

The batches are numpy int32 arrays, bit-identical to the reference's
(the same generator, seed formula and draws).
"""
from __future__ import annotations

import collections
import threading
from typing import Iterator

import numpy as np
import torch


class SyntheticLM:
    """Markov-flavoured synthetic token stream with next-token structure,
    so small models show a real, decreasing loss (uniform noise would
    not)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0,
                 prefetch: int = 2):
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {n_hosts} hosts")
        self.vocab = vocab
        self.seq_len = seq_len
        self.host_batch = global_batch // n_hosts
        self.seed = seed
        self.host_id = host_id
        self._queue: collections.deque = collections.deque()
        self._prefetch = prefetch
        self._next_step = 0
        self._lock = threading.Lock()

    def _gen(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id
        )
        b, s, v = self.host_batch, self.seq_len, self.vocab
        # random walk tok_{t+1} = (tok_t + drift_t) % v with small drifts:
        # next-token entropy ~= log(8) << log(v), so a model that learns
        # the local structure shows a clear loss drop
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        drift = rng.integers(0, 8, size=(b, s))
        for t in range(s):
            toks[:, t + 1] = (toks[:, t] + drift[:, t]) % v
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def fill(self):
        with self._lock:
            while len(self._queue) < self._prefetch:
                self._queue.append(self._gen(self._next_step))
                self._next_step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        self.fill()
        with self._lock:
            return self._queue.popleft()

    def seek(self, step: int):
        """Resume the stream at an arbitrary step (checkpoint restart)."""
        with self._lock:
            self._queue.clear()
            self._next_step = step


def make_batch_specs(vocab: int, seq_len: int, global_batch: int):
    """Meta tensors for one global training batch (a dry-run's input):
    int32 ``tokens`` and ``targets`` [global_batch, seq_len]."""
    return {name: torch.empty((global_batch, seq_len), dtype=torch.int32,
                              device="meta")
            for name in ("tokens", "targets")}
