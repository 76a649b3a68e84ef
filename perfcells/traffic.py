"""The one traffic generator: a mix's data file in, the requests of one
run out.

A mix is ``traffic/<name>.json``: the clients and the engine batch, the
prompt and output length distributions, an optional prefix that every
prompt of a run shares, and the block size of the stratified draw.

Every seed gets the same work in another order. Lengths are taken at the
quantiles ``(i + 0.5) / block`` of their distribution, so each block of
``block`` consecutive requests holds the same multiset of prompt and
output lengths; the seed shuffles the lengths within each block and
draws the token ids. A run sends its requests in list order, whichever
client is free, so any whole number of blocks is the same work on every
seed. Where the order of the lengths changes the work (which requests
arrive together, and so are admitted together), a mix's ``order_seed``
draws that order in place of the run's seed: every seed then sends the
same lengths in the same order, with its own token ids.

The first ``clients`` requests open the run with every slot busy at
once. Their output lengths are spread over ``[1, output max]`` instead
(the residual lengths of requests already under way), so the clients'
later requests do not all arrive together.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import statistics
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


@dataclasses.dataclass(frozen=True)
class Req:
    """One request: its prompt token ids and the tokens it asks for."""

    index: int
    prompt: np.ndarray      # int32 [T]
    max_tokens: int


def load(name: str, directory: Path = TRAFFIC_DIR) -> dict:
    return json.loads((directory / f"{name}.json").read_text())


def sub_seed(seed: int, *labels) -> int:
    """A 63-bit seed for one named stream of draws of a run."""
    h = hashlib.sha256(repr((int(seed),) + labels).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def quantile_lengths(dist: dict, n: int) -> list[int]:
    """``n`` lengths at the quantiles (i + 0.5) / n of ``dist``:
    ``uniform`` over [min, max], ``loguniform`` over [min, max], or
    ``lognormal`` with ``median`` and ``sigma``, clipped to [min, max]."""
    lo, hi = int(dist["min"]), int(dist["max"])
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        kind = dist["dist"]
        if kind == "uniform":
            v = lo + u * (hi - lo)
        elif kind == "loguniform":
            v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        elif kind == "lognormal":
            z = statistics.NormalDist().inv_cdf(u)
            v = float(dist["median"]) * math.exp(float(dist["sigma"]) * z)
        else:
            raise ValueError(f"unknown length distribution {kind!r}")
        out.append(min(hi, max(lo, int(round(v)))))
    return out


def max_len(mix: dict) -> int:
    """The longest sequence a request of ``mix`` can reach: shared prefix,
    longest prompt and longest output."""
    return (int(mix.get("shared_prefix", 0)) + int(mix["prompt"]["max"])
            + int(mix["output"]["max"]))


def shared_prefix(mix: dict, seed: int, vocab: int) -> np.ndarray:
    """The prefix every prompt of a run starts with (empty if none)."""
    n = int(mix.get("shared_prefix", 0))
    rng = np.random.default_rng(sub_seed(seed, "prefix"))
    return rng.integers(1, vocab, size=n, dtype=np.int64).astype(np.int32)


def requests(mix: dict, seed: int, vocab: int, count: int) -> list[Req]:
    """The first ``count`` requests of a run of ``mix`` under ``seed``."""
    block = int(mix["block"])
    prompts = quantile_lengths(mix["prompt"], block)
    outputs = quantile_lengths(mix["output"], block)
    opening = quantile_lengths(
        dict(mix["output"], min=1, dist="uniform"), int(mix["clients"]))
    prefix = shared_prefix(mix, seed, vocab)
    rng = np.random.default_rng(sub_seed(seed, "requests"))
    order = rng
    if "order_seed" in mix:
        order = np.random.default_rng(sub_seed(int(mix["order_seed"]),
                                               "order"))
    opening = [opening[j] for j in order.permutation(len(opening))]
    out: list[Req] = []
    while len(out) < count:
        p_order = order.permutation(block)
        o_order = order.permutation(block)
        for j in range(block):
            i = len(out)
            if i >= count:
                break
            own = rng.integers(1, vocab, size=prompts[p_order[j]],
                               dtype=np.int64).astype(np.int32)
            n_out = opening[i] if i < len(opening) else outputs[o_order[j]]
            out.append(Req(i, np.concatenate([prefix, own]), n_out))
    return out


def warmup_prompt_lengths(mix: dict) -> list[int]:
    """One prompt length per prefill bucket the mix can reach (the
    engine's power-of-two buckets, floor 8), shortest first, without the
    shared prefix."""
    lo, hi = int(mix["prompt"]["min"]), int(mix["prompt"]["max"])
    out, b = [], 8
    while b < lo:
        b *= 2
    while True:
        out.append(min(b, hi))
        if b >= hi:
            return out
        b *= 2
