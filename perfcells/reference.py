"""The plain reference: the configuration's forward pass in float32, from
the seed's weights, with no kernel, no cache and no batching.

It imports nothing of the program. It quantizes the seed's weights
itself (symmetric, one scale per output channel over the reduction
axis, every matmul weight of at least ``min_values`` values, as the
configuration states) and multiplies the dequantized weights in float32
with TF32 off. It runs layer by layer over every
compared sequence, so each layer's weights are dequantized once and one
layer's float32 weights are live at a time. A prefix that every
sequence shares is run once and its keys and values are reused.

``precision`` names what the activations are held in: ``"f32"`` is the
reference; ``"bf16"`` and ``"fp8"`` round the inputs of every matmul
and the keys and values (bfloat16, or float8 e4m3 with one scale per
row), the control that sits one step below the configuration's
bfloat16.
"""
from __future__ import annotations

import math

import torch

from perfcells import weights as weights_mod

FP8_MAX = 448.0
Q_CHUNK = 1024


def _rounder(precision: str):
    if precision == "f32":
        return lambda x: x
    if precision == "bf16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    if precision == "fp8":
        def fp8(x):
            s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
            return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return fp8
    raise ValueError(f"unknown precision {precision!r}")


def dequantize(w: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """float32 weights after symmetric ``bits``-bit quantization with one
    scale per slice along ``axis`` (the reduction axis)."""
    qmax = (1 << (bits - 1)) - 1
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / qmax
    return torch.clamp(torch.round(wf / scale), -qmax, qmax) * scale


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, dh]: rotate the two halves of each head by the angles of
    ``pos`` [T]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * freqs
    s, c = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attend(q, k, v, q_pos, k_pos):
    """Causal GQA attention: q [Tq, H, dh], k/v [Tk, Hkv, dh]."""
    tq, h, dh = q.shape
    hkv = k.shape[1]
    qg = q.reshape(tq, hkv, h // hkv, dh)
    out = []
    for c in range(0, tq, Q_CHUNK):
        s = torch.einsum("qhgd,khd->hgqk", qg[c:c + Q_CHUNK], k)
        s = s / math.sqrt(dh)
        mask = k_pos[None, :] <= q_pos[c:c + Q_CHUNK, None]
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("hgqk,khd->qhgd", p, v))
    return torch.cat(out, dim=0).reshape(tq, h, dh)


class Segment:
    """Tokens run as one sequence from position ``offset``; ``prefix`` is
    the segment whose keys and values it attends to first, or None."""

    def __init__(self, tokens, offset: int = 0, prefix=None):
        self.tokens = tokens
        self.offset = offset
        self.prefix = prefix
        self.kv = None
        self.h = None

    @property
    def positions(self):
        return self.offset + torch.arange(len(self.tokens),
                                          device=self.tokens.device)


class Reference:
    """The forward pass of one configuration under one seed."""

    def __init__(self, arch: dict, seed: int, device, precision="f32"):
        self.arch, self.seed, self.device = arch, seed, device
        self.rnd = _rounder(precision)
        self.bits = arch["quant"]["bits"]
        self.min_values = arch["quant"]["min_values"]

    def _dequantize(self, w: torch.Tensor, axis: int) -> torch.Tensor:
        if w.numel() < self.min_values:
            return w.to(torch.float32)
        return dequantize(w, self.bits, axis)

    def _layer_weights(self, made: dict, i: int) -> dict:
        out = {}
        for kind, t in made.items():
            if not kind.startswith("blocks."):
                continue
            leaf = kind.split(".")[-1]
            if leaf == "router":
                out[leaf] = t[i].to(torch.float32)
            else:
                out[leaf] = self._dequantize(t[i], 0 if t[i].ndim == 2 else 1)
        return out

    def _attention(self, w: dict, seg: Segment) -> torch.Tensor:
        a = self.arch
        x = self.rnd(rms_norm(seg.h, a["norm_eps"]))
        t = x.shape[0]
        q = (x @ w["wq"]).reshape(t, a["n_heads"], a["head_dim"])
        k = (x @ w["wk"]).reshape(t, a["n_kv_heads"], a["head_dim"])
        v = (x @ w["wv"]).reshape(t, a["n_kv_heads"], a["head_dim"])
        pos = seg.positions
        q = rope(q, pos, a["rope_theta"])
        k = self.rnd(rope(k, pos, a["rope_theta"]))
        v = self.rnd(v)
        seg.kv = (k, v, pos)
        if seg.prefix is not None:
            pk, pv, ppos = seg.prefix.kv
            k, v = torch.cat([pk, k]), torch.cat([pv, v])
            pos_k = torch.cat([ppos, pos])
        else:
            pos_k = pos
        o = attend(q, k, v, pos, pos_k).reshape(t, -1)
        return self.rnd(o) @ w["wo"]

    def _mlp(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        a = self.arch
        if a["activation"] == "sq_relu":
            hid = torch.relu(x @ w["wu"]) ** 2
        else:
            hid = torch.nn.functional.silu(x @ w["wg"]) * (x @ w["wu"])
        return self.rnd(hid) @ w["wd"]

    def _moe(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        """Top-k routed experts, every routed token kept."""
        a = self.arch
        probs = torch.softmax(x @ w["router"], dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, experts = vals[:, :a["top_k"]], idx[:, :a["top_k"]]
        if a.get("norm_topk_prob", False):
            gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        out = torch.zeros_like(x)
        for e in range(a["n_experts"]):
            rows, slot = torch.nonzero(experts == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            hid = (torch.nn.functional.silu(xe @ w["w_gate"][e])
                   * (xe @ w["w_up"][e]))
            out.index_add_(0, rows, (self.rnd(hid) @ w["w_down"][e])
                           * gates[rows, slot][:, None])
        return out

    def _block(self, w: dict, seg: Segment) -> None:
        a = self.arch
        seg.h = seg.h + self._attention(w, seg)
        x = self.rnd(rms_norm(seg.h, a["norm_eps"]))
        ff = self._moe(w, x) if a["family"] == "moe" else self._mlp(w, x)
        seg.h = seg.h + ff

    @torch.no_grad()
    def logits(self, segments: list, rows: list) -> list:
        """Run ``segments`` (prefixes before the segments that use them)
        and return, for each (segment, row indices) of ``rows``, the
        float32 logits at those rows."""
        a = self.arch
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            made = weights_mod.make(a, self.seed, self.device)
            for seg in segments:
                seg.h = made["embed"][seg.tokens].to(torch.float32)
            for i in range(a["n_layers"]):
                w = self._layer_weights(made, i)
                for seg in segments:
                    self._block(w, seg)
                del w
            head = self._dequantize(made.pop("lm_head"), 0)
            del made
            out = []
            for seg, idx in rows:
                x = rms_norm(seg.h[idx], a["norm_eps"])
                out.append(self.rnd(x) @ head)
            return out
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
