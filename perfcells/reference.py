"""The plain reference: the configuration's forward pass in float32, from
the seed's weights, with no kernel, no cache and no batching. Its layer
is the configuration's family's (``families/<family>.py``); what is
here is the frame around it and what the layers share.

It imports nothing of the program. It quantizes the seed's weights
itself (symmetric, one scale per output channel over the reduction
axis, every matmul weight of at least ``min_values`` values, as the
configuration states) and multiplies the dequantized weights in float32
with TF32 off. It runs layer by layer over every
compared sequence, so each layer's weights are dequantized once and one
layer's float32 weights are live at a time (one layer's bfloat16 ones
too, where the family draws a layer at a time). A prefix that every
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

from perfcells import families
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
    """The forward pass of one configuration under one seed; the layer is
    the family's (``families/<family>.py``)."""

    def __init__(self, arch: dict, seed: int, device, precision="f32"):
        self.arch, self.seed, self.device = arch, seed, device
        self.rnd = _rounder(precision)
        self.bits = arch["quant"]["bits"]
        self.min_values = arch["quant"]["min_values"]
        self.family = families.load(arch["family"])

    def weight(self, w: torch.Tensor, axis: int) -> torch.Tensor:
        """A matmul weight as the reference multiplies it: float32, after
        the configuration's quantization over ``axis`` where it has
        ``min_values`` values or more."""
        if w.numel() < self.min_values:
            return w.to(torch.float32)
        return dequantize(w, self.bits, axis)

    @torch.no_grad()
    def logits(self, segments: list, rows: list) -> list:
        """Run ``segments`` (prefixes before the segments that use them)
        and return, for each (segment, row indices) of ``rows``, the
        float32 logits at those rows."""
        a, fam = self.arch, self.family
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            embed = weights_mod.make(a, self.seed, self.device,
                                     ["embed"])["embed"]
            for seg in segments:
                seg.h = embed[seg.tokens].to(torch.float32)
            del embed
            for leaves in weights_mod.layers(a, self.seed, self.device):
                w = fam.reference_layer(self, leaves)
                del leaves
                for seg in segments:
                    fam.block(self, w, seg)
                del w
            head = self.weight(weights_mod.make(
                a, self.seed, self.device, ["lm_head"])["lm_head"], 0)
            out = []
            for seg, idx in rows:
                x = rms_norm(seg.h[idx], a["norm_eps"])
                out.append(self.rnd(x) @ head)
            return out
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
