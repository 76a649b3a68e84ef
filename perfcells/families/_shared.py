"""What the attention families (``dense``, ``moe``) share: the RoPE GQA
attention's leaves, the draw of each kind of leaf stacked over the
layers, the program's parameter tree, the reference's attention and
layer, and the operations of attention and of the matmuls around it."""
from __future__ import annotations

import torch

from perfcells import weights as weights_mod
from perfcells.reference import Segment, attend, rms_norm, rope


def attention_leaves(arch: dict) -> dict:
    """The embedding, the LM head and the attention's leaves (the MLP or
    experts are the family's)."""
    d, v = arch["d_model"], arch["vocab"]
    h, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    bf16, std = torch.bfloat16, arch["init_std"]
    return {
        "embed": ((v, d), bf16, arch["embed_std"]),
        "lm_head": ((d, v), bf16, std),
        "blocks.attn.wq": ((d, h * dh), bf16, std),
        "blocks.attn.wk": ((d, hkv * dh), bf16, std),
        "blocks.attn.wv": ((d, hkv * dh), bf16, std),
        "blocks.attn.wo": ((h * dh, d), bf16, std),
    }


def make_stacked(arch: dict, shapes: dict, seed: int, device,
                 kinds=None) -> dict:
    """{leaf kind: tensor}, ``blocks.*`` kinds stacked over the layers
    (``[L, ...]``), each kind drawn in one call."""
    out = {}
    for kind, (shape, dtype, std) in shapes.items():
        if kinds is not None and kind not in kinds:
            continue
        if kind.startswith("blocks."):
            shape = (arch["n_layers"],) + shape
        out[kind] = weights_mod.draw(seed, (kind,), shape, dtype, std,
                                     device)
    return out


def stacked_layers(arch: dict, shapes: dict, seed: int, device):
    """Each layer's leaves, as views of the stacked draw."""
    made = make_stacked(arch, shapes, seed, device,
                        [k for k in shapes if k.startswith("blocks.")])
    for i in range(arch["n_layers"]):
        yield {kind: t[i] for kind, t in made.items()}


def program_params(arch: dict, made: dict, device) -> dict:
    """The program's parameter tree (``blocks`` a list of per-layer
    dicts) over views of ``made``, with norm weights of ones."""
    d, dh = arch["d_model"], arch["head_dim"]
    layers = []
    for i in range(arch["n_layers"]):
        layer: dict = {}
        for kind, t in made.items():
            if not kind.startswith("blocks."):
                continue
            _, block, leaf = kind.split(".")
            layer.setdefault(block, {})[leaf] = t[i]
        for block in layer:
            layer[block]["ln"] = torch.ones(d, dtype=torch.bfloat16,
                                            device=device)
        if arch.get("qk_norm"):
            for leaf in ("q_norm", "k_norm"):
                layer["attn"][leaf] = torch.ones(dh, dtype=torch.bfloat16,
                                                 device=device)
        layers.append(layer)
    return {"embed": made["embed"], "lm_head": made["lm_head"],
            "final_ln": torch.ones(d, dtype=torch.bfloat16, device=device),
            "blocks": layers}


def reference_layer(ref, leaves: dict) -> dict:
    """{leaf name: float32 weight}: the router as drawn, every other
    leaf quantized over its reduction axis."""
    out = {}
    for kind, t in leaves.items():
        leaf = kind.split(".")[-1]
        if leaf == "router":
            out[leaf] = t.to(torch.float32)
        else:
            out[leaf] = ref.weight(t, 0 if t.ndim == 2 else 1)
    return out


def attention(ref, w: dict, seg: Segment) -> torch.Tensor:
    a = ref.arch
    x = ref.rnd(rms_norm(seg.h, a["norm_eps"]))
    t = x.shape[0]
    q = (x @ w["wq"]).reshape(t, a["n_heads"], a["head_dim"])
    k = (x @ w["wk"]).reshape(t, a["n_kv_heads"], a["head_dim"])
    v = (x @ w["wv"]).reshape(t, a["n_kv_heads"], a["head_dim"])
    pos = seg.positions
    q = rope(q, pos, a["rope_theta"])
    k = ref.rnd(rope(k, pos, a["rope_theta"]))
    v = ref.rnd(v)
    seg.kv = (k, v, pos)
    if seg.prefix is not None:
        pk, pv, ppos = seg.prefix.kv
        k, v = torch.cat([pk, k]), torch.cat([pv, v])
        pos_k = torch.cat([ppos, pos])
    else:
        pos_k = pos
    o = attend(q, k, v, pos, pos_k).reshape(t, -1)
    return ref.rnd(o) @ w["wo"]


def block(ref, w: dict, seg: Segment, ffn) -> None:
    """Attention, then ``ffn(ref, w, x)`` of the normed residual."""
    a = ref.arch
    seg.h = seg.h + attention(ref, w, seg)
    x = ref.rnd(rms_norm(seg.h, a["norm_eps"]))
    seg.h = seg.h + ffn(ref, w, x)


def matmul_params_per_token(arch: dict, ffn_params: int,
                            head: bool = True) -> int:
    """Weights one token multiplies through: each layer's attention
    projections and ``ffn_params``, the LM head unless ``head`` is False;
    the embedding gather is no matmul."""
    d, h, hkv, dh = (arch["d_model"], arch["n_heads"], arch["n_kv_heads"],
                     arch["head_dim"])
    per_layer = d * h * dh + 2 * d * hkv * dh + h * dh * d + ffn_params
    return arch["n_layers"] * per_layer + (d * arch["vocab"] if head else 0)


def token_flops(arch: dict, context: int, params: int) -> float:
    """Operations of one token through ``params`` matmul weights that
    attends to ``context`` keys in every layer."""
    attn = 4.0 * arch["n_layers"] * arch["n_heads"] * arch["head_dim"]
    return 2.0 * params + attn * context


def prefill_flops(arch: dict, start: int, length: int, body: int) -> float:
    """Operations of prefilling positions start .. start+length-1 through
    ``body`` matmul weights (the LM head apart), each attending causally
    to every position before it and itself; the LM head runs for the
    last position alone (its first token)."""
    ctx = length * start + length * (length + 1) / 2
    attn = 4.0 * arch["n_layers"] * arch["n_heads"] * arch["head_dim"]
    head = 2.0 * arch["d_model"] * arch["vocab"]
    return 2.0 * body * length + head + attn * ctx
