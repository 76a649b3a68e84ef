"""Seeded weights of a configuration, made on the device.

Each kind of leaf is one tensor holding every layer's copy (``[L, ...]``),
drawn in one call from a generator of its own, so the program's weights
and the reference's are the same numbers, and the reference can make
them again after the program's are freed. Matmul weights are N(0, std)
in bfloat16 (the router in float32), the embedding N(0, embed_std),
norm weights ones. Imports nothing of the program.
"""
from __future__ import annotations

import torch

from perfcells.traffic import sub_seed


def leaf_shapes(arch: dict) -> dict:
    """{leaf kind: (shape of one layer's leaf, dtype, std)}: ``blocks.*``
    kinds hold one per layer, the others one."""
    d, v = arch["d_model"], arch["vocab"]
    h, hkv, dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    bf16, std = torch.bfloat16, arch["init_std"]
    out = {
        "embed": ((v, d), bf16, arch["embed_std"]),
        "lm_head": ((d, v), bf16, std),
        "blocks.attn.wq": ((d, h * dh), bf16, std),
        "blocks.attn.wk": ((d, hkv * dh), bf16, std),
        "blocks.attn.wv": ((d, hkv * dh), bf16, std),
        "blocks.attn.wo": ((h * dh, d), bf16, std),
    }
    if arch["family"] == "dense":
        f = arch["d_ff"]
        out["blocks.mlp.wu"] = ((d, f), bf16, std)
        out["blocks.mlp.wd"] = ((f, d), bf16, std)
        if arch["activation"] == "swiglu":
            out["blocks.mlp.wg"] = ((d, f), bf16, std)
    elif arch["family"] == "moe":
        e, f = arch["n_experts"], arch["expert_d_ff"]
        out["blocks.moe.router"] = ((d, e), torch.float32, std)
        out["blocks.moe.w_up"] = ((e, d, f), bf16, std)
        out["blocks.moe.w_down"] = ((e, f, d), bf16, std)
        if arch["activation"] == "swiglu":
            out["blocks.moe.w_gate"] = ((e, d, f), bf16, std)
    else:
        raise ValueError(f"no weights for family {arch['family']!r}")
    return out


def make(arch: dict, seed: int, device, kinds=None) -> dict:
    """{leaf kind: tensor}, ``blocks.*`` kinds stacked over the layers."""
    out = {}
    for kind, (shape, dtype, std) in leaf_shapes(arch).items():
        if kinds is not None and kind not in kinds:
            continue
        if kind.startswith("blocks."):
            shape = (arch["n_layers"],) + shape
        gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, "weights", kind))
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        out[kind] = t.mul_(std)
    return out


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
