"""The dense family: RoPE GQA attention and a squared-ReLU or SwiGLU MLP
in every layer (nemotron-4-15b). Each kind of leaf is drawn stacked over
the layers."""
from __future__ import annotations

import torch

from perfcells.families import _shared

SMALL = dict(n_layers=2, d_model=64, vocab=128, n_heads=4, n_kv_heads=2,
             head_dim=16, d_ff=128)


def leaf_shapes(arch: dict) -> dict:
    out = _shared.attention_leaves(arch)
    d, f = arch["d_model"], arch["d_ff"]
    bf16, std = torch.bfloat16, arch["init_std"]
    out["blocks.mlp.wu"] = ((d, f), bf16, std)
    out["blocks.mlp.wd"] = ((f, d), bf16, std)
    if arch["activation"] == "swiglu":
        out["blocks.mlp.wg"] = ((d, f), bf16, std)
    return out


def make(arch: dict, seed: int, device, kinds=None) -> dict:
    return _shared.make_stacked(arch, leaf_shapes(arch), seed, device, kinds)


def layers(arch: dict, seed: int, device):
    return _shared.stacked_layers(arch, leaf_shapes(arch), seed, device)


program_params = _shared.program_params
reference_layer = _shared.reference_layer


def mlp(ref, w: dict, x: torch.Tensor) -> torch.Tensor:
    if ref.arch["activation"] == "sq_relu":
        hid = torch.relu(x @ w["wu"]) ** 2
    else:
        hid = torch.nn.functional.silu(x @ w["wg"]) * (x @ w["wu"])
    return ref.rnd(hid) @ w["wd"]


def block(ref, w: dict, seg) -> None:
    _shared.block(ref, w, seg, mlp)


def ffn_params(arch: dict) -> int:
    n_mats = 3 if arch["activation"] == "swiglu" else 2
    return arch["d_model"] * arch["d_ff"] * n_mats


def matmul_params_per_token(arch: dict, head: bool = True) -> int:
    return _shared.matmul_params_per_token(arch, ffn_params(arch), head)


def token_flops(arch: dict, context: int) -> float:
    return _shared.token_flops(arch, context, matmul_params_per_token(arch))


def prefill_flops(arch: dict, start: int, length: int) -> float:
    return _shared.prefill_flops(arch, start, length,
                                 matmul_params_per_token(arch, head=False))
