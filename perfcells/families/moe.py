"""The MoE family: RoPE GQA attention and top-k routed SwiGLU experts in
every layer (olmoe-1b-7b). Each kind of leaf is drawn stacked over the
layers; the router is float32."""
from __future__ import annotations

import torch

from perfcells.families import _shared

# capacity_factor = n_experts / top_k: an expert can take every token of
# its group, so no token is dropped, as in the reference
SMALL = dict(n_layers=2, d_model=64, vocab=128, n_heads=4, n_kv_heads=4,
             head_dim=16, d_ff=96, n_experts=8, top_k=4, expert_d_ff=96,
             capacity_factor=2.0)


def leaf_shapes(arch: dict) -> dict:
    out = _shared.attention_leaves(arch)
    d, e, f = arch["d_model"], arch["n_experts"], arch["expert_d_ff"]
    bf16, std = torch.bfloat16, arch["init_std"]
    out["blocks.moe.router"] = ((d, e), torch.float32, std)
    out["blocks.moe.w_up"] = ((e, d, f), bf16, std)
    out["blocks.moe.w_down"] = ((e, f, d), bf16, std)
    if arch["activation"] == "swiglu":
        out["blocks.moe.w_gate"] = ((e, d, f), bf16, std)
    return out


def make(arch: dict, seed: int, device, kinds=None) -> dict:
    return _shared.make_stacked(arch, leaf_shapes(arch), seed, device, kinds)


def layers(arch: dict, seed: int, device):
    return _shared.stacked_layers(arch, leaf_shapes(arch), seed, device)


program_params = _shared.program_params
reference_layer = _shared.reference_layer


def experts(ref, w: dict, x: torch.Tensor) -> torch.Tensor:
    """Top-k routed experts, every routed token kept."""
    a = ref.arch
    probs = torch.softmax(x @ w["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, chosen = vals[:, :a["top_k"]], idx[:, :a["top_k"]]
    if a.get("norm_topk_prob", False):
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    out = torch.zeros_like(x)
    for e in range(a["n_experts"]):
        rows, slot = torch.nonzero(chosen == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        hid = (torch.nn.functional.silu(xe @ w["w_gate"][e])
               * (xe @ w["w_up"][e]))
        out.index_add_(0, rows, (ref.rnd(hid) @ w["w_down"][e])
                       * gates[rows, slot][:, None])
    return out


def block(ref, w: dict, seg) -> None:
    _shared.block(ref, w, seg, experts)


def ffn_params(arch: dict) -> int:
    """The routed experts a token uses (top_k of them) and the router."""
    n_mats = 3 if arch["activation"] == "swiglu" else 2
    d = arch["d_model"]
    return (arch["top_k"] * d * arch["expert_d_ff"] * n_mats
            + d * arch["n_experts"])


def matmul_params_per_token(arch: dict, head: bool = True) -> int:
    return _shared.matmul_params_per_token(arch, ffn_params(arch), head)


def token_flops(arch: dict, context: int) -> float:
    return _shared.token_flops(arch, context, matmul_params_per_token(arch))


def prefill_flops(arch: dict, start: int, length: int) -> float:
    return _shared.prefill_flops(arch, start, length,
                                 matmul_params_per_token(arch, head=False))
