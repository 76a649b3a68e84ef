"""The reference's 10 architectures, exactly as it specifies them (public
literature), and their reduced same-family configs for CPU tests.
``subquadratic`` marks the recurrent families (SSM / hybrid)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

# - Finch: data-dependent decay, attention-free [arXiv:2404.05892; hf]
RWKV6_3B = ArchConfig(
    name="rwkv6-3b", family="rwkv6",
    n_layers=32, d_model=2560, d_ff=8960, vocab=65536,
    rwkv_head_dim=64, lora_rank=64, subquadratic=True,
)

# - Mamba2 + shared attention blocks [arXiv:2411.15242; unverified]
ZAMBA2_7B = ArchConfig(
    name="zamba2-7b", family="hybrid_mamba2",
    n_layers=81, d_model=3584, vocab=32000,
    n_heads=32, n_kv_heads=32, d_ff=14336,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    attn_every=6, subquadratic=True,
)

# - QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]
QWEN15_05B = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, vocab=151936,
    n_heads=16, n_kv_heads=16, d_ff=2816,
    qkv_bias=True, tie_embeddings=True,
)

# - QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]
QWEN15_32B = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, vocab=152064,
    n_heads=40, n_kv_heads=40, d_ff=27392,
    qkv_bias=True,
)

# - GQA, squared-ReLU [arXiv:2402.16819; unverified]
NEMOTRON4_15B = ArchConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, vocab=256000,
    n_heads=48, n_kv_heads=8, d_ff=24576,
    activation="sq_relu",
)

# - qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]
QWEN3_14B = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, vocab=151936,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=17408,
    qk_norm=True,
)

# - decoder-only over EnCodec tokens [arXiv:2306.05284; hf]
MUSICGEN_MEDIUM = ArchConfig(
    name="musicgen-medium", family="dense",
    n_layers=48, d_model=1536, vocab=2048,
    n_heads=24, n_kv_heads=24, d_ff=6144,
    activation="gelu", frontend="audio",
)

# - 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base; hf]
ARCTIC_480B = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, vocab=32000,
    n_heads=56, n_kv_heads=8, d_ff=4864,
    n_experts=128, top_k=2, expert_d_ff=4864, dense_residual=True,
)

# - 64 experts top-8 [arXiv:2409.02060; hf]
OLMOE_1B_7B = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, vocab=50304,
    n_heads=16, n_kv_heads=16, d_ff=1024,
    n_experts=64, top_k=8, expert_d_ff=1024,
)

# - anyres tiling (vision frontend stubbed as patch embeddings)
#   [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
LLAVA_NEXT_MISTRAL_7B = ArchConfig(
    name="llava-next-mistral-7b", family="dense",
    n_layers=32, d_model=4096, vocab=32000,
    n_heads=32, n_kv_heads=8, d_ff=14336,
    frontend="vision", n_prefix_embeds=576,
)

ARCHS: dict[str, ArchConfig] = {
    a.name: a
    for a in [
        RWKV6_3B, ZAMBA2_7B, QWEN15_05B, QWEN15_32B, NEMOTRON4_15B,
        QWEN3_14B, MUSICGEN_MEDIUM, ARCTIC_480B, OLMOE_1B_7B,
        LLAVA_NEXT_MISTRAL_7B,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU tests (the reference's
    ``smoke_config``, the unrolled layer layout)."""
    a = get_arch(name)
    common = dict(n_layers=2, d_model=64, vocab=128, attn_chunk=32,
                  scan_layers=False)
    if a.family == "dense":
        return a.scaled(**common, n_heads=4,
                        n_kv_heads=max(1, 4 * a.n_kv_heads // a.n_heads),
                        head_dim=16, d_ff=128,
                        n_prefix_embeds=4 if a.frontend == "vision" else 0)
    if a.family == "moe":
        return a.scaled(**common, n_heads=4,
                        n_kv_heads=max(1, 4 * a.n_kv_heads // a.n_heads),
                        head_dim=16, d_ff=96, n_experts=8,
                        top_k=min(a.top_k, 4), expert_d_ff=96,
                        moe_group_tokens=64)
    if a.family == "rwkv6":
        return a.scaled(**common, d_ff=128, rwkv_head_dim=16, lora_rank=8)
    if a.family == "hybrid_mamba2":
        hybrid = dict(common, n_layers=4)
        return a.scaled(**hybrid, n_heads=4, n_kv_heads=4,
                        head_dim=16, d_ff=128, ssm_state=16, ssm_head_dim=16,
                        attn_every=2)
    raise ValueError(a.family)
