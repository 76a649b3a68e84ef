"""Dense architectures of the reference that the port runs (public
literature): qwen1.5-0.5b (the serving slice) and qwen3-14b (GQA with
qk_norm, G = 5 at full width and 4 at smoke width)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

# - QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]
QWEN15_05B = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, vocab=151936,
    n_heads=16, n_kv_heads=16, d_ff=2816,
    qkv_bias=True, tie_embeddings=True,
)

# - qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]
QWEN3_14B = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, vocab=151936,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=17408,
    qk_norm=True,
)

ARCHS: dict[str, ArchConfig] = {
    a.name: a for a in [QWEN15_05B, QWEN3_14B]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU tests (the reference's
    ``smoke_config`` for dense architectures)."""
    a = get_arch(name)
    return a.scaled(n_layers=2, d_model=64, vocab=128, attn_chunk=32,
                    n_heads=4,
                    n_kv_heads=max(1, 4 * a.n_kv_heads // a.n_heads),
                    head_dim=16, d_ff=128)
