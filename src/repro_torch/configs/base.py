"""Architecture and shape configuration (the port's copy of
``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.quant.config import QuantConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture (public-literature config).

    Field names and defaults are the reference's, so a test can build the
    same configuration in both packages from the same keyword arguments.
    ``scan_layers`` is kept for that: the reference's scan-over-layers
    layout is unstacked by ``models.convert`` and the port's forward
    always loops over a list of layers.
    """

    name: str
    family: str            # 'dense' | 'moe' | 'rwkv6' | 'hybrid_mamba2'
    n_layers: int
    d_model: int
    vocab: int
    # attention (0 => attention-free arch)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    # MLP
    d_ff: int = 0
    activation: str = "swiglu"      # 'swiglu' | 'sq_relu' | 'gelu'
    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25
    moe_group_tokens: int = 2048
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0             # hybrid: shared attn block cadence
    # RWKV6
    rwkv_head_dim: int = 64
    lora_rank: int = 64
    # modality frontend stub
    frontend: str = "none"          # 'none' | 'audio' | 'vision'
    n_prefix_embeds: int = 0
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    subquadratic: bool = False      # can run long_500k
    attn_chunk: int = 1024
    scan_layers: bool = True

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def uses_attention(self) -> bool:
        return self.n_heads > 0

    def scaled(self, **overrides) -> "ArchConfig":
        """Reduced config of the same family (for CPU smoke tests)."""
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (the reference's fields): ``kind`` is
    'train', 'prefill' or 'decode'."""

    name: str
    seq_len: int
    global_batch: int
    kind: str


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything a training run needs besides the architecture (the
    reference's fields and defaults). ``remat`` is 'none' or 'block'
    (recompute each block in the backward pass)."""

    arch: ArchConfig
    shape: ShapeConfig
    quant: QuantConfig = QuantConfig(enabled=False)
    learning_rate: float = 3e-4
    lr_warmup: int = 100
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_accum: int = 1
    remat: str = "none"
    checkpoint_every: int = 100
    checkpoint_dir: Optional[str] = None
    seed: int = 0
