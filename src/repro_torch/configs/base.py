"""Architecture and shape configuration (the dense subset of
``repro.configs.base``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One dense decoder architecture (public-literature config).

    Field names and defaults are the reference's, so a test can build the
    same configuration in both packages from the same keyword arguments.
    """

    name: str
    family: str            # only 'dense' in the port so far
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    d_ff: int = 0
    activation: str = "swiglu"      # only 'swiglu' is ported
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_chunk: int = 1024

    def __post_init__(self):
        if self.family != "dense":
            raise ValueError(
                f"the port runs dense decoders only, got {self.family!r}"
            )
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
