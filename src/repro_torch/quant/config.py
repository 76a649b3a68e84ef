"""Quantization configuration (the port's copy of ``repro.quant.config``)."""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Per-model quantization policy.

    bits:     weight precision (the paper sweeps 8 -> 2).
    enabled:  master switch; False = bf16 weights everywhere.
    spacer:   'permanent' keeps one guard bit per lane (32/(b+1) values
              per word); 'temporary' packs dense (32/b values per word).
    kv_bits:  8 = the paged KV pool holds SAMD-packed int8 lanes with a
              per-(token, kv-head) scale; None = bf16 pool.

    Packed linears always run the SAMD matmul kernel
    (``kernels.ops.samd_matmul``, the reference's ``backend="pallas"``);
    embeddings and the LM head stay bf16. Per-group scales, quantized
    embeddings and activation fake-quant (training) are not part of the
    port yet.
    """

    bits: int = 4
    enabled: bool = True
    spacer: Literal["permanent", "temporary"] = "temporary"
    kv_bits: Optional[int] = None

    @property
    def lane_width(self) -> int:
        return self.bits + (1 if self.spacer == "permanent" else 0)

    @property
    def values_per_word(self) -> int:
        return 32 // self.lane_width

    def __post_init__(self):
        if not (1 <= self.bits <= 16):
            raise ValueError(f"bits out of range: {self.bits}")
        if self.spacer not in ("permanent", "temporary"):
            raise ValueError(
                f"unknown spacer regime {self.spacer!r}; known: "
                "permanent, temporary"
            )
        if self.kv_bits not in (None, 8):
            raise ValueError(f"kv_bits must be None or 8, got {self.kv_bits}")
