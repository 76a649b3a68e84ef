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
    group_size: scale granularity along the reduction axis; None = one
              scale per output channel.
    quantize_embeddings: pack the leaves with a 'vocab' axis too (an
              untied LM head; the embedding table is never a matmul
              weight of the forward); False keeps them bf16.
    act_bits: bit width of quantized activations; None = float. It has
              no effect on the forward: the lane-safety analysis reads
              it (``analysis.contracts``: the f32 accumulator's
              integer-exactness bound).
    kv_bits:  8 = the KV cache holds int8 lanes with a per-(token,
              kv-head) scale (SAMD-packed words in the paged pool);
              None = bf16.

    An ungrouped packed linear runs the SAMD matmul kernel
    (``kernels.ops.samd_matmul``); a group-scaled one is dequantized and
    multiplied with ``torch.matmul`` (``quant.packing.qmatmul``). The
    reference's ``backend`` field has no counterpart: the port has one
    route for each scale layout.
    """

    bits: int = 4
    enabled: bool = True
    spacer: Literal["permanent", "temporary"] = "temporary"
    group_size: Optional[int] = None
    quantize_embeddings: bool = False
    act_bits: Optional[int] = None
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
