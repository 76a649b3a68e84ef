"""Port parity: the analytic cost model and the front door's admission
price.

``repro_torch.launch.analytic_costs.cell_cost`` copies the reference's
expressions for all four families in the same order, and the server's
refusals compare its floats, so every field must be EQUAL (``==``, not
close) to the reference's: for the reference's ten archs at full width
and at smoke width, decode, prefill and train shapes, weights at bf16 and
2, 4 and 8 bits, KV at bf16 and 8 bits. ``price_request`` likewise over a
grid of prompt length, ``max_tokens``, page size, ``max_len`` and
calibrated capacity.
"""
import dataclasses
import itertools

import pytest

pytest.importorskip("torch")

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.launch.analytic_costs import cell_cost as j_cell_cost  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.serving import price_request as j_price_request  # noqa: E402
from repro_torch.configs.archs import get_arch, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.analytic_costs import cell_cost  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402
from repro_torch.serving import price_request  # noqa: E402

ARCHS = ("arctic-480b", "llava-next-mistral-7b", "musicgen-medium",
         "nemotron-4-15b", "olmoe-1b-7b", "qwen1.5-0.5b", "qwen1.5-32b",
         "qwen3-14b", "rwkv6-3b", "zamba2-7b")
SHAPES = [("decode_32k", 32768, 128, "decode"),
          ("admission", 37, 1, "decode"),
          ("prefill_32k", 32768, 32, "prefill"),
          ("admission", 1, 1, "prefill"),
          ("train_4k", 4096, 256, "train"), ("tiny", 5, 3, "train")]


def _configs(arch, smoke):
    if smoke:
        return j_smoke_config(arch), smoke_config(arch)
    return j_get_arch(arch), get_arch(arch)


def _fields(c):
    return dataclasses.asdict(c), c.hbm_bytes


def _outcome(fn):
    """``fn()``'s fields, or the name of the exception it raised (the
    reference divides by an attention-free arch's head_dim 0 under 8-bit
    KV; the port must fail alike)."""
    try:
        return _fields(fn())
    except ArithmeticError as e:
        return type(e).__name__


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_cost_equals_reference(arch, smoke, kind):
    jcfg, cfg = _configs(arch, smoke)
    # the same architecture in both packages: every field the port has
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.uses_attention == jcfg.uses_attention
    shapes = [s for s in SHAPES if s[3] == kind]
    for shape, bits, kv_bits in itertools.product(shapes, (None, 2, 4, 8),
                                                  (None, 8)):
        got = _outcome(lambda: cell_cost(cfg, ShapeConfig(*shape), bits,
                                         kv_bits))
        want = _outcome(lambda: j_cell_cost(jcfg, JShapeConfig(*shape),
                                            bits, kv_bits))
        assert got == want, (shape, bits, kv_bits)


QUANTS = [
    (None, None),
    (JQuantConfig(enabled=False), QuantConfig(enabled=False)),
    (JQuantConfig(bits=4, backend="pallas"), QuantConfig(bits=4)),
    (JQuantConfig(bits=2, kv_bits=8), QuantConfig(bits=2, kv_bits=8)),
    (JQuantConfig(bits=8, kv_bits=8), QuantConfig(bits=8, kv_bits=8)),
]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("quant", range(len(QUANTS)))
def test_price_request_equals_reference(arch, quant):
    jq, q = QUANTS[quant]
    jcfg, cfg = _configs(arch, smoke=arch == "qwen3-14b")
    grid = itertools.product((0, 1, 5, 63, 64, 300), (1, 4, 32, 500),
                             (8, 16), (64, 512), (None, 0.0, 37.5, 2210.0))
    for prompt_len, max_tokens, page_size, max_len, cap in grid:
        kw = dict(page_size=page_size, max_len=max_len,
                  capacity_tokens_per_s=cap)
        got = _outcome(lambda: price_request(cfg, q, prompt_len,
                                             max_tokens, **kw))
        want = _outcome(lambda: j_price_request(jcfg, jq, prompt_len,
                                                max_tokens, **kw))
        assert got == want, (prompt_len, max_tokens, page_size, max_len,
                             cap)
