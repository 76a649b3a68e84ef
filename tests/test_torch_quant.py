"""Port parity: SAMD packing in repro_torch is bit-identical to repro.

The same weights, made with numpy from a seed, are packed by both
packages; words are compared as uint32 bit patterns (the port holds them
as int32), scales and codes exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import samd as jsamd  # noqa: E402
from repro.models import build_template as j_build_template  # noqa: E402
from repro.models import quantize_params as j_quantize_params  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.quant import pack_weights as j_pack_weights  # noqa: E402
from repro.quant.packing import pack_int8_lanes as j_pack_int8  # noqa: E402
from repro.quant.packing import qmatmul as j_qmatmul  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.core import samd  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import QuantizedTensor  # noqa: E402
from repro_torch.models.model import build_template  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.quant import packing  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402

BITS = [2, 4, 8]
SPACERS = ["temporary", "permanent"]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("spacer", SPACERS)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k", [1024, 2816, 203])
def test_pack_weights_bit_identical(bits, spacer, k):
    """Includes K not a multiple of vpw (1024 at 4-bit permanent = 170
    words + 4 lanes) and non-power-of-two vpw (10, 6, 3)."""
    rng = np.random.default_rng(bits * 1000 + k)
    w = rng.normal(size=(k, 48)).astype(np.float32)
    jcfg = JQuantConfig(bits=bits, spacer=spacer)
    cfg = QuantConfig(bits=bits, spacer=spacer)
    jp, js = j_pack_weights(jnp.asarray(w), jcfg)
    tp, ts = packing.pack_weights(torch.from_numpy(w), cfg)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(_u32(tp), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # spacer bits (and lanes past K) stay zero
    fmt = samd.SAMDFormat(bits, cfg.lane_width)
    assert not (_u32(tp) & ~np.uint32(fmt.value_bits_mask)).any()
    codes = packing.unpack_weights(tp, k, cfg)
    want = np.clip(np.round(w / np.asarray(js)), -(2 ** (bits - 1) - 1),
                   2 ** (bits - 1) - 1)
    np.testing.assert_array_equal(codes.numpy(), want.astype(np.int32))
    deq = packing.dequant_weights(tp, ts, k, cfg, dtype=torch.float32)
    np.testing.assert_array_equal(deq.numpy(), want * np.asarray(js))


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("lane_width,bits", [(3, 2), (5, 4), (8, 8), (9, 8),
                                             (2, 2), (4, 4)])
def test_samd_pack_unpack_bit_identical(bits, lane_width, signed):
    rng = np.random.default_rng(bits * 7 + lane_width)
    lo, hi = ((-(2 ** (bits - 1)), 2 ** (bits - 1)) if signed
              else (0, 2 ** bits))
    vals = rng.integers(lo, hi, size=(5, 77)).astype(np.int32)
    jfmt = jsamd.SAMDFormat(bits, lane_width, signed=signed)
    fmt = samd.SAMDFormat(bits, lane_width, signed=signed)
    words = samd.pack(torch.from_numpy(vals), fmt)
    np.testing.assert_array_equal(
        _u32(words), np.asarray(jsamd.pack(jnp.asarray(vals), jfmt)))
    np.testing.assert_array_equal(samd.unpack(words, fmt, 77).numpy(), vals)


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 4, 64)])
def test_int8_lane_packing_bit_identical(shape):
    rng = np.random.default_rng(len(shape))
    vals = rng.integers(-128, 128, size=shape).astype(np.int8)
    words = packing.pack_int8_lanes(torch.from_numpy(vals))
    np.testing.assert_array_equal(
        _u32(words), np.asarray(j_pack_int8(jnp.asarray(vals))))
    back = packing.unpack_int8_lanes(words)
    np.testing.assert_array_equal(back.numpy(), vals.astype(np.int32))


@pytest.mark.parametrize("spacer", SPACERS)
@pytest.mark.parametrize("bits", BITS)
def test_quantize_params_packs_the_same_leaves(bits, spacer):
    """quantize_params packs the same leaves to the same words: linears of
    at least 2^16 values, never the tied embedding or the small norms."""
    import jax

    from repro.models import init_from_spec as j_init

    kw = dict(d_model=256, head_dim=64, d_ff=512, vocab=256)
    jcfg = j_smoke_config("qwen1.5-0.5b").scaled(**kw)
    cfg = smoke_config("qwen1.5-0.5b").scaled(**kw)
    jt = j_build_template(jcfg)
    raw = j_init(jt, jax.random.PRNGKey(bits))
    jq = j_quantize_params(raw, jt, JQuantConfig(bits=bits, spacer=spacer))
    tq = quantize_params(
        params_from_numpy(jax.tree.map(np.asarray, raw), device="cpu"),
        build_template(cfg), QuantConfig(bits=bits, spacer=spacer))
    assert not isinstance(tq["embed"], QuantizedTensor)
    n_packed = 0
    for jl, tl in zip(jq["blocks"], tq["blocks"]):
        for part in ("attn", "mlp"):
            for name, jw in jl[part].items():
                tw = tl[part][name]
                assert isinstance(tw, QuantizedTensor) == hasattr(
                    jw, "packed"), name
                if isinstance(tw, QuantizedTensor):
                    n_packed += 1
                    np.testing.assert_array_equal(_u32(tw.packed),
                                                  np.asarray(jw.packed))
                    np.testing.assert_array_equal(tw.scale.numpy(),
                                                  np.asarray(jw.scale))
    assert n_packed == 2 * 7


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_qmatmul_routes_match_jax(backend):
    """Both of the reference's qmatmul routes against the port's one
    route (the SAMD matmul kernel; its plain version here), through the
    weight bridge's ``quant_config``, on f32 activations: summation
    order only, so rtol = 1e-5 and atol = 1e-5 of the output scale. The
    bridge carries the rest of the config across."""
    from repro_torch.models.convert import quant_config

    rng = np.random.default_rng(3)
    k, n = 300, 40
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = rng.normal(size=(2, 3, k)).astype(np.float32)
    jcfg = JQuantConfig(bits=4, spacer="permanent", backend=backend)
    cfg = quant_config(jcfg)
    assert cfg == QuantConfig(bits=4, spacer="permanent")
    assert quant_config(JQuantConfig(bits=4, backend=backend,
                                     quantize_embeddings=True)) == \
        QuantConfig(bits=4, quantize_embeddings=True)
    jp, js = j_pack_weights(jnp.asarray(w), jcfg)
    want = np.asarray(j_qmatmul(jnp.asarray(x), jp, js, k, jcfg))
    tp, ts = packing.pack_weights(torch.from_numpy(w), cfg)
    got = packing.qmatmul(torch.from_numpy(x), tp, ts, k, cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
