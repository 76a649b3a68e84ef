"""Port parity: the lane-safety analysis.

The same inputs go through ``repro.analysis`` and
``repro_torch.analysis``; every verdict must be EQUAL field for field
(status, widths, intervals, the detail text), and so must exceptions'
types: the interpreter over hypothesis-drawn formats and programs
(Accumulate, ShiftRight and known kernels included),
``check_accumulation``, ``check_matmul_config`` with and without
``act_bits`` (the f32 exactness bound), ``check_conv_plan`` with
channels and known kernels, and ``model_reduction_depths``. The
certification sweep's VGG-B entries and its entries over the committed
``BENCH_serving.json`` must equal the reference's, entry for entry. The
shared-memory estimators are pure Python and checked here against the
H100 limit at every plan the port's launchers can take.
"""
import itertools
import pathlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.analysis import certify as j_certify  # noqa: E402
from repro.analysis import contracts as j_contracts  # noqa: E402
from repro.analysis import lanes as j_lanes  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.core.conv import ConvPlan as JConvPlan  # noqa: E402
from repro.core.samd import SAMDFormat as JSAMDFormat  # noqa: E402
from repro.models.model import build_template as j_build_template  # noqa
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro_torch.analysis import certify, contracts, lanes  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.configs.vggb import VGGB_LAYERS  # noqa: E402
from repro_torch.core.conv import ConvPlan  # noqa: E402
from repro_torch.core.samd import SAMDFormat  # noqa: E402
from repro_torch.kernels import samd_conv  # noqa: E402
from repro_torch.kernels import samd_matmul as mm  # noqa: E402
from repro_torch.models.model import build_template  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _outcome(fn):
    """(verdict dict) or (exception type name, message)."""
    try:
        return fn().to_dict()
    except Exception as e:  # noqa: BLE001 - types are compared
        return (type(e).__name__, str(e))


@st.composite
def formats(draw):
    bits = draw(st.integers(1, 16))
    lane = draw(st.integers(bits, min(32, bits + 12)))
    return bits, lane, draw(st.booleans())


def _op_pair(name, *args, **kw):
    return getattr(j_lanes, name)(*args, **kw), getattr(lanes, name)(
        *args, **kw)


@st.composite
def programs(draw, bits):
    """A straight-line program of the interpreter's ops (both packages'),
    not only canonical ones: ops in any order, some invalid."""
    ops = []
    for _ in range(draw(st.integers(1, 7))):
        kind = draw(st.sampled_from(
            ["Pack", "SignExtend", "MulKernel", "MulKernelK", "Accumulate",
             "ShiftRight", "BorrowFixup", "ReadWide", "ReadValue"]))
        if kind == "Pack":
            ops.append(_op_pair("Pack", bits=draw(st.sampled_from(
                [None, max(1, bits - 1), bits, bits + 1])),
                signed=draw(st.sampled_from([None, True, False]))))
        elif kind == "MulKernel":
            ops.append(_op_pair(
                "MulKernel", draw(st.integers(1, 9)),
                kernel_bits=draw(st.sampled_from([None, 1, 2, 4, 8])),
                kernel_signed=draw(st.sampled_from([None, True, False]))))
        elif kind == "MulKernelK":
            k = tuple(draw(st.lists(st.integers(-9, 9), min_size=1,
                                    max_size=9)))
            ops.append(_op_pair("MulKernel", len(k), kernel=k))
        elif kind == "Accumulate":
            ops.append(_op_pair("Accumulate", draw(st.integers(0, 4096))))
        elif kind == "ShiftRight":
            ops.append(_op_pair("ShiftRight", draw(st.integers(0, 8))))
        else:
            ops.append(_op_pair(kind))
    return ops


@settings(max_examples=300, deadline=None)
@given(st.data())
def test_interpret_verdicts_equal_the_reference(data):
    bits, lane, signed = data.draw(formats())
    prog = data.draw(programs(bits))
    depth = data.draw(st.integers(1, 1 << 16))
    want = _outcome(lambda: j_lanes.interpret(
        JSAMDFormat(bits, lane, signed), [j for j, _ in prog], depth))
    got = _outcome(lambda: lanes.interpret(
        SAMDFormat(bits, lane, signed), [t for _, t in prog], depth))
    assert got == want


@settings(max_examples=300, deadline=None)
@given(formats(), st.integers(1, 1 << 12), st.integers(1, 9),
       st.sampled_from([None, (3, -1, 2), (1, 1, 1, 1), (-7, 5), (0, 0)]),
       st.sampled_from([None, 1, 4, 8]), st.sampled_from([None, True, False]),
       st.sampled_from([None, 2, 4]), st.booleans())
def test_check_accumulation_equals_the_reference(fmt, depth, taps, kernel,
                                                  kbits, ksigned, in_bits,
                                                  fixup):
    bits, lane, signed = fmt
    kw = dict(taps=taps, kernel=None if kernel is None else np.array(kernel),
              kernel_bits=kbits, kernel_signed=ksigned,
              input_bits=None if in_bits is None else min(in_bits, bits),
              fixup=fixup)
    want = _outcome(lambda: j_lanes.check_accumulation(
        JSAMDFormat(bits, lane, signed), depth, **kw))
    got = _outcome(lambda: lanes.check_accumulation(
        SAMDFormat(bits, lane, signed), depth, **kw))
    assert got == want
    jp = j_lanes.accumulation_program(JSAMDFormat(bits, lane, signed), depth,
                                      **kw)
    tp = lanes.accumulation_program(SAMDFormat(bits, lane, signed), depth,
                                    **kw)
    assert [type(o).__name__ for o in tp] == [type(o).__name__ for o in jp]
    assert [vars(o) for o in tp] == [vars(o) for o in jp]


@settings(max_examples=400, deadline=None)
@given(st.integers(1, 16), st.sampled_from(["temporary", "permanent"]),
       st.sampled_from([None, 2, 4, 6, 8, 12, 16]),
       st.integers(1, 1 << 20), st.booleans())
def test_check_matmul_config_equals_the_reference(bits, spacer, act_bits, k,
                                                  signed):
    jcfg = JQuantConfig(bits=bits, spacer=spacer, act_bits=act_bits)
    cfg = QuantConfig(bits=bits, spacer=spacer, act_bits=act_bits)
    want = j_contracts.check_matmul_config(jcfg, k, signed=signed)
    got = contracts.check_matmul_config(cfg, k, signed=signed)
    assert got.to_dict() == want.to_dict()
    want = j_contracts.check_conv2d_config(jcfg, 3, 3, k, signed=signed)
    got = contracts.check_conv2d_config(cfg, 3, 3, k, signed=signed)
    assert got.to_dict() == want.to_dict()
    assert contracts._f32_exact_depth(cfg, signed) == (
        j_contracts._f32_exact_depth(jcfg, signed))


def test_act_bits_bound_refuses_deep_reductions():
    """8-bit codes x 8-bit activations are exact to depth 1024: the f32
    bound refuses K = 5120 (qwen3-14b's d_model) and passes K = 1024."""
    cfg = QuantConfig(bits=8, act_bits=8)
    assert contracts.check_matmul_config(cfg, 1024).ok
    v = contracts.check_matmul_config(cfg, 5120)
    assert not v.ok and v.status == lanes.NEEDS_SPACER
    assert not j_contracts.check_matmul_config(
        JQuantConfig(bits=8, act_bits=8), 5120).ok


@settings(max_examples=300, deadline=None)
@given(formats(), st.integers(1, 5), st.integers(1, 64),
       st.sampled_from([None, 2, 4]),
       st.sampled_from([None, (1, -2, 1), (3, 3, 3, -1, -1, -1)]))
def test_check_conv_plan_equals_the_reference(fmt, taps, channels, in_bits,
                                              kernel):
    bits, lane, signed = fmt
    in_bits = None if in_bits is None else min(in_bits, bits)
    k = None if kernel is None else np.array(kernel)
    want = _outcome(lambda: j_contracts.check_conv_plan(
        JConvPlan(JSAMDFormat(bits, lane, signed), taps), channels,
        kernel=k, input_bits=in_bits))
    got = _outcome(lambda: contracts.check_conv_plan(
        ConvPlan(SAMDFormat(bits, lane, signed), taps), channels, kernel=k,
        input_bits=in_bits))
    assert got == want


ALL_ARCHS = ["arctic-480b", "llava-next-mistral-7b", "musicgen-medium",
             "nemotron-4-15b", "olmoe-1b-7b", "qwen1.5-0.5b", "qwen1.5-32b",
             "qwen3-14b", "rwkv6-3b", "zamba2-7b"]


@pytest.mark.parametrize("respect", [False, True])
@pytest.mark.parametrize("qe", [None, False, True])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_reduction_depths_equal_the_reference(arch, qe, respect):
    wide = dict(d_model=256, head_dim=64, d_ff=512, vocab=256)
    jt = j_build_template(j_smoke_config(arch).scaled(**wide))
    tt = build_template(smoke_config(arch).scaled(**wide))
    jq = None if qe is None else JQuantConfig(quantize_embeddings=qe)
    tq = None if qe is None else QuantConfig(quantize_embeddings=qe)
    want = j_contracts.model_reduction_depths(jt, jq,
                                              respect_min_size=respect)
    got = contracts.model_reduction_depths(tt, tq, respect_min_size=respect)
    assert got == want and got


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_width_depths_and_verdicts_equal_the_reference(arch):
    """Every arch's full-width templates (the experts' 2048 and 1024,
    rwkv6's wv_c 8960, nemotron's wd 24576, zamba2's out_proj 7168 among
    them): the same reduction depths, and the same lane-safety verdict
    at each depth for 2, 4 and 8 bits, with and without 8-bit
    activations."""
    from repro.configs import get_arch as j_get_arch
    from repro_torch.configs.archs import get_arch

    jt = j_build_template(j_get_arch(arch), stacked=False)
    tt = build_template(get_arch(arch))
    want = j_contracts.model_reduction_depths(jt, respect_min_size=True)
    got = contracts.model_reduction_depths(tt, respect_min_size=True)
    assert got == want
    new_depths = {"olmoe-1b-7b": {2048, 1024}, "rwkv6-3b": {8960},
                  "nemotron-4-15b": {24576}, "zamba2-7b": {7168}}
    assert new_depths.get(arch, set()) <= set(got)
    for bits, act_bits, k in itertools.product((2, 4, 8), (None, 8), got):
        assert _outcome(lambda: contracts.check_matmul_config(
            QuantConfig(bits=bits, act_bits=act_bits), k)) == _outcome(
            lambda: j_contracts.check_matmul_config(
                JQuantConfig(bits=bits, act_bits=act_bits), k))


def test_certify_vggb_entries_equal_the_reference():
    assert certify.certify_vggb() == j_certify.certify_vggb()


def test_certify_serving_entries_equal_the_reference():
    bench = ROOT / "BENCH_serving.json"
    want = j_certify.certify_serving(bench)
    assert want and certify.certify_serving(bench) == want
    assert [n for n, _ in certify.SERVING_VARIANTS] == [
        n for n, _ in j_certify._serving_variant_table().items()][
        :len(certify.SERVING_VARIANTS)]


def test_certify_main_reports_no_unsafe(capsys):
    assert certify.main(["--bench", str(ROOT / "BENCH_serving.json")]) == 0
    assert "0 unsafe" in capsys.readouterr().out


# -- shared-memory estimators -------------------------------------------------
@pytest.mark.parametrize("launcher", [mm.SPLITK, mm.TILE])
def test_matmul_smem_fits_the_card_at_every_plan(launcher):
    ms = range(1, 33) if launcher == mm.SPLITK else (33, 64, 65, 1024, 4096)
    for vpw in (1, 2, 3, 4, 5, 6, 8, 10, 16, 32):
        for m in ms:
            for k, n in ((5120, 151936), (17408, 5120), (1024, 2816)):
                splits, _ = mm.split_k(m, n, k, vpw)
                b = contracts.matmul_smem_bytes(launcher, m, vpw, splits)
                assert 0 < b <= contracts.SMEM_LIMIT_BYTES, (vpw, m, b)


def test_conv_smem_fits_the_card_at_every_vggb_plan():
    for _, c_in, c_out, h, w in VGGB_LAYERS:
        for bits in (2, 4, 8, 12):
            cfg = QuantConfig(bits=bits)
            vpw = cfg.values_per_word
            for x_bf16 in (True, False):
                plan = samd_conv.conv2d_plan(c_in, -(-c_in // vpw), h, w, 3,
                                             3, c_out, 1, vpw, x_bf16)
                b = contracts.conv2d_smem_bytes(plan, vpw, wide=bits > 9)
                assert 0 < b <= contracts.SMEM_LIMIT_BYTES
    for bits in (2, 3, 4):
        for signed in (True, False):
            from repro_torch.core.samd import conv_format
            plan = ConvPlan(conv_format(bits, 3, signed), 3)
            for dtype in samd_conv.INT_CODES:
                c1 = samd_conv.conv1d_plan(3211264, plan, dtype)
                b = contracts.conv1d_smem_bytes(c1, dtype.itemsize)
                assert 0 < b <= 48 * 1024
