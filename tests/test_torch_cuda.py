"""The CUDA kernels of repro_torch against their plain PyTorch versions.

Tests marked ``cuda`` need an NVIDIA GPU and skip without one (a CUDA
kernel has no CPU mode); on a card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference package, so it also runs
where only the port is installed.

Tolerance: kernel and plain version both accumulate in f32 and round the
output to bf16 (8 significant bits) in different orders, so they may be
a rounding step or two apart: rtol = atol = 2e-2 of the output scale.
Packed codes read back through the matmul are compared exactly.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.core import samd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import samd_matmul as mm  # noqa: E402
from repro_torch.models.model import forward, init_paged_cache  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.models.model import build_template  # noqa: E402
from repro_torch.models.spec import init_from_spec  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402
from repro_torch.quant.packing import (  # noqa: E402
    pack_int8_lanes, pack_weights, unpack_weights,
)

TOL = 2e-2


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, tol=TOL):
    got, want = got.float().cpu(), want.float().cpu()
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    gen = torch.Generator().manual_seed(0)
    cfg = QuantConfig(bits=4)
    packed, scale = pack_weights(torch.randn(40, 8, generator=gen), cfg)
    x = torch.randn(3, 40, generator=gen)
    before = ops.launch_counts()
    out = ops.samd_matmul(x, packed, scale, 40, cfg)
    assert ops.launch_counts() == before
    _close(out, mm.samd_matmul_plain(x, packed, scale, 40, cfg), 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("bits,spacer", [(2, "temporary"), (2, "permanent"),
                                         (4, "temporary"), (4, "permanent"),
                                         (8, "temporary"), (8, "permanent")])
@pytest.mark.parametrize("m,k,n", [(8, 1024, 96), (300, 2816, 70),
                                   (5, 203, 64)])
def test_samd_matmul_kernel_matches_plain(cuda, m, k, n, bits, spacer,
                                          signed):
    """Ragged K and N, non-power-of-two vpw, unsigned lanes."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + bits)
    cfg = QuantConfig(bits=bits, spacer=spacer)
    if signed:
        packed, scale = pack_weights(
            torch.randn(k, n, generator=gen, device=cuda), cfg)
    else:
        codes = torch.randint(0, 2 ** bits, (n, k), generator=gen,
                              device=cuda)
        fmt = samd.SAMDFormat(bits, cfg.lane_width, signed=False)
        packed = samd.pack(codes, fmt).t().contiguous()
        scale = torch.rand(1, n, generator=gen, device=cuda)
    x = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
    before = mm.KERNEL.launches
    got = ops.samd_matmul(x, packed, scale, k, cfg, signed=signed)
    assert mm.KERNEL.launches == before + 1
    _close(got, mm.samd_matmul_plain(x, packed, scale, k, cfg,
                                     signed=signed))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,spacer", [(4, "permanent"), (2, "temporary")])
def test_samd_matmul_kernel_reads_codes_exactly(cuda, bits, spacer):
    cfg = QuantConfig(bits=bits, spacer=spacer)
    k = 1024
    packed, _ = pack_weights(torch.randn(k, 64, device=cuda), cfg)
    x = torch.eye(k, device=cuda, dtype=torch.bfloat16)
    got = ops.samd_matmul(x, packed, torch.ones(64, device=cuda), k, cfg)
    assert torch.equal(got.float(), unpack_weights(packed, k, cfg).float())


@pytest.mark.cuda
def test_samd_matmul_kernel_refuses_what_it_does_not_take(cuda):
    cfg = QuantConfig(bits=4)
    packed, scale = pack_weights(torch.randn(64, 8, device=cuda), cfg)
    with pytest.raises(TypeError):
        ops.samd_matmul(torch.randn(2, 64, device=cuda), packed, scale, 64,
                        cfg)


def _paged_inputs(dev, gen, b, hkv, g, dh, ps, n_pp, packed):
    n_pages = b * n_pp
    perm = torch.randperm(n_pages, generator=gen, device=dev).int()
    pt = torch.full((b, n_pp), -1, dtype=torch.int32, device=dev)
    pos = torch.zeros(b, dtype=torch.int32, device=dev)
    for i in range(b):
        if i == 1:
            continue  # the empty slot
        ln = int(torch.randint(0, n_pp * ps, (1,), generator=gen,
                               device=dev))
        pt[i, :ln // ps + 1] = perm[i * n_pp:i * n_pp + ln // ps + 1]
        pos[i] = ln
    q = torch.randn(b, hkv * g, dh, generator=gen, device=dev)
    shape = (n_pages, ps, hkv, dh)
    if packed:
        def pool():
            v = torch.randint(-127, 128, shape, generator=gen, device=dev)
            return pack_int8_lanes(v.to(torch.int8))

        kw = {n: torch.rand(shape[:3], generator=gen, device=dev) * 0.02
              for n in ("k_scale", "v_scale")}
        return (q.to(torch.bfloat16), pool(), pool(), pt, pos), kw
    kv = torch.randn((2,) + shape, generator=gen, device=dev)
    kv = kv.to(torch.bfloat16)
    return (q.to(torch.bfloat16), kv[0], kv[1], pt, pos), {}


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("hkv,g,dh,ps", [(16, 1, 64, 16), (4, 4, 64, 16),
                                         (2, 2, 128, 8)])
def test_paged_attention_kernel_matches_plain(cuda, hkv, g, dh, ps, packed):
    gen = torch.Generator(device=cuda).manual_seed(hkv * g + packed)
    args, kw = _paged_inputs(cuda, gen, 6, hkv, g, dh, ps, 5, packed)
    before = pa.KERNEL.launches
    got = ops.paged_decode_attention(*args, **kw)
    assert pa.KERNEL.launches == before + 1
    _close(got, pa.paged_decode_attention_plain(*args, **kw))
    assert (got[1] == 0).all(), "a slot with no valid key emits zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [None, 8])
def test_forward_on_card_matches_plain_on_cpu(cuda, kv_bits):
    """GQA smoke model, 4-bit weights: prefill then a fused decode token,
    through the kernels on the card and the plain versions on the CPU."""
    cfg = smoke_config("qwen3-14b").scaled(d_model=256, head_dim=64,
                                           d_ff=512, vocab=256)
    gen = torch.Generator().manual_seed(0)
    raw = init_from_spec(build_template(cfg), gen, device="cpu")
    params = quantize_params(raw, build_template(cfg),
                             QuantConfig(bits=4, kv_bits=kv_bits))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        if hasattr(tree, "packed"):
            return type(tree)(tree.packed.to(dev), tree.scale.to(dev),
                              tree.orig_shape, tree.axis, tree.cfg)
        return tree.to(dev)

    toks = torch.randint(0, 256, (2, 12), generator=gen)
    pos = torch.where(torch.arange(12)[None] < torch.tensor([[12], [7]]),
                      torch.arange(12)[None], -1)
    pt = torch.tensor([[2, 0], [1, 3]], dtype=torch.int32)
    dec = torch.randint(0, 256, (2, 1), generator=gen)
    dpos = torch.tensor([[12], [7]])
    outs = []
    for dev in (cuda, torch.device("cpu")):
        p = to(params, dev)
        cache = init_paged_cache(cfg, 4, 8, kv_bits=kv_bits, device=dev)
        pre = forward(p, toks.to(dev), cfg, positions=pos.to(dev),
                      cache=cache, page_table=pt.to(dev), page_size=8)
        nxt = forward(p, dec.to(dev), cfg, positions=dpos.to(dev),
                      cache=cache, page_table=pt.to(dev), page_size=8,
                      paged_attn="fused")
        outs.append((pre.cpu()[pos >= 0], nxt.cpu()))
    for a, b in zip(*outs):
        _close(a, b, 5e-2)
