"""The port's sharded steps beyond the dense model, on four gloo ranks
on the CPU: one train step of each other family (RWKV6, the Mamba2
hybrid, MoE) and a 4-bit SAMD-packed decode, each on the (2, 2)
("data", "model") mesh of ``tests/test_torch_distributed.py`` (whose
rank spawner, mesh and tolerances it uses), against the port's
unsharded step on every rank.

Tolerances: ``tests/test_torch_distributed.py``'s (loss 1e-4, gradient
norm 5e-3 relative; every updated element within 2 lr (1 + wd |p|)
plus one bf16 step of the larger of the two results, since a gradient
element near 0 may take the other sign); the packed decode's greedy ids
exactly (each rank's own words, the same products).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("torch.distributed")

from test_torch_distributed import (  # noqa: E402
    BATCH, GNORM_TOL, LOSS_TOL, PREFILL, SEQ, TRAIN_KW, _batch, _bf16_ulp,
    _cfg, _mesh, _spawn,
)


# the other families at smoke width, wide enough that the model axis
# splits RWKV6's and Mamba2's heads and the MoE's experts
FAMILIES = {"rwkv6-3b": dict(d_model=128, vocab=256),
            "zamba2-7b": dict(d_model=64, vocab=256),
            "olmoe-1b-7b": dict(d_model=64, vocab=256)}


def _family_step_ranks(rank, out_dir, arch):
    from repro_torch.configs.archs import smoke_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models.model import build_template
    from repro_torch.models.spec import init_from_spec
    from repro_torch.optim import adamw_init
    from repro_torch.tree import named_leaves

    mesh = _mesh()
    cfg = smoke_config(arch).scaled(**FAMILIES[arch])
    tmpl = build_template(cfg)
    params = init_from_spec(tmpl, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (BATCH, SEQ)).astype(np.int32))
        for k in ("tokens", "targets")}
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", SEQ, BATCH, "train"),
                    **TRAIN_KW)
    step = steps.make_train_step(cfg, run)
    want_p, _, want_m = step(params, adamw_init(params), batch)
    dp = sh.distribute(params, sh.placements(sh.param_pspecs(tmpl, mesh),
                                             mesh))
    blay = sh.placements(sh.data_pspec(BATCH, mesh), mesh)
    db = {k: sh.distribute(v, blay) for k, v in batch.items()}
    got_p, _, got_m = step(dp, adamw_init(dp), db)
    loss = got_m["loss"].full_tensor().item()
    gnorm = got_m["grad_norm"].full_tensor().item()
    assert abs(loss - want_m["loss"].item()) <= LOSS_TOL * abs(loss), arch
    assert abs(gnorm - want_m["grad_norm"].item()) <= GNORM_TOL * gnorm, (
        arch, gnorm, want_m["grad_norm"].item())
    lr = want_m["lr"].item()
    for (name, g), (_, w), (_, p0) in zip(
            named_leaves(got_p), named_leaves(want_p), named_leaves(params)):
        g, w = g.full_tensor().float(), w.float()
        # a sign flip of a gradient near 0 moves the element 2 lr the
        # other way: one bf16 step of the larger of the two results
        tol = 2 * lr * (1 + 0.1 * p0.float().abs()) + _bf16_ulp(
            torch.maximum(g.abs(), w.abs()))
        assert ((g - w).abs() <= tol).all(), (arch, name)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_family_train_step_sharded_matches_unsharded(tmp_path, arch):
    """One sharded train step of each other family on the (2, 2) mesh
    (RWKV6's and Mamba2's scans on each rank's own rows and heads, the
    MoE's experts on its own groups and experts: ``dtensor.
    on_local_blocks``, whose arguments whole on a split mesh dim take a
    partial-sum gradient) against the unsharded port on every rank: the
    train step's tolerances, each updated element within 2 lr (1 + wd
    |p|) plus one bf16 step of the larger result (a gradient element
    near 0 may take the other sign, and the larger of the two results
    is rounded, not only the wanted one)."""
    _spawn(_family_step_ranks, tmp_path, arch)


# -- packed weights on DTensors -----------------------------------------------

# wide enough that the block linears pack (>= 65,536 values a weight)
PACKED = dict(d_model=256, d_ff=512, vocab=256, n_heads=4, n_kv_heads=4,
              head_dim=64)


def _packed_ranks(rank, out_dir):
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.distributed import dtensor
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models.layers import QuantizedTensor
    from repro_torch.models.model import build_template, init_cache
    from repro_torch.models.quantize import quantize_params
    from repro_torch.models.spec import init_from_spec
    from repro_torch.quant.config import QuantConfig

    mesh = _mesh()
    cfg = _cfg(PACKED)
    tmpl = build_template(cfg)
    q = QuantConfig(bits=4)
    params = quantize_params(
        init_from_spec(tmpl, torch.Generator().manual_seed(0), device="cpu"),
        tmpl, q)
    shape = ShapeConfig("d", SEQ, BATCH, "decode")
    run = RunConfig(arch=cfg, shape=shape, quant=q)
    prefill = steps.make_prefill_step(cfg, run)
    serve = steps.make_serve_step(cfg, run)
    toks = _batch()["tokens"]

    def decode(p, tokens, cache):
        out = [prefill(p, {"tokens": tokens[:, :PREFILL]}, cache)[0]]
        for pos in range(PREFILL, PREFILL + 4):
            out.append(serve(p, out[-1][:, None], cache, pos)[0])
        return torch.stack([unshard_ids(t) for t in out], dim=1)

    def unshard_ids(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    want = decode(params, toks, init_cache(cfg, BATCH, SEQ, device="cpu"))
    clay = sh.placements(sh.cache_pspecs(cfg, shape, mesh), mesh)
    blay = sh.placements(sh.data_pspec(BATCH, mesh), mesh)
    dtoks = sh.distribute(toks, blay)
    seen = []
    local = dtensor.on_local_words

    def spy(product, x, packed, *a):
        out = local(product, x, packed, *a)
        seen.append((packed.placements, out.placements))
        return out

    dtensor.on_local_words = spy
    import repro_torch.models.layers as layers
    layers.on_local_words = spy
    try:
        # serve mode: words split on N over 'model'; train mode (FSDP):
        # also on K over 'data', whose products are partial sums
        for mode in ("serve", "train"):
            specs = sh.param_pspecs(tmpl, mesh, q, mode=mode)
            dp = sh.distribute(params, sh.placements(specs, mesh))
            wq = dp["blocks"][0]["attn"]["wq"]
            assert isinstance(wq, QuantizedTensor)
            assert isinstance(wq.packed, DTensor) and wq.packed.dtype == (
                torch.int32)
            want_words = params["blocks"][0]["attn"]["wq"].packed
            assert torch.equal(wq.packed.full_tensor(), want_words)
            cache = sh.distribute(init_cache(cfg, BATCH, SEQ, device="cpu"),
                                  clay)
            seen.clear()
            got = decode(dp, dtoks, cache)
            assert torch.equal(got, want), (mode, got, want)
            n_split = [p for p, _ in seen if p[1] == Shard(1)]
            assert n_split, seen
            if mode == "train":
                assert any(o[0] == Partial() for p, o in seen
                           if p[0] == Shard(0)), seen
    finally:
        dtensor.on_local_words = local
        layers.on_local_words = local


def test_packed_decode_on_dtensors_matches_unsharded(tmp_path):
    """A 4-bit SAMD-packed tree (every block linear packed) distributed on
    the (2, 2) mesh by its ``placements`` (words and scales each their
    own), serve-mode (words split on N) and train-mode (also on K at
    whole words): a lockstep prefill and four decode steps on each
    rank's own words (``dtensor.on_local_words``) give the unsharded
    port's tokens."""
    _spawn(_packed_ranks, tmp_path)
