"""The port's distribution across ranks on the CPU: four gloo processes on
a (2, 2) ("data", "model") DeviceMesh run the sharded train step, the
activation-sharding hint, the compressed all-reduce and resharded
checkpoints.

The sharded train step and the hinted forward start from the
reference's weights (``repro.models.init_from_spec`` of the reference
test's config, carried over by ``models.convert.params_from_numpy``),
and are held both to the port's unsharded step and to the reference's
jitted ``make_train_step`` / ``forward`` on the same weights and batch,
run in the test's own process (the reference's multi-device test runs
in a subprocess whose stripped environment fails it).

Each test spawns its ranks with the inherited environment, on a free
localhost port, and gives them ``RANK_TIMEOUT_S`` to finish; a rank that
fails fails the test with its traceback. Tolerances:

  * the sharded step against the unsharded one and against the
    reference (the same weights and batch): loss within ``LOSS_TOL`` =
    1e-4 relative and the gradient norm within ``GNORM_TOL`` = 5e-3
    relative (``tests/test_torch_train.py``'s bounds: bf16 activations
    are rounded at other places when the products are split across
    ranks, or by the other library); every updated parameter within
    ``tests/test_torch_train.py``'s rule, ``2 lr (1 + wd |p|)`` plus one
    bf16 unit in the last place (AdamW's first step moves an element by
    lr x sign(g), so a gradient element near 0 may take the other sign);
    AdamW's moments within ``MOMENT_TOL`` = 2^-4 of each leaf's largest
    |value| (``v``: twice that, it is quadratic).
  * ``compressed_psum``: the f32 sum of the four ranks' dequantized
    payloads, to ``PSUM_TOL`` = 2^-20 of the largest |sum| (a four-term
    f32 sum in another order: a few units in the last place).
  * checkpoints: bit for bit.
"""
import datetime
import os
import socket
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

WORLD = 4
RANK_TIMEOUT_S = 120
LOSS_TOL, GNORM_TOL, MOMENT_TOL = 1e-4, 5e-3, 2.0 ** -4
PSUM_TOL = 2.0 ** -20
# the reference test's config (tests/test_distributed.py): the smoke
# qwen1.5-0.5b scaled down, batch 4 x seq 32
SCALE = dict(d_model=64, d_ff=128, vocab=256, n_heads=4, n_kv_heads=4,
             head_dim=16)
BATCH, SEQ = 4, 32
PREFILL = 24  # the decode step's position after a prefill of that length
# head counts the model axis of a (1, 4) mesh does not divide
UNEVEN = dict(SCALE, n_heads=6, n_kv_heads=2)
# a run whose parameters move (tests/test_torch_train.py's settings): lr
# at step 0 is 1e-4, about a bf16 step of a 0.02-scale weight
TRAIN_KW = dict(learning_rate=1e-3, lr_warmup=10)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, port, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        fn(rank, out_dir, *args)
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _spawn(fn, tmp_path, *args):
    """Run ``fn(rank, out_dir, *args)`` on WORLD gloo ranks; fail with the
    first rank's traceback, or when they outlast RANK_TIMEOUT_S."""
    import torch.multiprocessing as mp

    out = str(tmp_path)
    ctx = mp.start_processes(_rank_main, args=(fn, _free_port(), out, args),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"ranks still running after {RANK_TIMEOUT_S} s")
    except mp.ProcessRaisedException:
        errs = sorted(p for p in os.listdir(out) if p.startswith("error_"))
        msg = open(os.path.join(out, errs[0])).read() if errs else ""
        raise AssertionError(msg) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _mesh():
    from repro_torch.launch.mesh import make_test_mesh

    return make_test_mesh(2, 2, device="cpu")


def _cfg(scale=SCALE):
    from repro_torch.configs.archs import smoke_config

    return smoke_config("qwen1.5-0.5b").scaled(**scale)


def _model():
    """(cfg, template, seeded unsharded params) of the test config."""
    from repro_torch.models.model import build_template
    from repro_torch.models.spec import init_from_spec

    cfg = _cfg()
    tmpl = build_template(cfg)
    params = init_from_spec(tmpl, torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, tmpl, params


def _batch():
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, SCALE["vocab"],
                                             (BATCH, SEQ)).astype(np.int32))
            for k in ("tokens", "targets")}


def _bf16_ulp(x):
    """One bf16 unit in the last place of each f32 value (a tensor or a
    numpy array; 0 -> the smallest normal's)."""
    if isinstance(x, np.ndarray):
        a = np.maximum(np.abs(x), np.float32(2.0 ** -126))
        return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)
    a = x.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _reference(out_dir, scale=SCALE, decode=False, train=True):
    """The reference on the test config (``scale`` over the smoke
    qwen1.5-0.5b), in this process: its seeded weights saved for the
    ranks (``params.pt``, the port's layout) and {"cfg", "params",
    "step": (params, opt, metrics) of one jitted ``make_train_step``,
    "loss": the forward's ``lm_loss``} on the ``_batch()``, as numpy;
    with ``decode``, also "decode_loss": the ``lm_loss`` of one decode
    step's logits (``_decode_logits``) against the targets' column
    ``PREFILL``; without ``train``, no "step"."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import RunConfig as JRunConfig
    from repro.configs import smoke_config as j_smoke_config
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.launch import steps as j_steps
    from repro.models import build_template, forward, init_from_spec
    from repro.optim.adamw import adamw_init
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.convert import params_from_numpy

    jcfg = j_smoke_config("qwen1.5-0.5b").scaled(**scale)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    assert cfg == _cfg(scale)
    jparams = init_from_spec(build_template(jcfg), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    torch.save(params, os.path.join(out_dir, "params.pt"))
    batch = {k: jnp.asarray(v.numpy()) for k, v in _batch().items()}
    run = JRunConfig(arch=jcfg, shape=JShapeConfig("t", SEQ, BATCH, "train"),
                     **TRAIN_KW)
    step = jax.jit(j_steps.make_train_step(jcfg, run))(
        jparams, adamw_init(jparams), batch) if train else None
    logits = forward(jparams, batch["tokens"], jcfg)[0]
    loss = j_steps.lm_loss(logits, batch["targets"])
    out = {"cfg": cfg, "params": jparams, "step": step, "loss": float(loss)}
    if decode:
        from repro.models.model import init_cache

        cache = init_cache(jcfg, BATCH, SEQ)
        _, cache, _ = forward(jparams, batch["tokens"][:, :PREFILL], jcfg,
                              cache=cache, cache_index=0)
        logits = forward(
            jparams, batch["tokens"][:, PREFILL:PREFILL + 1], jcfg,
            positions=jnp.full((BATCH, 1), PREFILL, jnp.int32), cache=cache,
            cache_index=PREFILL)[0]
        out["decode_loss"] = float(j_steps.lm_loss(
            logits, batch["targets"][:, PREFILL:PREFILL + 1]))
    return out


def _reference_params(out_dir):
    return torch.load(os.path.join(out_dir, "params.pt"))


def _f32_leaves(tree, cfg=None):
    """{leaf name: f32 numpy} of a reference tree (``cfg`` None) or of a
    port tree in the reference's layout."""
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.tree import named_leaves

    if cfg is not None:
        tree = params_to_numpy(tree, cfg)
    return {n: np.asarray(x, np.float32) for n, x in named_leaves(tree)}


# -- the sharded train step ---------------------------------------------------

def _train_step_ranks(rank, out_dir):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models import layers
    from repro_torch.models.model import build_template
    from repro_torch.optim import adamw_init
    from repro_torch.tree import named_leaves, tree_map

    mesh = _mesh()
    cfg = _cfg()
    tmpl = build_template(cfg)
    params = _reference_params(out_dir)
    batch = _batch()
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", SEQ, BATCH, "train"),
                    **TRAIN_KW)
    step = steps.make_train_step(cfg, run)
    want_p, want_o, want_m = step(params, adamw_init(params), batch)

    layouts = sh.placements(sh.param_pspecs(tmpl, mesh), mesh)
    dp = sh.distribute(params, layouts)
    blay = sh.placements(sh.data_pspec(BATCH, mesh), mesh)
    db = {k: sh.distribute(v, blay) for k, v in batch.items()}
    opt = adamw_init(dp)
    heads = []  # (rows, heads) of each attention run on plain tensors
    attend = layers.attention

    def spy(q, *a, **kw):
        if not isinstance(q, DTensor):
            heads.append((q.shape[0], q.shape[2]))
        return attend(q, *a, **kw)

    layers.attention = spy
    try:
        with CommDebugMode() as comm:
            got_p, got_o, got_m = step(dp, opt, db)
    finally:
        layers.attention = attend
    # each rank attends over its own quarter of the (batch row, head)
    # pairs: over half the rows and half the heads, or (where DTensor put
    # the stream's batch on both mesh dims) a quarter of the rows
    assert len(heads) == cfg.n_layers, heads
    assert all(b * h == BATCH * SCALE["n_heads"] // WORLD
               for b, h in heads), heads
    counts = {str(k).split(".")[-1]: v
              for k, v in comm.get_comm_counts().items()}

    loss = got_m["loss"].full_tensor().item()
    gnorm = got_m["grad_norm"].full_tensor().item()
    assert abs(loss - want_m["loss"].item()) <= LOSS_TOL * abs(loss)
    assert abs(gnorm - want_m["grad_norm"].item()) <= GNORM_TOL * gnorm
    lr = want_m["lr"].item()
    assert got_m["lr"].item() == lr
    fsdp = 0  # leaves with a dim sharded on the data axis
    for (name, g), (_, w), (_, p0), (_, lay) in zip(
            named_leaves(got_p), named_leaves(want_p), named_leaves(params),
            named_leaves(layouts)):
        assert isinstance(g, DTensor) and g.placements == lay.placements, (
            name, g.placements)
        fsdp += lay.placements[0].is_shard()
        full = g.full_tensor().float()
        tol = 2 * lr * (1 + 0.1 * p0.float().abs()) + _bf16_ulp(w.float())
        assert ((full - w.float()).abs() <= tol).all(), name
    for tree, want, k in ((got_o.m, want_o.m, 1), (got_o.v, want_o.v, 2)):
        for (name, g), (_, w), (_, lay) in zip(
                named_leaves(tree), named_leaves(want),
                named_leaves(layouts)):
            assert g.placements == lay.placements, name
            err = (g.full_tensor() - w).abs().max().item()
            assert err <= k * MOMENT_TOL * w.abs().max().item(), (name, err)
    assert int(got_o.step) == 1
    # FSDP: every weight with an embed dim on 'data' is gathered where it
    # is used, and its gradient reduce-scattered back
    assert fsdp >= 15
    assert counts.get("all_gather_into_tensor", 0) >= fsdp, counts
    assert counts.get("reduce_scatter_tensor", 0) > 0, counts
    # the whole sharded result (every rank gathers), for the reference
    whole = {"params": tree_map(lambda t: t.full_tensor(), got_p),
             "m": tree_map(lambda t: t.full_tensor(), got_o.m),
             "v": tree_map(lambda t: t.full_tensor(), got_o.v),
             "loss": loss, "grad_norm": gnorm, "lr": lr}
    if rank == 0:
        torch.save(whole, os.path.join(out_dir, "sharded_step.pt"))
    # a second step on the first one's sharded state
    p3, o3, m3 = step(got_p, got_o, db)
    assert np.isfinite(m3["loss"].full_tensor().item())
    assert int(o3.step) == 2


def test_sharded_train_step_matches_unsharded(tmp_path):
    """The reference's multi-device test config (smoke qwen1.5-0.5b at
    d_model 64), its parameters and AdamW moments as DTensors placed by
    ``param_pspecs`` (FSDP over 'data', heads / ff / vocab over 'model')
    and its batch by ``data_pspec``: one step against the port's
    unsharded step on every rank, every leaf keeping its placements, and
    rank 0's gathered result against the reference's jitted step on the
    same weights and batch; then a second step."""
    ref = _reference(str(tmp_path))
    _spawn(_train_step_ranks, tmp_path)
    got = torch.load(os.path.join(tmp_path, "sharded_step.pt"))
    jp, jopt, jm = (ref["step"][0], ref["step"][1], ref["step"][2])
    cfg = ref["cfg"]
    assert np.float32(got["lr"]) == np.float32(jm["lr"])
    assert got["loss"] == pytest.approx(float(jm["loss"]), rel=LOSS_TOL)
    assert got["grad_norm"] == pytest.approx(float(jm["grad_norm"]),
                                             rel=GNORM_TOL)
    before = _f32_leaves(ref["params"])
    params = _f32_leaves(got["params"], cfg)
    want = _f32_leaves(jp)
    assert params.keys() == want.keys()
    lr = float(jm["lr"])
    for name, w in want.items():
        tol = 2 * lr * (1 + 0.1 * np.abs(before[name])) + _bf16_ulp(w)
        assert (np.abs(params[name] - w) <= tol).all(), name
    moved = sum(int((params[n] != v).sum()) for n, v in before.items())
    assert moved > 0.5 * sum(v.size for v in before.values())
    for mine, theirs, k in ((got["m"], jopt.m, 1), (got["v"], jopt.v, 2)):
        mine, theirs = _f32_leaves(mine, cfg), _f32_leaves(theirs)
        assert mine.keys() == theirs.keys()
        for name, w in theirs.items():
            err = np.abs(mine[name] - w).max()
            assert err <= k * MOMENT_TOL * np.abs(w).max(), (name, err)


def _activation_hint_ranks(rank, out_dir):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models import layers, model

    mesh = _mesh()
    cfg = _cfg()
    tmpl = model.build_template(cfg)
    params = _reference_params(out_dir)
    batch = _batch()
    want = steps.lm_loss(model.forward(params, batch["tokens"], cfg),
                         batch["targets"]).item()
    dp = sh.distribute(params, sh.placements(sh.param_pspecs(tmpl, mesh),
                                             mesh))
    blay = sh.placements(sh.data_pspec(BATCH, mesh), mesh)
    db = {k: sh.distribute(v, blay) for k, v in batch.items()}
    seen = []
    orig = layers.attention_block

    def spy(p, x, *a, **k):
        seen.append(tuple(x.placements))
        return orig(p, x, *a, **k)

    hint = (Shard(0), Shard(1))  # batch on 'data', sequence on 'model'
    layers.attention_block = spy
    model.set_activation_sharding(hint)
    try:
        logits = model.forward(dp, db["tokens"], cfg)
        got = steps.lm_loss(logits, db["targets"])
        got = got.full_tensor().item()
    finally:
        model.set_activation_sharding(None)
        layers.attention_block = orig
    assert abs(got - want) <= LOSS_TOL * abs(want)
    # the first block takes the embedding as it comes; every later block
    # takes the stream as the hint placed it
    assert seen[0] == (Shard(0), Replicate()) and seen[1:] == [hint] * (
        cfg.n_layers - 1), seen
    if rank == 0:
        with open(os.path.join(out_dir, "hinted_loss"), "w") as f:
            f.write(repr(got))


def test_activation_sharding_hint_redistributes_between_blocks(tmp_path):
    """``set_activation_sharding`` puts the residual stream on its
    placements between blocks (sequence on 'model', as the reference's
    Megatron-style hint), and the loss stays the unsharded forward's and
    the reference's on the same weights and tokens."""
    ref = _reference(str(tmp_path))
    _spawn(_activation_hint_ranks, tmp_path)
    with open(os.path.join(tmp_path, "hinted_loss")) as f:
        got = float(f.read())
    assert got == pytest.approx(ref["loss"], rel=LOSS_TOL)


def _decode_logits(params, batch, cfg, cache):
    """The logits of one decode step at position ``PREFILL``, after the
    first ``PREFILL`` tokens are prefilled into the ring ``cache``."""
    from repro_torch.models.model import forward

    toks = batch["tokens"]
    forward(params, toks[:, :PREFILL], cfg, cache=cache, cache_index=0)
    return forward(params, toks[:, PREFILL:PREFILL + 1], cfg,
                   positions=torch.full((BATCH, 1), PREFILL), cache=cache,
                   cache_index=PREFILL)


def _uneven_heads_ranks(rank, out_dir, part):
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import build_template
    from repro_torch.optim import adamw_init
    from repro_torch.tree import named_leaves

    mesh = make_test_mesh(1, 4, device="cpu")
    cfg = _cfg(UNEVEN)
    tmpl = build_template(cfg)
    params = _reference_params(out_dir)
    batch = _batch()
    blay = sh.placements(sh.data_pspec(BATCH, mesh), mesh)
    db = {k: sh.distribute(v, blay) for k, v in batch.items()}
    if part == "decode":
        _uneven_decode(rank, out_dir, mesh, cfg, tmpl, params, batch, db)
        return
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", SEQ, BATCH, "train"),
                    **TRAIN_KW)
    step = steps.make_train_step(cfg, run)
    want_p, _, want_m = step(params, adamw_init(params), batch)
    layouts = sh.placements(sh.param_pspecs(tmpl, mesh), mesh)
    # q's 6 x 16 features and k / v's 2 x 16 split over 4 ranks: each
    # rank's shard would cut a head
    assert layouts["blocks"][0]["attn"]["wq"].placements[1].is_shard(1)
    assert layouts["blocks"][0]["attn"]["wk"].placements[1].is_shard(1)
    dp = sh.distribute(params, layouts)
    got_p, _, got_m = step(dp, adamw_init(dp), db)
    loss = got_m["loss"].full_tensor().item()
    gnorm = got_m["grad_norm"].full_tensor().item()
    assert abs(loss - want_m["loss"].item()) <= LOSS_TOL * abs(loss)
    assert abs(gnorm - want_m["grad_norm"].item()) <= GNORM_TOL * gnorm
    lr = want_m["lr"].item()
    for (name, g), (_, w), (_, p0) in zip(
            named_leaves(got_p), named_leaves(want_p), named_leaves(params)):
        assert isinstance(g, DTensor), name
        tol = 2 * lr * (1 + 0.1 * p0.float().abs()) + _bf16_ulp(w.float())
        assert ((g.full_tensor().float() - w.float()).abs() <= tol).all(), name
    if rank == 0:
        torch.save({"loss": loss, "grad_norm": gnorm},
                   os.path.join(out_dir, "uneven.pt"))


def _uneven_decode(rank, out_dir, mesh, cfg, tmpl, params, batch, db):
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models.model import init_cache

    # a decode step on the ring placed by cache_pspecs: 2 KV heads on a
    # 4-wide model axis put the sequence there (flash-decoding layout)
    shape = ShapeConfig("d", SEQ, BATCH, "decode")
    clay = sh.placements(sh.cache_pspecs(cfg, shape, mesh), mesh)
    assert clay["layers"][0]["k"].placements[1].is_shard(1)
    plain = init_cache(cfg, BATCH, SEQ, device="cpu")
    want = _decode_logits(params, batch, cfg, plain)
    cache = sh.distribute(init_cache(cfg, BATCH, SEQ, device="cpu"), clay)
    serve = sh.placements(sh.param_pspecs(tmpl, mesh, mode="serve"), mesh)
    got = _decode_logits(sh.distribute(params, serve), db, cfg, cache)
    tgt = batch["targets"][:, PREFILL:PREFILL + 1]
    want_loss = steps.lm_loss(want, tgt).item()
    got_loss = steps.lm_loss(got, db["targets"][:, PREFILL:PREFILL + 1])
    got_loss = got_loss.full_tensor().item()
    assert abs(got_loss - want_loss) <= LOSS_TOL * abs(want_loss)
    # the sequence-sharded ring holds what the plain ring holds
    for mine, theirs in zip(cache["layers"], plain["layers"]):
        assert isinstance(mine["k"], DTensor)
        assert torch.equal(mine["pos"].full_tensor(), theirs["pos"])
        w = theirs["k"].float()
        err = (mine["k"].full_tensor().float() - w).abs().max().item()
        assert err <= 2.0 ** -6 * w.abs().max().item(), err
    if rank == 0:
        torch.save({"decode_loss": got_loss},
                   os.path.join(out_dir, "uneven.pt"))


@pytest.mark.parametrize("part", ["train", "decode"])
def test_sharded_steps_split_heads_the_model_axis_does_not_divide(tmp_path,
                                                                   part):
    """Six query and two KV heads on a (1, 4) mesh, whose model axis
    splits their features into shards that each cut a head: the train
    step, and a decode step (prefill, then one token, on a ring whose
    sequence is on the model axis), run sharded (``dtensor.whole_heads``
    gathers such features before the head split) and hold to the
    unsharded port on every rank and to the reference."""
    decode = part == "decode"
    ref = _reference(str(tmp_path), UNEVEN, decode=decode, train=not decode)
    _spawn(_uneven_heads_ranks, tmp_path, part)
    got = torch.load(os.path.join(tmp_path, "uneven.pt"))
    if decode:
        assert got["decode_loss"] == pytest.approx(ref["decode_loss"],
                                                   rel=LOSS_TOL)
        return
    jm = ref["step"][2]
    assert got["loss"] == pytest.approx(float(jm["loss"]), rel=LOSS_TOL)
    assert got["grad_norm"] == pytest.approx(float(jm["grad_norm"]),
                                             rel=GNORM_TOL)


# -- compressed all-reduce ----------------------------------------------------

def _psum_ranks(rank, out_dir):
    from repro_torch.distributed import compression as comp

    mesh = _mesh()

    def payload(r, bits):
        x = torch.from_numpy(np.random.default_rng(r).normal(
            size=(37, 11)).astype(np.float32)) * (r + 1)
        if bits == 8:
            return comp.dequantize_int8(*comp.quantize_int8(x))
        q, s = comp.quantize_int4_packed(x)
        return comp.dequantize_int4_packed(q, s, x.numel(), x.shape)

    x = torch.from_numpy(np.random.default_rng(rank).normal(
        size=(37, 11)).astype(np.float32)) * (rank + 1)
    coords = mesh.get_coordinate()  # (data, model) of this rank
    for bits in (8, 4):
        got = comp.compressed_psum(x, None, bits)
        want = sum(payload(r, bits) for r in range(WORLD))
        assert got.dtype == torch.float32 and got.shape == x.shape
        assert (got - want).abs().max() <= PSUM_TOL * want.abs().max()
        # over one mesh dim: the two ranks of this rank's 'data' column
        got = comp.compressed_psum(x, mesh["data"], bits)
        peers = [r for r in range(WORLD) if r % 2 == coords[1]]
        want = sum(payload(r, bits) for r in peers)
        assert (got - want).abs().max() <= PSUM_TOL * want.abs().max()
    with pytest.raises(ValueError):
        comp.compressed_psum(x, None, 3)


def test_compressed_psum_over_four_ranks(tmp_path):
    """8- and 4-bit payloads summed over the whole group and over the
    mesh's 'data' dim equal the f32 sum of each rank's dequantized
    payload; other bits raise before any collective."""
    _spawn(_psum_ranks, tmp_path)


# -- resharded checkpoints ----------------------------------------------------

def _checkpoint_ranks(rank, out_dir):
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.distributed import sharding as sh
    from repro_torch.tree import named_leaves

    mesh = _mesh()
    cfg, tmpl, params = _model()
    plain = os.path.join(out_dir, "plain")
    if rank == 0:
        save_checkpoint(plain, params, step=7, meta={"from": "one rank"})
    dist.barrier()
    layouts = sh.placements(sh.param_pspecs(tmpl, mesh), mesh)
    tree, step, meta = load_checkpoint(plain, tmpl, shardings=layouts)
    assert step == 7 and meta == {"from": "one rank"}
    for (name, t), (_, p), (_, lay) in zip(named_leaves(tree),
                                           named_leaves(params),
                                           named_leaves(layouts)):
        assert isinstance(t, DTensor) and t.placements == lay.placements
        assert torch.equal(t.full_tensor(), p), name
    # and back: saved from the shards by all four ranks to one path (rank
    # 0 writes, the others wait), restored whole on every rank and
    # resharded onto the serve-mode placements
    sharded = os.path.join(out_dir, "sharded")
    save_checkpoint(sharded, tree, step=8)
    assert os.path.exists(os.path.join(sharded, "manifest.json"))
    assert not os.path.exists(sharded + ".tmp")
    back, step, _ = load_checkpoint(sharded, tmpl, device="cpu")
    assert step == 8
    for (name, t), (_, p) in zip(named_leaves(back), named_leaves(params)):
        assert not isinstance(t, DTensor) and t.dtype == p.dtype
        assert torch.equal(t, p), name
    serve = sh.placements(sh.param_pspecs(tmpl, mesh, mode="serve"), mesh)
    again, _, _ = load_checkpoint(sharded, tmpl, shardings=serve)
    for (name, t), (_, p), (_, lay) in zip(named_leaves(again),
                                           named_leaves(params),
                                           named_leaves(serve)):
        assert t.placements == lay.placements
        assert torch.equal(t.full_tensor(), p), name
    # the async manager: every rank gathers, rank 0 writes
    mgr = CheckpointManager(os.path.join(out_dir, "rolling"))
    mgr.save(9, again, blocking=True)
    dist.barrier()
    (latest,) = os.listdir(mgr.dir)
    assert latest == "ckpt_00000009"
    back, step, _ = load_checkpoint(mgr.latest(), tmpl, device="cpu")
    assert step == 9
    for (name, t), (_, p) in zip(named_leaves(back), named_leaves(params)):
        assert torch.equal(t, p), name


def test_checkpoint_restores_across_placements(tmp_path):
    """A checkpoint saved by one rank restores onto the (2, 2) FSDP
    placements; the sharded tree, saved by all four ranks to one shared
    path (and through ``CheckpointManager``), restores whole and again
    onto the serve-mode placements: bit for bit."""
    _spawn(_checkpoint_ranks, tmp_path)


# -- the production meshes under a fake process group -------------------------

def _production_mesh_main(world, multi_pod, q):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        q.put((tuple(mesh.shape), tuple(mesh.mesh_dim_names),
               mesh.size()))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod,world,shape,names", [
    (False, 256, (16, 16), ("data", "model")),
    (True, 512, (2, 16, 16), ("pod", "data", "model"))])
def test_production_mesh_under_a_fake_group(multi_pod, world, shape, names):
    """``make_production_mesh`` at 256 (and 512) ranks of a fake process
    group (rank 0 of it, in a process of its own): the reference's shape
    and axis names."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_production_mesh_main, args=(world, multi_pod, q))
    p.start()
    try:
        got = q.get(timeout=RANK_TIMEOUT_S)
    finally:
        p.join(timeout=RANK_TIMEOUT_S)
        if p.is_alive():
            p.kill()
    assert p.exitcode == 0
    assert got == (shape, names, world)


def test_full_width_qwen3_14b_decode_on_256_fake_ranks():
    """Full-width qwen3-14b (40 query and 8 KV heads, which the 16-wide
    model axis does not divide) runs its sharded decode step at
    decode_32k on the 16 x 16 mesh of a fake 256-rank group, every
    tensor fake (``launch.dryrun.lower_cell``): q, k and v are gathered
    whole before their head split in each of the 40 layers."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    r = dryrun.lower_cell("qwen3-14b", "decode_32k", device="cpu",
                          verbose=False)
    assert not dist.is_initialized()
    assert r["status"] == "ok" and r["chips"] == 256
    assert r["collective_counts"]["all-gather"] >= 3 * 40
