"""Port parity: the training step (loss, gradients, AdamW) of all ten
architectures, gradient accumulation and remat.

The same weights (the reference's, carried over by
``models.convert.params_from_numpy``) and the same batches go through the
reference's jitted ``make_train_step`` and the port's. Tolerances, each
from what the two packages compute differently:

  * ``lr``: bit for bit (step 0 is in the warm-up, no cosine).
  * loss: ``LOSS_TOL`` = 1e-4 relative. Logits are bf16 in both and the
    loss is an f32 mean of ~100 log-softmax terms; the bf16 roundings
    differ (the two libraries order the sums of each product apart).
  * grad_norm: ``GNORM_TOL`` = 5e-3 relative (the same, through the
    backward pass).
  * gradients, and AdamW's ``m`` and ``v`` after one step (0.1 g and
    0.05 g^2 of the clipped gradient): ``GRAD_TOL`` = 2^-4 of each leaf's
    largest |value| (for ``v``, twice that: it is quadratic). The
    gradients of bf16 parameters are bf16 and every activation on the
    way is rounded to bf16 at other places in the two packages, which
    moves the smaller leaves (biases, gates) by up to ~8 bf16 steps of
    the leaf's scale. An MoE router that sends a token to another
    expert changes those experts' gradients outright: such a route may
    differ only where the reference's k-th and (k+1)-th router
    probabilities are within ``ROUTE_TOL`` (2^-8 relative, a bf16 step of
    the hidden state they come from), and the experts it touches, and
    the layer's ``ln`` and ``router``, are left out of the gradient
    comparison (they are still in the parameter rule below).
  * updated parameters: within ``2 lr (1 + wd |p|)`` plus one bf16 unit
    in the last place of the reference's value. AdamW's first step moves
    each element by lr x sign(g) (plus the decay), so a gradient element
    near 0 that rounds to the other sign moves 2 lr apart.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.layers as j_layers  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import build_template as j_build_template  # noqa: E402
from repro.models import init_from_spec as j_init  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

LOSS_TOL = 1e-4
GNORM_TOL = 5e-3
GRAD_TOL = 2.0 ** -4
ROUTE_TOL = 2.0 ** -8
# a run whose parameters move (the reference's test_system.py settings):
# lr at step 0 is 1e-4, about a bf16 step of a 0.02-scale weight
TRAIN_KW = dict(learning_rate=1e-3, lr_warmup=10)
NAMES = sorted(J_ARCHS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(name, seed=0, jcfg=None):
    """(reference cfg, port cfg, reference params, port params); ``jcfg``
    defaults to the arch's smoke config."""
    jcfg = jcfg or j_smoke_config(name)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    jparams = j_init(j_build_template(jcfg), jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def batch_of(cfg, b, s, seed=1):
    """numpy batch: random tokens and targets, and for a frontend arch
    seeded prefix embeddings (bf16)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = (rng.standard_normal(
            (b, cfg.n_prefix_embeds, cfg.d_model)) * 0.02).astype(
                jnp.bfloat16)
    return batch


def j_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def t_batch(batch, device="cpu"):
    return {k: (torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16) if v.dtype == jnp.bfloat16 else torch.from_numpy(v)
        ).to(device) for k, v in batch.items()}


def f32_leaves(tree, cfg=None):
    """{leaf name: f32 numpy} of a reference tree (``cfg`` None) or of a
    port tree in the reference's layout."""
    if cfg is not None:
        tree = params_to_numpy(tree, cfg)
    return {n: np.asarray(x, np.float32) for n, x in named_leaves(tree)}


def bf16_ulp(x):
    """One bf16 unit in the last place of each f32 value (0 -> the
    smallest normal's)."""
    a = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def assert_params_close(got, want, before, lr, wd=0.1):
    """The updated-parameter rule (module doc)."""
    for name, w in want.items():
        tol = 2 * lr * (1 + wd * np.abs(before[name])) + bf16_ulp(w)
        bad = np.abs(got[name] - w) > tol
        assert not bad.any(), (name, int(bad.sum()),
                               float(np.abs(got[name] - w).max()))


def assert_leaves_close(got, want, tol=GRAD_TOL, skip=None):
    """Each leaf within ``tol`` of its largest |value|. ``skip`` maps a
    leaf name to None (left out) or to experts (leading-axis slices) left
    out."""
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        drop = (skip or {}).get(name, ())
        if drop is None:
            continue
        if drop:
            keep = [e for e in range(w.shape[0]) if e not in drop]
            g, w = g[keep], w[keep]
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max(), (name, err, np.abs(w).max())


def record_routes(monkeypatch, n_layers):
    """From now on, record every MoE layer's router probabilities and
    top-k experts in both packages, the reference's inside its jitted
    step too (``jax.debug.callback``): {"ref": {layer: (probs [tokens,
    E], experts [tokens, k])}, "port": {...}}, numpy, the last run's."""
    seen = {"ref": {}, "port": {}}
    j_top_k, t_top_k = jax.lax.top_k, layers.top_k_lower_first
    calls = {"ref": 0, "port": 0}

    def store(side, layer, probs, idx):
        seen[side][layer] = (np.asarray(probs).reshape(-1, probs.shape[-1]),
                             np.asarray(idx).reshape(-1, idx.shape[-1]))

    def j_rec(probs, k):
        vals, idx = j_top_k(probs, k)
        layer = calls["ref"] % n_layers
        calls["ref"] += 1
        jax.debug.callback(functools.partial(store, "ref", layer), probs, idx)
        return vals, idx

    def t_rec(probs, k):
        vals, idx = t_top_k(probs, k)
        layer = calls["port"] % n_layers
        calls["port"] += 1
        store("port", layer, probs.detach(), idx)
        return vals, idx

    monkeypatch.setattr(j_layers.jax.lax, "top_k", j_rec)
    monkeypatch.setattr(layers, "top_k_lower_first", t_rec)
    return seen


def moe_exemptions(seen, cfg):
    """The ``skip`` of ``assert_leaves_close``: the gradients that a route
    differing between the packages changes outright (module doc), after
    checking that every differing route is a near-tie in the reference's
    router probabilities."""
    skip = {}
    if cfg.family != "moe":
        return skip
    assert sorted(seen["ref"]) == sorted(seen["port"]) == list(
        range(cfg.n_layers))
    k = cfg.top_k
    for layer in range(cfg.n_layers):
        (probs, want), (_, got) = seen["ref"][layer], seen["port"][layer]
        for t in np.nonzero((np.sort(want, 1) != np.sort(got, 1)).any(1))[0]:
            p = np.sort(probs[t])[::-1]
            assert p[k - 1] - p[k] <= ROUTE_TOL * p[k - 1], (
                layer, t, p[k - 1], p[k])
            pre = f"blocks/{layer}/moe"
            skip[f"{pre}/ln"] = skip[f"{pre}/router"] = None
            for w in ("w_up", "w_gate", "w_down"):
                skip.setdefault(f"{pre}/{w}", set()).update(
                    set(want[t]) ^ set(got[t]))
    return skip


def j_train_step(jcfg, b, s, **kw):
    run = JRunConfig(arch=jcfg, shape=JShapeConfig("t", s, b, "train"),
                     **kw)
    return jax.jit(j_steps.make_train_step(jcfg, run))


def t_train_step(cfg, b, s, **kw):
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", s, b, "train"), **kw)
    return steps.make_train_step(cfg, run)


def test_lm_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 53)) * 4).astype(jnp.bfloat16)
    targets = rng.integers(0, 53, (3, 7)).astype(np.int32)
    want = float(j_steps.lm_loss(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(steps.lm_loss(
        torch.from_numpy(np.asarray(logits, np.float32)).bfloat16(),
        torch.from_numpy(targets)))
    assert got == pytest.approx(want, rel=1e-6)


def check_step(monkeypatch, name, b=2, s=64, jcfg=None, **kw):
    """One train step in both packages; returns the port's outputs."""
    kw = {**TRAIN_KW, **kw}
    jcfg, cfg, jparams, params = models(name, jcfg=jcfg)
    batch = batch_of(cfg, b, s)
    seen = record_routes(monkeypatch, cfg.n_layers)
    jp, jopt, jm = j_train_step(jcfg, b, s, **kw)(
        jparams, j_adamw_init(jparams), j_batch(batch))
    p, opt, m = t_train_step(cfg, b, s, **kw)(params, adamw_init(params),
                                              t_batch(batch))
    assert np.asarray(m["lr"]).view(np.int32) == np.asarray(
        jm["lr"]).view(np.int32)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=LOSS_TOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=GNORM_TOL)
    assert int(opt.step) == 1
    skip = moe_exemptions(seen, cfg)
    assert_leaves_close(f32_leaves(opt.m, cfg), f32_leaves(jopt.m),
                        skip=skip)
    assert_leaves_close(f32_leaves(opt.v, cfg), f32_leaves(jopt.v),
                        tol=2 * GRAD_TOL, skip=skip)
    before = f32_leaves(jparams)
    assert_params_close(f32_leaves(p, cfg), f32_leaves(jp), before,
                        float(jm["lr"]))
    moved = sum(int((f32_leaves(p, cfg)[n] != v).sum())
                for n, v in before.items())
    assert moved > 0.5 * sum(v.size for v in before.values())
    return cfg, p, opt, m


@pytest.mark.parametrize("name", NAMES)
def test_one_train_step_matches_reference(monkeypatch, name):
    """All ten archs at their smoke configs: llava's prefix embeddings
    (their logits dropped from the loss), the MoE aux loss, RWKV6 and
    the Mamba2 hybrid's shared attention."""
    cfg, p, _, m = check_step(monkeypatch, name)
    for _, t in named_leaves(p):
        assert torch.isfinite(t).all()
    if cfg.family == "moe":
        assert float(m["loss"]) > 0


def test_grad_accum_matches_reference_and_full_batch(monkeypatch):
    """grad_accum=2 against the reference's grad_accum=2 (the tolerances
    above), and against the port's own full batch with the reference
    test's tolerances (tests/test_models.py: loss within 2e-2 relative,
    parameters within 5e-2)."""
    _, _, _, m2 = check_step(monkeypatch, "qwen1.5-0.5b", b=4, s=32,
                             grad_accum=2)
    _, cfg, _, params = models("qwen1.5-0.5b")
    batch = t_batch(batch_of(cfg, 4, 32))
    outs = [t_train_step(cfg, 4, 32, grad_accum=a, **TRAIN_KW)(
        params, adamw_init(params), batch) for a in (1, 2)]
    (p1, _, m1), (p2, _, m2b) = outs
    assert float(m2b["loss"]) == float(m2["loss"])
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-2 * abs(
        float(m1["loss"]))
    for (name, a), (_, b) in zip(named_leaves(p1), named_leaves(p2)):
        assert (a.float() - b.float()).abs().max() < 5e-2, name


@pytest.mark.parametrize("name", ["qwen3-14b", "olmoe-1b-7b"])
def test_remat_matches_no_remat(name):
    """The reference test's tolerances (tests/test_models.py): loss within
    1e-4, each gradient leaf within max(1e-3, 2^-7 max|g|). The recompute
    runs the same operations on the same inputs, the MoE router included,
    so the port in fact gives the same bits."""
    _, cfg, _, params = models(name)
    batch = t_batch(batch_of(cfg, 2, 32))
    outs = []
    for remat in ("none", "block"):
        run = RunConfig(arch=cfg, shape=ShapeConfig("t", 32, 2, "train"),
                        remat=remat)
        outs.append(steps.value_and_grad(steps.make_loss_fn(cfg, run),
                                         params, batch))
    (l0, g0), (l1, g1) = outs
    assert abs(float(l0) - float(l1)) < 1e-4
    for (name_, a), (_, b) in zip(named_leaves(g0), named_leaves(g1)):
        a, b = a.float(), b.float()
        assert (a - b).abs().max() <= max(1e-3, 2.0 ** -7 * a.abs().max()), \
            name_
        assert torch.equal(a, b), name_


class _InPlaceLog(torch.overrides.TorchFunctionMode):
    """Records every in-place tensor method (``x.add_(...)``,
    ``x[i] = ...``, ``copy_``) applied to a tensor that is part of the
    autograd graph."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if (args and isinstance(args[0], torch.Tensor)
                and (name == "__setitem__"
                     or (name.endswith("_") and not name.startswith("_")))
                and (args[0].requires_grad or args[0].grad_fn is not None)):
            self.hits.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "rwkv6-3b", "zamba2-7b"])
def test_no_in_place_op_in_the_autograd_graph(name):
    """The train path (no cache) puts no in-place op in the graph: the
    MoE's dispatch loop, RWKV6's chunk scan and Mamba2's conv and SSD
    scan build new tensors; the backward runs under anomaly detection."""
    _, cfg, _, params = models(name)
    batch = t_batch(batch_of(cfg, 2, 32))
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", 32, 2, "train"))
    log = _InPlaceLog()
    with torch.autograd.set_detect_anomaly(True):
        with log:
            loss, grads = steps.value_and_grad(
                steps.make_loss_fn(cfg, run), params, batch)
    assert log.hits == []
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for _, g in named_leaves(grads))
