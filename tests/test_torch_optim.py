"""Port parity: the learning-rate schedule and AdamW.

``cosine_warmup`` computes the reference's f32 expression in the same
order of operations, with the cosine correctly rounded (taken in f64),
so it must give the reference's value bit for bit at every step whose
cosine XLA rounds correctly. XLA's f32 cosine on the CPU is not
correctly rounded everywhere (up to 0.56 of a unit in the last place;
about 1% of arguments in [0, pi] come out one step off), so at those
steps, and only there, the two may differ by one f32 step; the test
finds them from the reference's own cosine against one computed in
f64.
AdamW runs three updates of a mixed tree (bf16 and f32 leaves, matrices
that decay and vectors that do not) with the global-norm clipping active
and inactive: ``step`` and ``grad_norm`` must agree (grad_norm to 1e-6
relative: one f32 sum in another order), ``m`` and ``v`` to 1e-6
relative of each leaf's largest value (f32 arithmetic, ``b ** step``
from two libraries), and the parameters to one rounding step of their
dtype (2^-7 relative for bf16, 1e-6 for f32) plus lr x 1e-5 (an update
|delta| <= 10 off by the moments' 1e-6).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.optim import cosine_warmup as j_cosine_warmup  # noqa: E402
from repro.optim.adamw import global_norm as j_global_norm  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim import cosine_warmup  # noqa: E402
from repro_torch.optim.adamw import global_norm  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

MOMENT_TOL = 1e-6
PARAM_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-6}


@pytest.mark.parametrize("peak_lr,warmup,total", [
    (3e-4, 100, 10000),    # the reference's defaults
    (1e-3, 10, 300),       # warm-up, the whole cosine and the floor
    (3e-4, 0, 10000),      # no warm-up
])
def test_cosine_warmup_is_bit_identical(peak_lr, warmup, total):
    steps = np.arange(0, 301, dtype=np.int32)
    want = np.asarray(j_cosine_warmup(jnp.asarray(steps), peak_lr=peak_lr,
                                      warmup=warmup, total=total))
    got = cosine_warmup(torch.from_numpy(steps), peak_lr=peak_lr,
                        warmup=warmup, total=total).numpy()
    assert got.dtype == want.dtype == np.float32
    # the reference's cosine argument, and where XLA rounds its cosine
    # to another f32 than the correctly rounded one
    s = steps.astype(np.float32)
    frac = np.clip((s - np.float32(warmup)) / np.float32(max(
        total - warmup, 1)), 0, 1).astype(np.float32)
    arg = jnp.pi * jnp.asarray(frac)
    off = ((steps >= warmup)
           & (np.asarray(jnp.cos(arg))
              != np.cos(np.asarray(arg, np.float64)).astype(np.float32)))
    assert off.mean() < 0.05
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert np.all(ulps[~off] == 0), steps[(ulps != 0) & ~off]
    assert np.all(ulps[off] <= 1)


def _tree(rng, scale):
    """A mixed tree: bf16 and f32 matrices and vectors, nested."""
    def a(shape, dtype):
        return (rng.standard_normal(shape) * scale).astype(dtype)

    bf16 = jnp.bfloat16
    return {"w": a((8, 6), bf16), "b": a((6,), np.float32),
            "blocks": [{"ln": a((6,), bf16), "m": a((6, 4), np.float32)},
                       {"ln": a((6,), bf16), "m": a((6, 4), np.float32)}]}


def _torch_tree(tree):
    return jax.tree.map(
        lambda x: (torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16) if x.dtype == jnp.bfloat16
            else torch.from_numpy(np.array(x))), tree)


def _numpy(tree):
    """Port tree (torch leaves) -> {name: f32 numpy}."""
    return {name: t.float().numpy() for name, t in named_leaves(tree)}


def _ref_numpy(tree):
    return {name: np.asarray(x, np.float32)
            for name, x in named_leaves(tree)}


@pytest.mark.parametrize("grad_scale,clips", [(1e-2, False), (10.0, True)])
def test_adamw_three_updates_match_the_reference(grad_scale, clips):
    rng = np.random.default_rng(0)
    params = _tree(rng, 0.5)
    grads = [_tree(rng, grad_scale) for _ in range(3)]
    lr = 1e-2
    j_p, j_opt = params, j_adamw_init(params)
    p, opt = _torch_tree(params), adamw_init(_torch_tree(params))
    for g in grads:
        j_norm = float(j_global_norm(g))
        assert (j_norm > 1.0) == clips
        assert float(global_norm(_torch_tree(g))) == pytest.approx(
            j_norm, rel=MOMENT_TOL)
        j_p, j_opt, j_m = j_adamw_update(g, j_opt, j_p,
                                         jnp.asarray(lr, jnp.float32))
        p, opt, m = adamw_update(_torch_tree(g), opt, p,
                                 torch.tensor(lr, dtype=torch.float32))
        assert float(m["grad_norm"]) == pytest.approx(
            float(j_m["grad_norm"]), rel=MOMENT_TOL)
    assert int(opt.step) == int(j_opt.step) == 3
    assert opt.step.dtype == torch.int32 and opt.step.ndim == 0
    for got_t, want_t in ((opt.m, j_opt.m), (opt.v, j_opt.v)):
        got, want = _numpy(got_t), _ref_numpy(want_t)
        assert got.keys() == want.keys()
        for name in want:
            assert got[name].dtype == np.float32
            np.testing.assert_allclose(
                got[name], want[name], rtol=0,
                atol=MOMENT_TOL * np.abs(want[name]).max(), err_msg=name)
    got, want = _numpy(p), _ref_numpy(j_p)
    dtypes = {name: str(t.dtype).removeprefix("torch.")
              for name, t in named_leaves(p)}
    for name in want:
        tol = PARAM_TOL[dtypes[name]] * np.abs(want[name]) + lr * 1e-5
        assert np.all(np.abs(got[name] - want[name]) <= tol), name
    # the update moved the parameters and kept their dtypes
    assert dtypes["w"] == "bfloat16" and dtypes["b"] == "float32"
    assert np.abs(got["w"] - np.asarray(params["w"], np.float32)).max() > 0
