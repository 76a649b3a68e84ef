"""Port parity: the paper's flow end to end on the port (train -> loss
decreases -> freeze -> SAMD-pack -> serve) and fake-quant QAT, each held
against the reference on the same inputs (``tests/test_system.py``'s
configs and criteria).

Tolerances: the first step's loss within ``LOSS_TOL`` (1e-4 relative, as
``test_torch_train``); ``fake_quant`` forward and gradient bit for bit in
f32 (the same f32 division, rounding and clip, the clip's ties passing
half the gradient in both) and in bf16 within one bf16 step of each
value (the quotient ``w / scale`` is rounded to bf16 in both, in another
order of operations); the served tokens equal the reference engine's, or
part at a near-tie (``test_torch_serving._assert_greedy_parity``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim.adamw import global_norm as j_global_norm  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.quant.quantizer import fake_quant as j_fake_quant  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402
from repro_torch.models.model import build_template, forward  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.adamw import global_norm  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402
from repro_torch.quant.quantizer import fake_quant  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.tree import tree_unflatten  # noqa: E402
from test_torch_serving import _assert_greedy_parity  # noqa: E402
from test_torch_serving import _serve, _workload  # noqa: E402
from test_torch_train import GNORM_TOL, LOSS_TOL  # noqa: E402
from test_torch_train import j_batch, j_train_step  # noqa: E402
from test_torch_train import models, t_batch, t_train_step  # noqa: E402

SYSTEM = dict(n_layers=2, d_model=64, vocab=128, n_heads=4, n_kv_heads=4,
              head_dim=16, d_ff=128)
TRAIN_KW = dict(learning_rate=1e-3, lr_warmup=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system_models(seed=0):
    return models("qwen1.5-0.5b", seed=seed,
                  jcfg=j_smoke_config("qwen1.5-0.5b").scaled(**SYSTEM))


def _train(jcfg, cfg, jparams, params, steps):
    """``steps`` steps of SyntheticLM(seed 0) at batch 8, seq 64 through
    the port; the first through the reference too. Returns (params,
    losses, the reference's first loss)."""
    data = SyntheticLM(cfg.vocab, 64, 8, seed=0)
    step = t_train_step(cfg, 8, 64, **TRAIN_KW)
    opt = adamw_init(params)
    losses, first = [], None
    for i in range(steps):
        batch = next(data)
        if i == 0:
            _, _, jm = j_train_step(jcfg, 8, 64, **TRAIN_KW)(
                jparams, j_adamw_init(jparams), j_batch(batch))
            first = float(jm["loss"])
        params, opt, m = step(params, opt, t_batch(batch))
        losses.append(float(m["loss"]))
    return params, losses, first


def test_training_reduces_loss():
    """tests/test_system.py's criterion: 30 steps, the mean of the last 5
    losses below the mean of the first 5 minus 0.3."""
    _, losses, first = _train(*_system_models(), 30)
    assert np.isfinite(losses).all()
    assert losses[0] == pytest.approx(first, rel=LOSS_TOL)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def _fake_quant_inputs(dtype, seed=3):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((48, 24)) * 0.05).astype(np.float32)
    w[5, 3] = 0.0  # a zero weight
    w[:, 7] = 0.0  # an all-zero channel: amax clamps to 1e-8
    c = rng.standard_normal((48, 24)).astype(np.float32)
    if dtype == "bfloat16":
        w = w.astype(jnp.bfloat16)
    return w, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("axis", [0, 1])
def test_fake_quant_matches_reference(bits, dtype, axis):
    """Forward and gradient (of sum(c * fake_quant(w))) against the
    reference's: bit for bit in f32, within a bf16 step in bf16."""
    w, c = _fake_quant_inputs(dtype)
    jw = jnp.asarray(w)

    def j_loss(x):
        return jnp.sum(jnp.asarray(c) * j_fake_quant(x, bits, axis))

    want = np.asarray(j_fake_quant(jw, bits, axis), np.float32)
    want_g = np.asarray(jax.grad(j_loss)(jw), np.float32)
    tw = torch.from_numpy(np.asarray(w, np.float32)).to(
        getattr(torch, dtype)).requires_grad_(True)
    out = fake_quant(tw, bits, axis)
    (torch.from_numpy(c) * out).sum().backward()
    got, got_g = out.detach().float().numpy(), tw.grad.float().numpy()
    assert out.dtype == tw.dtype == tw.grad.dtype
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_g, want_g)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0)
        np.testing.assert_allclose(got_g, want_g, rtol=2.0 ** -8, atol=0)
    # straight through: the gradient is c where the code is inside the
    # clip, c / 2 at the channel's amax (a tie of the clip), 0 beyond
    # (up to the roundings of (c x scale) / scale: two bf16 steps)
    ratio = got_g / np.where(c == 0, 1, c)
    assert (np.abs(ratio[..., None] - [0.0, 0.5, 1.0]).min(-1)
            <= 2.0 ** -6).all()


def test_qat_fake_quant_trains():
    """tests/test_system.py's QAT run on the port: 25 AdamW steps (lr
    1e-3) of the 4-bit fake-quantized model on SyntheticLM(seq 32, batch
    4, seed 2) stay finite and end below where they began; the first
    loss and gradient norm agree with the reference's (``LOSS_TOL``, and
    ``test_torch_train``'s GNORM_TOL)."""
    jcfg, cfg, jparams, params = _system_models(seed=1)
    data = SyntheticLM(cfg.vocab, 32, 4, seed=2)

    def j_loss(p, batch):
        pq = jax.tree.map(lambda x: j_fake_quant(x, 4) if x.ndim == 2
                          else x, p)
        logits, _, _ = j_forward(pq, batch["tokens"], jcfg)
        lf = logits.astype(jnp.float32)
        tgt = jnp.take_along_axis(lf, batch["targets"][..., None], -1)
        return jnp.mean(jax.nn.logsumexp(lf, -1) - tgt[..., 0])

    def loss(p, batch):
        pq = tree_map(lambda x: fake_quant(x, 4) if x.ndim == 2 else x, p)
        lf = forward(pq, batch["tokens"], cfg).float()
        tgt = torch.gather(lf, -1, batch["targets"].long()[..., None])
        return torch.mean(torch.logsumexp(lf, -1) - tgt[..., 0])

    opt = adamw_init(params)
    lr = torch.tensor(1e-3, dtype=torch.float32)
    losses = []
    for i in range(25):
        batch = next(data)
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        value = loss(leaves, t_batch(batch))
        grads = torch.autograd.grad(value, tree_leaves(leaves))
        grads = tree_unflatten(params, list(grads))
        if i == 0:
            want, want_g = jax.jit(jax.value_and_grad(j_loss))(
                jparams, j_batch(batch))
            assert float(value.detach()) == pytest.approx(float(want),
                                                          rel=LOSS_TOL)
            assert float(global_norm(grads)) == pytest.approx(
                float(j_global_norm(want_g)), rel=GNORM_TOL)
        params, opt, _ = adamw_update(grads, opt, params, lr)
        losses.append(float(value.detach()))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_train_then_quantize_then_serve():
    """tests/test_system.py's deployment flow on the port: 40 steps, then
    the SAMD-packed model's next-token argmax agrees with the float
    model's on the next batch (>= 0.9 at 8 bits, >= 0.6 at 4); and the
    port's engine (4-bit, on the CPU) serves the trained weights with
    the reference engine's greedy tokens."""
    jcfg, cfg, jparams, params = _system_models()
    params, _, _ = _train(jcfg, cfg, jparams, params, 40)
    batch = t_batch(next(SyntheticLM(cfg.vocab, 64, 8, seed=0)))
    with torch.no_grad():
        pred = forward(params, batch["tokens"], cfg).float().argmax(-1)
        for bits, min_agree in ((8, 0.9), (4, 0.6)):
            qparams = quantize_params(params, build_template(cfg),
                                      QuantConfig(bits=bits))
            pred_q = forward(qparams, batch["tokens"], cfg).float().argmax(
                -1)
            agree = float((pred == pred_q).float().mean())
            assert agree >= min_agree, (bits, agree)

    trained = jax.tree.map(jnp.asarray, params_to_numpy(params, cfg))
    kw = dict(max_batch=4, max_len=64, page_size=8)
    jeng = JServingEngine(jcfg, trained, quant=JQuantConfig(
        bits=4, backend="pallas"), **kw)
    teng = ServingEngine(cfg, params, quant=QuantConfig(bits=4),
                         device="cpu", **kw)
    work = _workload(11, n=6, lo=3, hi=30, vocab=cfg.vocab)
    want = _serve(jeng, JRequest, work)
    got = _serve(teng, Request, work)
    _assert_greedy_parity(jeng, want, got, work)
