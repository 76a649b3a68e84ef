"""Port parity: the checkpoint store (the reference's format, both ways)
and ``launch.train``'s resume (``tests/test_checkpoint.py``'s cases).

Leaves cross between the packages bit for bit: a port checkpoint of
{"params", "opt"} in the stacked layout of a scan-over-layers config is
restored by the reference's ``load_checkpoint`` and the other way round.
A resumed run equals the uninterrupted one: in the port alone bit for
bit (the same operations on the same data), and across the packages
(one package trains to the checkpoint, the other resumes) within the
reference test's 5e-2 on every parameter.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.launch.train import main as j_train_main  # noqa: E402
from repro.optim.adamw import AdamWState as JAdamWState  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models.convert import reference_layout  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402
from repro_torch.tree import named_leaves, register_node  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from test_torch_train import f32_leaves, models  # noqa: E402

# the reference's AdamWState is a pytree class: name its leaves as the
# reference's checkpoint store does
register_node(JAdamWState)

TRAIN_ARGS = ["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "4",
              "--seq-len", "32", "--log-every", "100"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((8, 4), generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32),
                   "h": torch.randn((3, 5), generator=g).bfloat16()},
        "list": [torch.ones((3,)), torch.zeros((2, 2))],
        "opt": AdamWState(torch.tensor(4, dtype=torch.int32),
                          {"w": torch.randn((2,), generator=g)},
                          {"w": torch.rand((2,), generator=g)}),
    }


def _bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _assert_same(got, want):
    a, b = named_leaves(got), named_leaves(want)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=name)


def test_save_load_roundtrip(tmp_path):
    t = _tree()
    path = os.path.join(tmp_path, "ck")
    save_checkpoint(path, t, step=7, meta={"arch": "x"})
    t2, step, meta = load_checkpoint(path, t, device="cpu")
    assert step == 7 and meta["arch"] == "x"
    assert isinstance(t2["opt"], AdamWState)
    _assert_same(t2, t)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["dtypes"] == {"nested/h": "bfloat16"}
    assert manifest["leaves"][:3] == ["a", "list/0", "list/1"]
    assert "opt/0" in manifest["leaves"]
    assert np.load(os.path.join(path, "nested__h.npy")).dtype == np.uint16


def test_manager_rolling_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.latest().endswith("ckpt_00000030")
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("ckpt"))
    assert dirs == ["ckpt_00000020", "ckpt_00000030"]


def test_manager_async_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(5, t, blocking=False)
    t["a"].add_(1.0)  # the save copied the tree before returning
    mgr.wait()
    assert mgr._thread is None and mgr.latest() is not None
    restored, step, _ = mgr.restore(_tree(), device="cpu")
    assert step == 5
    _assert_same(restored, _tree())


def test_crash_leaves_previous_checkpoint(tmp_path):
    """A partial (tmp) write never shadows the last complete
    checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    os.makedirs(os.path.join(tmp_path, "ckpt_00000002.tmp"))
    assert mgr.latest().endswith("ckpt_00000001")
    # nor does a directory whose manifest was never written
    os.makedirs(os.path.join(tmp_path, "ckpt_00000003"))
    assert mgr.latest().endswith("ckpt_00000001")


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    """``load_checkpoint`` and ``CheckpointManager.restore`` called
    without a device restore onto CUDA, as every entry point of the
    package does: with no card they raise and never hand back CPU
    tensors. Naming the CPU restores there."""
    import inspect

    for fn in (load_checkpoint, CheckpointManager.restore):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree(), blocking=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(mgr.latest(), _tree())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore(_tree())
    tree, step, _ = mgr.restore(_tree(), device="cpu")
    assert step == 3
    assert {t.device.type for _, t in named_leaves(tree)} == {"cpu"}
    _assert_same(tree, _tree())


def _stacked_models():
    """A scan-over-layers (stacked) config: the reference's tree is
    stacked, the port's a list of layers."""
    jcfg = j_smoke_config("qwen1.5-0.5b").scaled(scan_layers=True)
    return models("qwen1.5-0.5b", jcfg=jcfg)


def _port_state(params, seed=3):
    g = torch.Generator().manual_seed(seed)

    def moment(p):
        return torch.rand(p.shape, generator=g)

    return AdamWState(torch.tensor(12, dtype=torch.int32),
                      tree_map(moment, params), tree_map(moment, params))


def test_reference_restores_a_port_checkpoint(tmp_path):
    jcfg, cfg, jparams, params = _stacked_models()
    opt = _port_state(params)
    tree = {"params": reference_layout(params, cfg),
            "opt": AdamWState(opt.step, reference_layout(opt.m, cfg),
                              reference_layout(opt.v, cfg))}
    assert isinstance(tree["params"]["blocks"], dict)
    path = os.path.join(tmp_path, "ck")
    save_checkpoint(path, tree, step=12, meta={"arch": cfg.name})
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    like = {"params": zeros,
            "opt": JAdamWState(jnp.zeros((), jnp.int32), zeros, zeros)}
    got, step, meta = j_load(path, like)
    assert step == 12 and meta == {"arch": cfg.name}
    assert isinstance(got["opt"], JAdamWState)
    want = dict(named_leaves(tree))
    for name, leaf in named_leaves(got):
        assert leaf.dtype.name == str(want[name].dtype).removeprefix(
            "torch."), name
        np.testing.assert_array_equal(
            np.asarray(leaf).view(_bits(want[name]).dtype),
            _bits(want[name]), err_msg=name)
    # and the restored parameters are the reference's own, bit for bit
    for name, leaf in named_leaves(got["params"]):
        np.testing.assert_array_equal(
            np.asarray(leaf), np.asarray(dict(named_leaves(jparams))[name]))


def test_port_restores_a_reference_checkpoint(tmp_path):
    jcfg, cfg, jparams, params = _stacked_models()
    rng = np.random.default_rng(4)

    def moment(p):
        return jnp.asarray(rng.random(p.shape, np.float32))

    jtree = {"params": jparams,
             "opt": JAdamWState(jnp.asarray(9, jnp.int32),
                                jax.tree.map(moment, jparams),
                                jax.tree.map(moment, jparams))}
    path = os.path.join(tmp_path, "ck")
    j_save(path, jtree, step=9, meta={"arch": jcfg.name})
    like = {"params": reference_layout(params, cfg),
            "opt": AdamWState(torch.zeros((), dtype=torch.int32),
                              reference_layout(params, cfg),
                              reference_layout(params, cfg))}
    got, step, meta = load_checkpoint(path, like, device="cpu")
    assert step == 9 and meta == {"arch": jcfg.name}
    want = dict(named_leaves(jtree))
    for name, leaf in named_leaves(got):
        w = np.asarray(want[name])
        assert str(leaf.dtype).removeprefix("torch.") == w.dtype.name, name
        np.testing.assert_array_equal(_bits(leaf), w.view(
            _bits(leaf).dtype), err_msg=name)


def _max_param_diff(got, want):
    return max(float(np.abs(got[n] - want[n]).max()) for n in want)


def test_train_resume_equivalence_in_the_port(tmp_path):
    """Stopping at step 3 and resuming reproduces the uninterrupted run
    (deterministic data + checkpointed AdamW state), bit for bit."""
    ck = os.path.join(tmp_path, "c1")
    full = train_main(TRAIN_ARGS + ["--steps", "6"], device="cpu")
    train_main(TRAIN_ARGS + ["--steps", "3", "--checkpoint-dir", ck,
                             "--checkpoint-every", "3"], device="cpu")
    resumed = train_main(TRAIN_ARGS + ["--steps", "6", "--checkpoint-dir",
                                       ck, "--resume"], device="cpu")
    _assert_same(resumed, full)


@pytest.mark.parametrize("first", ["reference", "port"])
def test_train_resume_across_packages(tmp_path, capsys, first):
    """One package trains 3 steps and checkpoints, the other resumes to
    step 6: within 5e-2 (tests/test_checkpoint.py's bound) of the first
    package's uninterrupted run, on every parameter."""
    _, cfg, _, _ = models("qwen1.5-0.5b")
    mains = {"reference": j_train_main,
             "port": lambda argv: train_main(argv, device="cpu")}
    second = "port" if first == "reference" else "reference"
    ck = os.path.join(tmp_path, "c1")
    full = mains[first](TRAIN_ARGS + ["--steps", "6"])
    mains[first](TRAIN_ARGS + ["--steps", "3", "--checkpoint-dir", ck,
                               "--checkpoint-every", "3"])
    capsys.readouterr()
    resumed = mains[second](TRAIN_ARGS + ["--steps", "6",
                                          "--checkpoint-dir", ck,
                                          "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out

    def leaves(p):
        return f32_leaves(p, cfg if isinstance(p["embed"], torch.Tensor)
                          else None)

    assert _max_param_diff(leaves(resumed), leaves(full)) < 5e-2
