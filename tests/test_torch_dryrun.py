"""Port parity: the multi-pod dry-run (``repro_torch.launch.dryrun``) and
what it needs (``configs.SHAPES``, ``models.spec.param_count`` /
``shape_dtype_from_spec``, ``data.make_batch_specs``, the lockstep
``make_prefill_step`` / ``make_serve_step`` and ``input_specs`` of
``launch/steps.py``), against the reference.

Shapes, dtypes and counts must be equal. Token ids are int32 in both
packages and prefix embeddings bf16, so a reference dtype maps to the
torch dtype of its name. The reference prefills the uniform families
into its stacked scan-over-layers cache; the port keeps its list layout
for every cell, so a stacked leaf must be the port's per-layer leaf
with the layer count in front. The reference's ``dryrun`` module sets
``XLA_FLAGS`` at import, so it is not imported here: its
``active_params`` formula is rebuilt from its template.

``lower_cell`` runs at smoke width (wide enough that 4-bit weights pack)
on both production meshes, as rank 0 of a fake group of 256 or 512
ranks: its analytic terms must be ``cell_cost / chips`` over the card's
rates, exactly. The lockstep steps of the recurrent families must give
the reference's greedy ids.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as j_pipeline  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import build_template as j_build_template  # noqa: E402
from repro.models import param_count as j_param_count  # noqa: E402
from repro.models.spec import TensorSpec as JTensorSpec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import make_batch_specs  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch import hlo_analysis as ha  # noqa: E402
from repro_torch.launch.analytic_costs import cell_cost  # noqa: E402
from repro_torch.models.model import build_template  # noqa: E402
from repro_torch.models.spec import param_count  # noqa: E402
from repro_torch.models.spec import shape_dtype_from_spec  # noqa: E402

# smoke width, wide enough that the block linears pack at 4 bits
SMOKE = dict(d_model=256, head_dim=64, d_ff=512, attn_chunk=4096)


def _spec(x):
    """(shape, dtype name) of a ShapeDtypeStruct or a tensor."""
    name = str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), name


def _assert_cache_like(port, ref, n_layers):
    if "layers_stacked" in ref:
        stacked = ref["layers_stacked"]
        assert len(port["layers"]) == n_layers
        for layer in port["layers"]:
            assert layer.keys() == stacked.keys()
            for name, leaf in layer.items():
                shape, dtype = _spec(stacked[name])
                assert (shape[0],) + _spec(leaf)[0] == (n_layers,) + shape[1:]
                assert _spec(leaf)[1] == dtype, name
        return
    assert len(port["layers"]) == len(ref["layers"]) == n_layers
    for mine, theirs in zip(port["layers"], ref["layers"]):
        assert mine.keys() == theirs.keys()
        for name in mine:
            if isinstance(mine[name], dict):  # the hybrid's attn_kv ring
                _assert_cache_like({"layers": [mine[name]]},
                                   {"layers": [theirs[name]]}, 1)
            else:
                assert _spec(mine[name]) == _spec(theirs[name]), name


def test_shapes_and_batch_specs_match_the_reference():
    assert configs.SHAPES.keys() == jconfigs.SHAPES.keys()
    for name, shape in configs.SHAPES.items():
        ref = jconfigs.SHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch,
                shape.kind) == (ref.name, ref.seq_len, ref.global_batch,
                                ref.kind)
        mine = make_batch_specs(151936, shape.seq_len, shape.global_batch)
        theirs = j_pipeline.make_batch_specs(151936, shape.seq_len,
                                             shape.global_batch)
        assert mine.keys() == theirs.keys()
        for k in mine:
            assert mine[k].device.type == "meta"
            assert _spec(mine[k]) == _spec(theirs[k])


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_input_specs_match_the_reference(arch):
    """Every cell's inputs (4 shapes x ``kv_bits`` None and 8) as meta
    tensors of the reference's shapes and dtypes."""
    cfg, jcfg = configs.get_arch(arch), jconfigs.get_arch(arch)
    for shape in configs.SHAPES.values():
        for kv_bits in (None, 8):
            mine = steps.input_specs(cfg, shape, kv_bits=kv_bits)
            theirs = j_steps.input_specs(jcfg, jconfigs.SHAPES[shape.name],
                                         kv_bits=kv_bits)
            assert mine.keys() == theirs.keys(), (shape.name, kv_bits)
            for key in mine:
                if key == "cache":
                    _assert_cache_like(mine[key], theirs[key], cfg.n_layers)
                elif key == "batch":
                    assert mine[key].keys() == theirs[key].keys()
                    for k in mine[key]:
                        assert _spec(mine[key][k]) == _spec(theirs[key][k])
                else:
                    assert mine[key].device.type == "meta"
                    assert _spec(mine[key]) == _spec(theirs[key]), key


def _j_active_params(jcfg) -> int:
    """The reference's ``dryrun.active_params``, from its template."""
    tmpl = j_build_template(jcfg)
    total = j_param_count(tmpl)
    if jcfg.family != "moe":
        return total
    leaves = jax.tree.leaves(tmpl, is_leaf=lambda x: isinstance(
        x, JTensorSpec))
    expert = sum(math.prod(sp.shape) for sp in leaves
                 if "experts" in (sp.axes or ()))
    return total - expert + expert * jcfg.top_k // jcfg.n_experts


def test_param_count_and_active_params_match_the_reference():
    for arch in configs.ARCHS:
        cfg, jcfg = configs.get_arch(arch), jconfigs.get_arch(arch)
        tmpl = build_template(cfg)
        assert param_count(tmpl) == j_param_count(j_build_template(jcfg))
        assert dryrun.active_params(cfg) == _j_active_params(jcfg), arch
        meta = shape_dtype_from_spec(tmpl)
        assert meta["embed"].device.type == "meta"
        assert _spec(meta["embed"]) == ((cfg.vocab, cfg.d_model),
                                        "bfloat16")


def _smoke(name):
    return configs.smoke_config(name).scaled(**SMOKE)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
@pytest.mark.parametrize("shape,bits", [
    ("train_4k", None), ("prefill_32k", None), ("decode_32k", None),
    ("decode_32k", 4)], ids=["train", "prefill", "decode", "decode-4bit"])
def test_lower_cell_at_smoke_width(monkeypatch, shape, bits, multi_pod):
    """A smoke-width qwen1.5-0.5b cell of each kind traced on a
    production mesh (4-bit decode with int8 KV on each rank's own packed
    words): status ok, the analytic terms ``cell_cost / chips`` over the
    card's rates, collectives and memory counted per rank, and the fake
    group gone afterwards."""
    import torch.distributed as dist

    from repro_torch.models import layers

    monkeypatch.setattr(dryrun, "get_arch", _smoke)
    words = []
    local = layers.on_local_words

    def spy(product, x, packed, *a):
        words.append(packed.placements)
        return local(product, x, packed, *a)

    monkeypatch.setattr(layers, "on_local_words", spy)
    kv = 8 if bits else None
    r = dryrun.lower_cell("qwen1.5-0.5b", shape, multi_pod=multi_pod,
                          quant_bits=bits, kv_bits=kv, device="cpu",
                          verbose=False)
    assert not dist.is_initialized()
    chips = 512 if multi_pod else 256
    cfg = _smoke("qwen1.5-0.5b")
    cost = cell_cost(cfg, configs.SHAPES[shape], bits, kv_bits=kv)
    assert r["status"] == "ok" and r["chips"] == chips
    assert r["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert (r["quant_bits"], r["kv_bits"]) == (bits, kv)
    assert r["sharding_mode"] == ("serve" if shape == "decode_32k"
                                  else "train")
    assert r["flops"] == cost.flops and r["hbm_bytes"] == cost.hbm_bytes
    assert r["compute_s"] == cost.flops / chips / ha.PEAK_FLOPS
    assert r["memory_s"] == cost.hbm_bytes / chips / ha.HBM_BW
    assert r["collective_s"] == r["collective_bytes"] / ha.NET_BW
    assert r["collective_bytes"] == sum(r["collectives"].values()) > 0
    assert r["flop_counter_flops_dev"] > 0
    mem = r["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["per_device_total_bytes"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"])
    if shape != "train_4k":  # the ring is written in place
        assert mem["alias_size_in_bytes"] > 0
    assert bool(words) == bool(bits)


def test_long_500k_skips_full_attention_and_main_counts_failures(capsys):
    """A full-attention arch skips long_500k with the reference's reason;
    ``main`` prints the reference's summary line and exits 1 on a
    FAILED cell."""
    r = dryrun.lower_cell("qwen3-14b", "long_500k", device="cpu")
    assert r == {"cell": "qwen3-14b/long_500k", "status": "skipped",
                 "reason": "full-attention arch; long_500k needs "
                           "sub-quadratic attention (DESIGN.md "
                           "§Arch-applicability)"}
    assert dryrun.main(["--arch", "qwen3-14b", "--shape", "long_500k",
                        "--device", "cpu"]) == 0
    assert "==== dry-run: 0 ok / 1 skipped / 0 FAILED ====" in (
        capsys.readouterr().out)
    assert dryrun.main(["--arch", "qwen3-14b", "--shape", "train_8k",
                        "--device", "cpu"]) == 1
    assert "==== dry-run: 0 ok / 0 skipped / 1 FAILED ====" in (
        capsys.readouterr().out)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_lockstep_steps_match_the_reference(arch):
    """The reference's lockstep prefill (whole prompts into a fresh ring
    or state from column 0; jitted) and two decode steps against the
    port's
    ``make_prefill_step`` / ``make_serve_step`` on the same weights: the
    greedy ids are equal."""
    from repro.configs.base import RunConfig as JRunConfig
    from repro.models import init_from_spec as j_init
    from repro.models.model import init_cache as j_init_cache
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import init_cache

    torch.set_num_threads(1)
    jcfg = jconfigs.smoke_config(arch).scaled(d_model=128, vocab=256)
    cfg = configs.smoke_config(arch).scaled(d_model=128, vocab=256)
    raw = j_init(j_build_template(jcfg), jax.random.PRNGKey(2))
    params = params_from_numpy(jax.tree.map(np.asarray, raw), "cpu")
    shape = jconfigs.base.ShapeConfig("s", 32, 2, "decode")
    jrun = JRunConfig(arch=jcfg, shape=shape)
    run = RunConfig(arch=cfg, shape=configs.ShapeConfig("s", 32, 2,
                                                        "decode"))
    toks = np.random.default_rng(4).integers(0, 256, size=(2, 9))
    j_prefill = jax.jit(j_steps.make_prefill_step(jcfg, jrun))
    j_serve = j_steps.make_serve_step(jcfg, jrun)
    jtok, jcache = j_prefill(raw, {"tokens": jnp.asarray(toks, jnp.int32)},
                             j_init_cache(jcfg, 2, 32))
    tok, cache = steps.make_prefill_step(cfg, run)(
        params, {"tokens": torch.from_numpy(toks).to(torch.int32)},
        init_cache(cfg, 2, 32, device="cpu"))
    assert tok.tolist() == np.asarray(jtok).tolist()
    for pos in (9, 10):
        jtok, jcache = j_serve(raw, jtok[:, None], jcache, jnp.int32(pos))
        tok, cache = steps.make_serve_step(cfg, run)(
            params, tok[:, None], cache, pos)
        assert tok.tolist() == np.asarray(jtok).tolist(), pos


def test_matmul_launcher_gives_fake_tensors_their_shape_only():
    """The CUDA wrapper of the packed matmul, called on fake tensors (no
    data pointer to hand a launcher), returns a fake output of the
    kernel's shape and dtype and makes no launch (on the card the same
    path is ``tests/test_torch_cuda.py``'s)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops
    from repro_torch.kernels import samd_matmul as mm
    from repro_torch.quant.config import QuantConfig
    from repro_torch.quant.packing import pack_weights

    q = QuantConfig(bits=4)
    packed, scale = pack_weights(torch.randn(64, 32), q)
    before = ops.launch_counts()
    with FakeTensorMode() as mode:
        x = torch.empty(8, 64, dtype=torch.bfloat16)
        out = mm.samd_matmul_cuda(x, mode.from_tensor(packed),
                                  mode.from_tensor(scale), 64, q)
        assert (out.shape, out.dtype) == ((8, 32), torch.bfloat16)
    assert ops.launch_counts() == before
