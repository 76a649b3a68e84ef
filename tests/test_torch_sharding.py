"""Port parity of the sharding rules: ``repro_torch.distributed.sharding``
against the reference's ``repro.distributed.sharding`` on the same
configs and fake meshes (an object whose ``.shape`` maps axis names to
sizes, as ``tests/test_distributed.py`` builds them), spec for spec and
entry for entry; then the specs' DTensor placements on DeviceMeshes of a
fake process group.

The port's spec keeps its entries as made (``P(("data",), "model")``);
the installed JAX's PartitionSpec folds a one-name tuple into the name,
so the port's side is folded the same way (``_fold``) before the
entries are compared.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import SHAPES  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import build_template as j_build_template  # noqa: E402
from repro.models.layers import QuantizedTensor as JQT  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro_torch.configs.archs import ARCHS, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.models.layers import QuantizedTensor  # noqa: E402
from repro_torch.models.model import build_template  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402


class FakeMesh:
    """Mesh stand-in exposing .shape (the reference tests' own)."""

    def __init__(self, **axes):
        self.shape = dict(axes)


MESHES = {"1pod": dict(data=16, model=16),
          "2pod": dict(pod=2, data=16, model=16)}
ARCH_NAMES = sorted(ARCHS)


def _fold(entry):
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _entries(p):
    """A spec of either package as a tuple of its (folded) entries."""
    if isinstance(p, P):
        return tuple(_fold(e) for e in p)
    assert isinstance(p, JP), type(p)
    return tuple(p)


def _assert_same(got, want, path="root"):
    """Walk both spec trees in step: dicts by key, lists by index, specs
    entry by entry, QuantizedTensor spec nodes by their packed and scale
    specs and static fields."""
    if isinstance(want, JP):
        assert isinstance(got, P), (path, got)
        assert _entries(got) == _entries(want), (path, got, want)
    elif isinstance(want, JQT):
        assert isinstance(got, QuantizedTensor), (path, got)
        assert (got.orig_shape, got.axis, got.cfg.bits) == (
            want.orig_shape, want.axis, want.cfg.bits), path
        _assert_same(got.packed, want.packed, path + "/packed")
        _assert_same(got.scale, want.scale, path + "/scale")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}/{i}")
    else:
        assert got == want, (path, got, want)


def _count(tree):
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count(v) for v in tree)
    if isinstance(tree, QuantizedTensor):
        return 2
    return 1


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_pspecs_match_reference(name, mesh):
    """Train and serve mode, unquantized and 4-bit (packed leaves as
    QuantizedTensor spec nodes), with and without the LM head packed."""
    cfg, jcfg = get_arch(name), j_get_arch(name)
    fm = FakeMesh(**MESHES[mesh])
    tmpl = build_template(cfg, stacked=cfg.scan_layers)
    jtmpl = j_build_template(jcfg)
    quants = [(None, None), (QuantConfig(bits=4), JQuantConfig(bits=4)),
              (QuantConfig(bits=4, quantize_embeddings=True),
               JQuantConfig(bits=4, quantize_embeddings=True))]
    for mode in ("train", "serve"):
        for q, jq in quants:
            got = sh.param_pspecs(tmpl, fm, q, mode)
            want = jsh.param_pspecs(jtmpl, fm, jq, mode)
            _assert_same(got, want)
            assert _count(got) == len(jax.tree.leaves(
                want, is_leaf=lambda x: isinstance(x, JP)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_pspecs_match_reference(name, mesh):
    """Every shape cell, the per-layer list and (where the reference has
    one) the stacked layout, bf16 and 8-bit KV."""
    cfg, jcfg = get_arch(name), j_get_arch(name)
    fm = FakeMesh(**MESHES[mesh])
    for shape_name, jshape in SHAPES.items():
        shape = ShapeConfig(jshape.name, jshape.seq_len, jshape.global_batch,
                            jshape.kind)
        for kv_bits in (None, 8):
            for stacked in (False, True):
                try:
                    want = jsh.cache_pspecs(jcfg, jshape, fm, stacked,
                                            kv_bits)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)):
                        sh.cache_pspecs(cfg, shape, fm, stacked, kv_bits)
                    continue
                _assert_same(sh.cache_pspecs(cfg, shape, fm, stacked,
                                             kv_bits), want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_data_pspecs_match_reference(mesh):
    fm = FakeMesh(**MESHES[mesh])
    for batch in (1, 2, 3, 4, 16, 24, 32, 48, 64, 128, 256, 512, 1024):
        assert sh.batch_pspec(batch, fm) == jsh.batch_pspec(batch, fm)
        assert _entries(sh.data_pspec(batch, fm)) == _entries(
            jsh.data_pspec(batch, fm))


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_logical_to_mesh_matches_reference(mesh, mode):
    fm = FakeMesh(**MESHES[mesh])
    names = [None, "embed", "vocab", "ff", "heads", "kv_heads", "experts",
             "ssm_inner", "rwkv_att"]
    for axes in [(a, b) for a in names for b in names]:
        for shape in ((5120, 5120), (4096, 40), (8, 16), (64, 32), (1, 8)):
            got = sh.logical_to_mesh(axes, shape, fm, mode)
            want = jsh.logical_to_mesh(axes, shape, fm, mode)
            assert _entries(got) == _entries(want), (axes, shape)


def test_port_specs_keep_their_entries_as_made():
    """The reference tests' examples, on the port's raw entries."""
    mesh = FakeMesh(data=16, model=16)
    ps = sh.logical_to_mesh(("embed", "heads"), (5120, 5120), mesh)
    assert ps == P(("data",), "model") and ps != P("data", "model")
    assert sh.logical_to_mesh((None, "kv_heads"), (1, 8), mesh) == P(None,
                                                                     None)
    assert sh.logical_to_mesh(("embed", "ff"), (4096, 16384), mesh,
                              "serve") == P(None, "model")
    pod = FakeMesh(pod=2, data=16, model=16)
    assert sh.logical_to_mesh(("embed", "ff"), (4096, 16384), pod) == P(
        ("data", "pod"), "model")
    assert sh.data_pspec(64, pod) == P(("pod", "data"), None)
    assert repr(P(None, "model")) == "P(None, 'model')"


# -- DTensor placements on DeviceMeshes of a fake process group ---------------

@pytest.fixture(scope="module")
def meshes():
    """A (2, 2) (data, model) and a (2, 2, 2) (pod, data, model) mesh of
    a fake 8-rank group (this process is rank 0; no collective runs)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield (DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model")),
               DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                          mesh_dim_names=("pod", "data", "model")))
    finally:
        dist.destroy_process_group()


def test_placements_of_specs(meshes):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    mesh, pod = meshes
    R = Replicate()
    cases = [(P(None, None), (R, R)), (P("model", None), (R, Shard(0))),
             (P(("data",), "model"), (Shard(0), Shard(1))),
             (P(None, ("data", "model")), (Shard(1), Shard(1))),
             (P("data", None, "model", None), (Shard(0), Shard(2)))]
    for spec, want in cases:
        lay = sh.placements(spec, mesh)
        assert lay.mesh is mesh and lay.placements == want, spec
    # batch over (pod, data): the mesh's own order
    assert sh.placements(P(("pod", "data"), None), pod).placements == (
        Shard(0), Shard(0), R)
    # two axes in the other order: the later mesh dim major, the earlier
    # a strided shard of its blocks
    assert sh.placements(P(("model", "data")), mesh).placements == (
        _StridedShard(0, split_factor=2), Shard(0))
    with pytest.raises(NotImplementedError, match="out of the mesh's"):
        sh.placements(P(("model", "data", "pod")), pod)
    with pytest.raises(ValueError, match="shards two dims"):
        sh.placements(P("model", "model"), mesh)
    # the multi-pod FSDP embed dim, ("data", "pod"): data-major
    fm = FakeMesh(pod=2, data=16, model=16)
    spec = sh.logical_to_mesh(("embed", "ff"), (4096, 16384), fm)
    assert sh.placements(spec, pod).placements == (
        _StridedShard(0, split_factor=2), Shard(0), Shard(1))


@pytest.mark.parametrize("quant", [False, True])
def test_placements_of_a_parameter_tree(meshes, quant):
    """Every leaf of the spec tree becomes a Layout on the mesh, a packed
    leaf's words and scales each their own."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs.archs import smoke_config

    mesh = meshes[0]
    cfg = smoke_config("qwen1.5-0.5b").scaled(
        d_model=256, d_ff=512, vocab=256, n_heads=4, n_kv_heads=4,
        head_dim=64)
    q = QuantConfig(bits=4) if quant else None
    specs = sh.param_pspecs(build_template(cfg), mesh, q)
    lays = sh.placements(specs, mesh)
    assert lays["embed"].placements == (Shard(1), Shard(0))
    assert lays["final_ln"].placements == (Replicate(), Replicate())
    wq = lays["blocks"][0]["attn"]["wq"]
    if quant:
        assert isinstance(wq, QuantizedTensor)
        # packed [256/8 words, 256]: words on data, columns on model
        assert wq.packed.placements == (Shard(0), Shard(1))
        assert wq.scale.placements == (Replicate(), Shard(1))
    else:
        assert wq.placements == (Shard(0), Shard(1))


def test_multi_pod_fsdp_blocks_are_data_major():
    """The FSDP dim ``P(("data", "pod"))`` on the (2, 16, 16) (pod, data,
    model) mesh (a mesh of 512 ranks made without a process group; no
    collective runs): the block of every rank, by
    ``compute_local_shape_and_global_offset``'s computation at its mesh
    coordinate and by ``distribute_tensor``'s own local chunk, is the
    one the reference's NamedSharding gives it, data-major and
    pod-minor: block ``data * 2 + pod`` of 32."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset,
    )

    rows = 5120  # qwen3-14b's d_model: 160 rows a block
    mesh = DeviceMesh("cpu", torch.arange(512).reshape(2, 16, 16),
                      mesh_dim_names=("pod", "data", "model"),
                      _init_backend=False)
    lay = sh.placements(P(("data", "pod"), None), mesh)
    whole = torch.arange(rows)[:, None].expand(rows, 2).contiguous()
    for pod in range(2):
        for data in range(16):
            coord = [pod, data, 5]
            shape, offset = _compute_local_shape_and_global_offset(
                (rows, 2), mesh.shape, coord, lay.placements)
            block = (data * 2 + pod) * (rows // 32)
            assert (shape, offset) == ((rows // 32, 2), (block, 0)), (
                pod, data)
            mesh.get_coordinate = lambda c=coord: c
            local = distribute_tensor(whole, mesh, lay.placements,
                                      src_data_rank=None).to_local()
            assert torch.equal(local[:, 0], torch.arange(
                block, block + rows // 32)), (pod, data)
