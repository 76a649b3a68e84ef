"""Port parity: ``repro_torch.launch.hlo_analysis`` against the reference's
``repro.launch.hlo_analysis``.

``Roofline`` and ``model_flops`` must give the reference's numbers
exactly under the reference's constants (the port's are monkeypatched to
them: same arithmetic, the H100's rates otherwise). The collective
counter, reading the collectives DTensor dispatches on a fake 16-rank
group, must count the operand bytes that ``parse_collectives`` reads in
the HLO XLA compiles for the same operation on 16 host devices (in a
spawned process, whose device count is its own), exactly.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis as jha  # noqa: E402
from repro_torch.launch import hlo_analysis as ha  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each operation on a (4, 4) ("data", "model") mesh of f32 values: x
# [64, 128] split on 'data' gathered whole; a [64, 128] split on K over
# 'model' times w [128, 32] split on K: the partial sums reduced, or
# reduce-scattered over the rows
_REFERENCE = r"""
import json
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.launch.hlo_analysis import parse_collectives

try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
mesh = Mesh(np.array(jax.devices()).reshape(4, 4), ("data", "model"))
ns = lambda *s: NamedSharding(mesh, P(*s))
x = jax.ShapeDtypeStruct((64, 128), jnp.float32, sharding=ns("data", None))
a = jax.ShapeDtypeStruct((64, 128), jnp.float32, sharding=ns(None, "model"))
w = jax.ShapeDtypeStruct((128, 32), jnp.float32, sharding=ns("model", None))
specs = dict(mesh=mesh, in_specs=(P(None, "model"), P("model", None)))
fns = {
    "all-gather": (jax.jit(lambda x: x * 2, out_shardings=ns()), (x,)),
    "all-reduce": (jax.jit(shard_map(
        lambda a, w: jax.lax.psum(a @ w, "model"), out_specs=P(), **specs)),
        (a, w)),
    "reduce-scatter": (jax.jit(shard_map(
        lambda a, w: jax.lax.psum_scatter(a @ w, "model",
                                          scatter_dimension=0, tiled=True),
        out_specs=P("model", None), **specs)), (a, w)),
}
out = {}
for name, (f, args) in fns.items():
    st = parse_collectives(f.lower(*args).compile().as_text())
    out[name] = [st.bytes_by_kind, st.count_by_kind]
print(json.dumps(out))
"""


def _reference_collectives() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16")
    res = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.splitlines()[-1])


@pytest.fixture
def fake_mesh():
    """A (4, 4) ("data", "model") mesh of a fake 16-rank group (this
    process is rank 0; collectives move nothing), destroyed after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    try:
        yield init_device_mesh("cpu", (4, 4),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_counter_bytes_match_parse_collectives(fake_mesh):
    """The same three redistributions on DTensors, each counted alone:
    one collective of the reference's kind, of the bytes the reference's
    parser reads in XLA's HLO."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh, R = fake_mesh, Replicate()
    want = _reference_collectives()
    x = distribute_tensor(torch.ones(64, 128), mesh, [Shard(0), R])
    a = distribute_tensor(torch.ones(64, 128), mesh, [R, Shard(1)])
    w = distribute_tensor(torch.ones(128, 32), mesh, [R, Shard(0)])
    y = a @ w  # partial sums over 'model'
    assert y.placements[1].is_partial()
    ops = {"all-gather": lambda: x.redistribute(mesh, [R, R]),
           "all-reduce": lambda: y.redistribute(mesh, [R, R]),
           "reduce-scatter": lambda: y.redistribute(mesh, [R, Shard(0)])}
    for name, op in ops.items():
        with ha.CollectiveCounter() as counter:
            op()
        st = counter.stats()
        assert [st.bytes_by_kind, st.count_by_kind] == want[name], name
        assert st.bytes_by_kind == {name: 8192}
        assert st.total_bytes == 8192


def test_counter_counts_this_ranks_flops(fake_mesh):
    """The counter's flops are the local products' (this rank's rows),
    not the global op's, and no collective is counted where none runs."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = distribute_tensor(torch.ones(64, 128), fake_mesh,
                          [Shard(0), Replicate()])
    w = distribute_tensor(torch.ones(128, 32), fake_mesh,
                          [Replicate(), Replicate()])
    with ha.CollectiveCounter() as counter:
        y = x @ w
    assert y.placements == (Shard(0), Replicate())
    assert counter.flops == 2 * 16 * 128 * 32
    assert counter.stats().total_bytes == 0


def test_roofline_and_model_flops_match_the_reference(monkeypatch):
    """Every term of ``Roofline`` (and the dominant one) and
    ``model_flops`` are the reference's under its constants."""
    monkeypatch.setattr(ha, "PEAK_FLOPS", jha.PEAK_FLOPS)
    monkeypatch.setattr(ha, "HBM_BW", jha.HBM_BW)
    monkeypatch.setattr(ha, "NET_BW", jha.ICI_BW)
    cases = [(8.1e12, 3.0e9, 1.0e8, 256), (1.0e9, 9.9e10, 2.0e7, 512),
             (1.0e6, 1.0e6, 7.5e10, 256), (0.0, 0.0, 0.0, 1)]
    for args in cases:
        mine, theirs = ha.Roofline(*args), jha.Roofline(*args)
        assert mine.as_dict() == theirs.as_dict(), args
        assert mine.bound_s == theirs.bound_s
    for n, tokens, kind in [(494_032_768, 1_048_576, "train"),
                            (14_000_000_000, 128, "decode"),
                            (1_234_567, 1_048_576, "prefill")]:
        assert ha.model_flops(n, tokens, kind) == jha.model_flops(
            n, tokens, kind)
    st = ha.CollectiveStats({"all-gather": 3, "all-reduce": 4}, {})
    assert st.total_bytes == jha.CollectiveStats(
        {"all-gather": 3, "all-reduce": 4}, {}).total_bytes == 7


def test_h100_constants():
    """The port's rates: one H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s,
    80 GB) and one 400 Gb/s network port a GPU (50 GB/s)."""
    assert (ha.PEAK_FLOPS, ha.HBM_BW, ha.HBM_BYTES, ha.NET_BW) == (
        989e12, 3.35e12, 80e9, 50e9)
    r = ha.Roofline(989e12, 3.35e12, 50e9, 256)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 1.0)
