"""Import boundary of the port: repro_torch, chip_smoke.py, the port's
lint (tools/samd_lint_torch.py) and the example twins
(examples/*_torch.py) import neither JAX nor anything of the reference
package ``repro`` or of its ``benchmarks`` package, and the kernel
modules import (and their plain versions run) with no nvcc."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro|benchmarks)\b"
    r"|from\s+(jax|repro|benchmarks)(\.|\s))", re.M)

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None       # any import of jax now raises
sys.modules["repro"] = None     # ... and of the reference package
sys.modules["benchmarks"] = None  # ... and of its benchmarks
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
import torch
from repro_torch.kernels import ops
from repro_torch.quant.config import QuantConfig
from repro_torch.quant.packing import pack_weights
w = torch.randn(64, 8)
packed, scale = pack_weights(w, QuantConfig(bits=4))
out = ops.samd_matmul(torch.randn(2, 64), packed, scale, 64,
                      QuantConfig(bits=4))
assert out.shape == (2, 8)
print(len(names))
"""


def _sources():
    return (sorted(PORT.rglob("*.py"))
            + [ROOT / "chip_smoke.py", ROOT / "tools" / "samd_lint_torch.py"]
            + sorted((ROOT / "examples").glob("*_torch.py")))


def test_port_sources_have_no_forbidden_imports():
    assert len(_sources()) > 15
    for path in _sources():
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, (path, hits)


def test_port_imports_without_jax_repro_or_nvcc(tmp_path):
    """Every module imports in a process where ``jax``, ``repro`` and
    ``benchmarks`` are blocked, with no nvcc on PATH or under CUDA_HOME; a CPU tensor then
    runs a kernel's plain version."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_HOME"] = str(tmp_path)
    env["PATH"] = os.path.dirname(sys.executable)
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20  # every port module imported


_FAMILIES_PROBE = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["benchmarks"] = None
import torch
from repro_torch.configs.archs import ARCHS, smoke_config
from repro_torch.models import ssm
from repro_torch.models.model import build_template, forward
from repro_torch.models.spec import init_from_spec
for name in ("rwkv6-3b", "zamba2-7b", "olmoe-1b-7b"):
    cfg = smoke_config(name)
    params = init_from_spec(build_template(cfg), torch.Generator(),
                            device="cpu")
    out = forward(params, torch.zeros((1, 3), dtype=torch.long), cfg)
    assert out.shape == (1, 3, cfg.vocab)
print(ssm.__name__, len(ARCHS))
"""


def test_recurrent_and_moe_modules_need_no_jax_or_repro():
    """``models/ssm.py`` and the families' forward import and run with
    ``jax``, ``repro`` and ``benchmarks`` blocked."""
    assert (PORT / "models" / "ssm.py") in _sources()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run([sys.executable, "-c", _FAMILIES_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["repro_torch.models.ssm", "10"]


_TRAINING_PROBE = r"""
import os, sys, tempfile
for name in ("jax", "repro", "benchmarks", "ml_dtypes", "triton"):
    sys.modules[name] = None    # any import of these now raises
import repro_torch.optim, repro_torch.data, repro_torch.checkpoint
import repro_torch.distributed.compression
from repro_torch.launch.train import main
d = tempfile.mkdtemp()
args = ["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "2", "--seq-len",
        "16", "--log-every", "1", "--checkpoint-dir", d]
main(args + ["--steps", "2", "--grad-compression", "4"], device="cpu")
main(args + ["--steps", "3", "--resume"], device="cpu")
print(sorted(os.listdir(d))[-1])
"""


def test_training_modules_need_no_jax_repro_ml_dtypes_or_triton():
    """``optim``, ``data``, ``checkpoint``, ``distributed.compression``
    and ``launch.train`` import, and train, checkpoint bf16 weights and
    resume on the CPU, with ``jax``, ``repro``, ``benchmarks``,
    ``ml_dtypes`` and ``triton`` blocked."""
    for sub in ("optim", "data", "checkpoint", "distributed"):
        assert (PORT / sub / "__init__.py") in _sources()
    assert (PORT / "launch" / "train.py") in _sources()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run([sys.executable, "-c", _TRAINING_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "resumed from step 2" in out and "training done" in out
    assert out.split()[-1] == "ckpt_00000003"


def test_port_sources_import_no_ml_dtypes_or_triton():
    """No port source imports ``ml_dtypes`` (the machine with the card
    has none) or ``triton`` (no kernel of the port is a Triton one)."""
    blocked = re.compile(r"^\s*(import|from)\s+(ml_dtypes|triton)\b", re.M)
    for path in _sources():
        assert not blocked.findall(path.read_text()), path


_SLICE_PROBE = r"""
import sys
for name in ("jax", "repro", "benchmarks", "ml_dtypes", "triton"):
    sys.modules[name] = None    # any import of these now raises
import torch
import torch.distributed as dist
from repro_torch.core import conv, samd
from repro_torch.distributed import compression, sharding
from repro_torch.launch import mesh
from repro_torch.models.model import build_template, set_activation_sharding
from repro_torch.configs.archs import get_arch
assert not dist.is_initialized()
plan = conv.make_plan(4, 3, True, word_bits=64)
x = torch.arange(-8, 8).repeat(5)
out = conv.samd_conv_full(x, torch.tensor([3, -8, 7]), plan)
assert out.dtype == torch.int32 and out.shape == (82,)
w = samd.pack(x, samd.dense_format(4, True, 64))
assert w.dtype == torch.int64
class FakeMesh:
    shape = {"data": 16, "model": 16}
specs = sharding.param_pspecs(build_template(get_arch("qwen3-14b")),
                              FakeMesh())
assert specs["embed"] == sharding.P("model", ("data",))
try:
    mesh.make_test_mesh(2, 2, device="cpu")
except RuntimeError as e:
    assert "init_process_group" in str(e)
else:
    raise AssertionError("a mesh without a process group")
assert not dist.is_initialized() and callable(compression.compressed_psum)
set_activation_sharding(None)
print("ok")
"""


def test_slice_modules_need_no_jax_triton_or_process_group():
    """The 64-bit words (``core.samd``, ``core.conv``), the sharding rules,
    ``launch.mesh`` and ``compression.compressed_psum`` import and run on
    the CPU with ``jax``, ``repro``, ``benchmarks``, ``ml_dtypes`` and
    ``triton`` blocked, and none of them initialises a process group: a
    mesh asked for without one raises."""
    for rel in ("distributed/sharding.py", "launch/mesh.py"):
        assert (PORT / rel) in _sources()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run([sys.executable, "-c", _SLICE_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "ok"


_DRYRUN_PROBE = r"""
import os, sys
for name in ("jax", "repro", "benchmarks", "ml_dtypes", "triton"):
    sys.modules[name] = None    # any import of these now raises
env = dict(os.environ)
import torch.distributed as dist
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.configs import SHAPES
from repro_torch.data import make_batch_specs
from repro_torch.models.spec import param_count, shape_dtype_from_spec
from repro_torch.launch.steps import input_specs, make_serve_step
assert dict(os.environ) == env, "an import set an environment variable"
assert not dist.is_initialized()
r = dryrun.lower_cell("qwen3-14b", "long_500k", device="cpu")
assert r["status"] == "skipped"
with dryrun.fake_world(8):
    assert dist.get_world_size() == 8
assert not dist.is_initialized()
print(len(SHAPES), hlo_analysis.PEAK_FLOPS)
"""


def test_dryrun_modules_need_no_jax_and_set_nothing_at_import():
    """``launch.dryrun`` and ``launch.hlo_analysis`` (and what they need:
    ``configs.SHAPES``, ``data.make_batch_specs``, ``models.spec``'s
    counts, ``launch.steps.input_specs``) import with ``jax``, ``repro``,
    ``benchmarks``, ``ml_dtypes`` and ``triton`` blocked, set no
    environment variable (the reference's dry-run sets ``XLA_FLAGS`` at
    import) and start no process group; ``fake_world`` makes one and
    destroys it."""
    for rel in ("launch/dryrun.py", "launch/hlo_analysis.py"):
        assert (PORT / rel) in _sources()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run([sys.executable, "-c", _DRYRUN_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-2:] == ["4", "989000000000000.0"]
