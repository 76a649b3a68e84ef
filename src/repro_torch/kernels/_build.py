"""Build the package's CUDA sources with nvcc and bind them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
for Hopper (``sm_90a``) into its own shared library under
``<repo>/build/repro_torch/``, keyed by a hash of the source and the
flags, so a changed source rebuilds and an unchanged one loads at once.
Nothing is built or imported when this module is imported: the first
launch builds (or ``build_all`` builds every kernel in parallel, one
``nvcc`` per source).

Every exported launcher returns ``cudaGetLastError()`` after its launch;
:meth:`Kernel.launch` raises when it is not 0 and only then counts the
launch, in a counter of that launcher's own (one source may export
several launchers, and each is counted apart).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME="
        f"{cuda_home}); the CUDA kernels of repro_torch cannot be built"
    )


class Kernel:
    """One CUDA source, its shared library and a launch count per
    launcher.

    ``functions`` maps each exported C launcher to its ctypes argument
    types; every launcher returns an ``int`` CUDA error code.
    ``launches`` maps each launcher to the number of launches made.
    """

    def __init__(self, name: str, source: str, functions: dict):
        self.name = name
        self.source = CSRC / source
        self.functions = functions
        self.launches = dict.fromkeys(functions, 0)
        self.build_log = ""
        self._lib = None
        self._fns = {}

    @property
    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc for this source unless its library exists; returns
        the running process (or None) and the temporary output path."""
        out = self.library
        if out.exists():
            return None, out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, proc, tmp) -> None:
        if proc is None:
            return
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source.name} "
                f"(exit {proc.returncode}):\n{self.build_log}"
            )
        os.replace(tmp, self.library)  # atomic: concurrent builds agree

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(*self.start_build())
            lib = ctypes.CDLL(str(self.library))
            for fn, argtypes in self.functions.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def query(self, fn: str, *args: int) -> int:
        """Call an exported host function ``int fn(int, ...)`` that
        launches nothing (the sources' shared-memory sizes); not
        counted."""
        call = getattr(self.lib(), fn)
        call.argtypes = [ctypes.c_int] * len(args)
        call.restype = ctypes.c_int
        return call(*args)

    def launch(self, fn: str, *args) -> None:
        """Call launcher ``fn``; raise on a CUDA error, else count it."""
        call = self._fns.get(fn)
        if call is None:
            if fn not in self.launches:
                raise KeyError(f"{self.name} exports no launcher {fn!r}")
            call = self._fns[fn] = getattr(self.lib(), fn)
        err = call(*args)
        if err != 0:
            msg = self.lib().repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name}: launch failed: {msg} ({err})")
        self.launches[fn] += 1


def build_all(kernels) -> None:
    """Build every kernel's library, one nvcc per source, all at once."""
    started = [(k, *k.start_build()) for k in kernels]
    for k, proc, tmp in started:
        k.finish_build(proc, tmp)


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, for a launcher (the raw
    handle, without building a ``torch.cuda.Stream`` on every call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


@functools.cache
def _fake_tensor_class():
    from torch._subclasses.fake_tensor import FakeTensor

    return FakeTensor


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (``FakeTensorMode``: a shape, a
    dtype and a device, no data), which a launcher has no pointer for."""
    return isinstance(t, _fake_tensor_class())


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
