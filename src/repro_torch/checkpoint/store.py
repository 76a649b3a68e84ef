"""Fault-tolerant checkpoints: atomic save, async write, rolling restore.

The format is the reference's, so either package restores the other's
checkpoints: one ``.npy`` file per tree leaf, named by its path
(``tree.named_leaves``, "/" written as "__"), and ``manifest.json`` with
``step``, ``leaves``, ``meta`` and ``dtypes``. Leaves are full logical
tensors. numpy has no bf16 or fp8, so those leaves are stored as
same-width unsigned views (written and read through torch, which has the
types) with their true dtype under ``dtypes``.

A tree passed to ``save_checkpoint`` holds torch tensors (any device;
DTensors gathered and written whole by rank 0) or numpy arrays;
``load_checkpoint`` gives torch tensors on ``device`` (the card unless
the caller names another, as every entry point of the package), or
DTensors on the placements it is given, in the structure of ``like``.
The reference's layout (stacked ``blocks`` for a scan-over-layers
config) is the caller's to make: ``models.convert.reference_layout``.

Async: ``CheckpointManager.save`` copies the tree to host memory at once
and writes the files on a background thread, so the training loop waits
only for the device-to-host copy; ``wait()`` joins before the next save
or at exit. A write that fails leaves no manifest in place, and the
previous checkpoint stays the restore target (tmp directory + rename).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.dtensor import is_dtensor
from repro_torch.tree import named_leaves, tree_map, tree_unflatten

# dtype name -> (torch dtype, the unsigned numpy view it is stored as)
_EXOTIC = {
    "bfloat16": (torch.bfloat16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
}
_BY_TORCH = {t: name for name, (t, _) in _EXOTIC.items()}
# numpy's unsigned view -> the signed numpy and torch types of its width
# (the bits cross between numpy and torch as signed integers)
_SIGNED = {np.uint16: (np.int16, torch.int16), np.uint8: (np.int8, torch.int8)}


def _to_numpy(leaf) -> tuple[np.ndarray, Optional[str]]:
    """(array to write, dtype name when it is stored as a view). A
    DTensor leaf is gathered whole (``full_tensor``, a collective)."""
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        name = _BY_TORCH.get(t.dtype)
        if name is None:
            return t.numpy(), None
        unsigned = _EXOTIC[name][1]
        return t.view(_SIGNED[unsigned][1]).numpy().view(unsigned), name
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name in _EXOTIC:
        return arr.view(_EXOTIC[name][1]), name
    return arr, None


def save_checkpoint(path: str, tree: Any, *, step: int,
                    meta: dict | None = None):
    """Synchronous atomic checkpoint write (tmp dir + rename).

    A tree with DTensor leaves is saved by every rank of the default
    process group together: each gathers the leaves whole (collectives),
    rank 0 alone writes the files, and all leave at a barrier once they
    are in place, so ranks that share ``path`` never race on it."""
    sharded = any(is_dtensor(leaf) for _, leaf in named_leaves(tree))
    arrays = [(name, *_to_numpy(leaf)) for name, leaf in named_leaves(tree)]
    if sharded:
        import torch.distributed as dist

        if dist.get_rank() == 0:
            _write(path, arrays, step, meta)
        dist.barrier()
    else:
        _write(path, arrays, step, meta)


def _write(path: str, arrays, step: int, meta: dict | None):
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    names, dtypes = [], {}
    for name, arr, dname in arrays:
        if dname is not None:
            dtypes[name] = dname
        np.save(os.path.join(tmp, name.replace("/", "__") + ".npy"), arr)
        names.append(name)
    manifest = {"step": step, "leaves": names, "meta": meta or {},
                "dtypes": dtypes}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def _target(device) -> torch.device:
    """``device`` as a torch device; raises at once when it is a CUDA
    device and there is none, rather than after reading every file."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"cannot restore onto {device}: no CUDA device is available "
            "(pass device=\"cpu\" to restore onto the CPU)")
    return device


def load_checkpoint(path: str, like: Any, device="cuda",
                    shardings: Any | None = None):
    """Restore into the structure of ``like`` (only its structure and
    leaf names are read). Returns (tree of tensors on ``device``, step,
    meta); ``device`` defaults to the card, and a machine without one
    raises unless the caller names the CPU. With ``shardings``, a tree of
    ``distributed.sharding.Layout`` of ``like``'s structure
    (``sharding.placements(...)``), each leaf is instead distributed onto
    its mesh and placements, whatever layout it was saved from: the
    elastic-resize path (``device`` is not read). Every rank of the
    meshes calls it."""
    if shardings is None:
        device = _target(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    leaves = []
    for name, _ in named_leaves(like):
        arr = np.load(os.path.join(path, name.replace("/", "__") + ".npy"))
        if name in dtypes:
            dtype, unsigned = _EXOTIC[dtypes[name]]
            t = torch.from_numpy(arr.view(_SIGNED[unsigned][0])).view(dtype)
        else:
            t = torch.from_numpy(arr)
        leaves.append(t if shardings is not None else t.to(device))
    tree = tree_unflatten(like, leaves)
    if shardings is not None:
        from repro_torch.distributed.sharding import distribute

        tree = distribute(tree, shardings)
    return tree, manifest["step"], manifest.get("meta", {})


class CheckpointManager:
    """Rolling async checkpoints with crash-safe restore.

    Layout: ``<dir>/ckpt_<step>`` directories; ``latest()`` returns the
    newest complete one. ``keep`` bounds disk usage.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, meta: dict | None = None,
             blocking: bool = False):
        self.wait()
        # snapshot to host synchronously (a DTensor gathered whole on
        # every rank, which all call this); write asynchronously, on rank
        # 0 alone when the tree is sharded
        sharded = any(is_dtensor(x) for _, x in named_leaves(tree))
        host_tree = tree_map(
            lambda x: ((x.full_tensor() if is_dtensor(x) else x).detach()
                       .to("cpu", copy=True)
                       if isinstance(x, torch.Tensor) else np.array(x)),
            tree)
        path = os.path.join(self.dir, f"ckpt_{step:08d}")
        if sharded:
            import torch.distributed as dist

            if dist.get_rank() != 0:
                return

        def _write():
            save_checkpoint(path, host_tree, step=step, meta=meta)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def _gc(self):
        ckpts = sorted(
            d for d in os.listdir(self.dir) if d.startswith("ckpt_")
            and not d.endswith(".tmp")
        )
        for d in ckpts[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def latest(self) -> Optional[str]:
        ckpts = sorted(
            d for d in os.listdir(self.dir) if d.startswith("ckpt_")
            and not d.endswith(".tmp")
            and os.path.exists(os.path.join(self.dir, d, "manifest.json"))
        )
        return os.path.join(self.dir, ckpts[-1]) if ckpts else None

    def restore(self, like: Any, device="cuda"):
        """``load_checkpoint`` of the newest complete checkpoint onto
        ``device`` (the card unless named), or None when there is none."""
        device = _target(device)
        path = self.latest()
        if path is None:
            return None
        return load_checkpoint(path, like, device)
