"""Device meshes of the reference's shapes and axis names, as
``torch.distributed`` DeviceMeshes.

Functions, so that importing this module touches no process group. Each
one builds its mesh over the process group the caller initialised
(``torch.distributed.init_process_group`` with its address, rank and
world size; nothing here reads them from the environment), whose world
size must be the mesh's size.

Topology (the reference's):
  single pod:  16 x 16 = 256 ranks, axes (data, model)
  multi-pod:   2 x 16 x 16 = 512 ranks, axes (pod, data, model); 'pod'
               is pure data parallelism.
"""
from __future__ import annotations

import torch.distributed as dist


def _mesh(device: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group "
            "with the group's address, rank and world size first")
    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_test_mesh(n_data: int = 2, n_model: int = 4, device: str = "cuda"):
    """A small (data, model) mesh over the initialised group."""
    return _mesh(device, (n_data, n_model), ("data", "model"))
