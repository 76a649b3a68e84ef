"""Seeded weights of a configuration, made on the device.

Each leaf is drawn from a generator of its own (``draw``), so the
program's weights and the reference's are the same numbers, and the
reference can make them again after the program's are freed. The
configuration's family (``families/<family>.py``) says which leaves
there are and how they are drawn: a kind stacked over the layers in one
call, or a layer at a time. Matmul weights are N(0, std) in bfloat16,
the embedding N(0, embed_std), norm weights ones. Imports nothing of
the program.
"""
from __future__ import annotations

import torch

from perfcells import families
from perfcells.traffic import sub_seed


def draw(seed: int, labels: tuple, shape, dtype, std: float,
         device) -> torch.Tensor:
    """N(0, std) of ``shape`` in one call, from the generator of the
    seed's ``("weights", *labels)`` stream."""
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "weights", *labels))
    t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return t.mul_(std)


def leaf_shapes(arch: dict) -> dict:
    """{leaf kind: (shape of one layer's leaf, dtype, std)}: ``blocks.*``
    kinds hold one per layer, the others one."""
    return families.load(arch["family"]).leaf_shapes(arch)


def make(arch: dict, seed: int, device, kinds=None) -> dict:
    """{leaf kind: tensor} (see ``families``)."""
    return families.load(arch["family"]).make(arch, seed, device, kinds)


def layers(arch: dict, seed: int, device):
    """Each layer's ``blocks.*`` leaves in turn."""
    return families.load(arch["family"]).layers(arch, seed, device)


def program_params(arch: dict, made: dict, device) -> dict:
    """The program's parameter tree over views of ``made``."""
    return families.load(arch["family"]).program_params(arch, made, device)
