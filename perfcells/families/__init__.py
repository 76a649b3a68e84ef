"""A configuration's model, one file a family: ``families/<family>.py``,
found by the ``family`` key of the configuration and loaded by path, so a
new family is one new file and no list here changes.

``weights.py``, ``reference.py``, ``costs.py``, ``smoke.py`` and
``harness.py`` hand every question about the model to the family's file.
It defines:

``SMALL``
    the widths and counts of the family's cells on the CPU (``smoke``).
``leaf_shapes(arch)``
    {leaf kind: (one leaf's shape, dtype, std)}; ``blocks.*`` kinds hold
    one leaf a layer.
``make(arch, seed, device, kinds=None)``
    {leaf kind: tensor} of the seed's weights, or of ``kinds`` alone:
    ``embed`` and ``lm_head`` (which the reference draws by themselves),
    and, for a family that stacks them, each ``blocks.*`` kind over the
    layers. Each leaf comes from a generator of its own
    (``weights.draw``), so any subset draws the same numbers.
``layers(arch, seed, device)``
    an iterator over the layers: layer ``i``'s ``blocks.*`` leaves. A
    family may draw each layer from generators of its own
    (``weights.draw(seed, (kind, i), ...)``), so that the reference holds
    one layer at a time.
``program_params(arch, made, device)``
    the program's parameter tree over ``make``'s tensors (what the
    default ``harness.build_engine`` packs).
``reference_layer(ref, leaves)``
    one layer's weights as the reference multiplies them
    (``ref.weight`` quantizes and widens a matmul weight).
``block(ref, w, seg)``
    the reference's layer: ``seg.h`` from the layer's input to its
    output (``reference.Segment``; ``seg.kv`` keeps what later segments
    attend to).
``matmul_params_per_token(arch, head=True)``,
``token_flops(arch, context)``, ``prefill_flops(arch, start, length)``
    the model's operations (``costs``).
``build_engine(config, mix, seed, device)`` (optional)
    the program's engine over the seed's weights, in place of
    ``harness.default_build_engine``: a family too large to draw whole
    draws and packs a layer at a time (``harness.serving_engine`` takes
    packed parameters).

Only ``build_engine`` may import the program. ``_shared.py`` holds what
the attention families share.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

DIR = Path(__file__).resolve().parent
_loaded: dict = {}


def load(family: str):
    """The module of ``DIR/<family>.py`` (loaded once a path)."""
    path = DIR / f"{family}.py"
    if path not in _loaded:
        if not path.is_file():
            raise ValueError(f"no model family {family!r}: no {path}")
        spec = importlib.util.spec_from_file_location(
            f"perfcells_family_{family}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]
