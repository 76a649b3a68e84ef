"""Roofline share of the ``samd_matmul_tile`` launches in the profiled
stretch: the least time their operations and bytes need at the H100's
peaks over their device time (see ``_roofline.py``)."""
from perfcells.metrics import _roofline


def read(t):
    return _roofline.share(t, "samd_matmul_tile")
