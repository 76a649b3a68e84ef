"""Collective traffic and roofline terms of a traced step (the port of
``repro/launch/hlo_analysis.py``, whose name it keeps so that its
counterpart is found; there is no HLO here).

The reference parses the partitioned HLO that XLA compiled. The port
runs the step eagerly on DTensors and reads the collectives that
DTensor dispatches (``_c10d_functional`` ops) as they run, with
:class:`CollectiveCounter`: operand bytes per rank, under the
reference's kinds. Eager runs every layer, so there is no
``loop_multiplier``: a collective inside the layer loop is counted each
time it runs, where the reference multiplies a scan body's count by its
trip count. There is no counterpart of ``roofline_from_compiled``: no
compiled program reports its own cost here; the dry-run takes the
analytic cost (``analytic_costs.cell_cost``) and the counted bytes.

Hardware constants (one NVIDIA H100 SXM; NVIDIA's data sheet, dense):
  peak bf16 compute 989 TFLOP/s, HBM 3.35 TB/s, 80 GB;
  collectives 50 GB/s a GPU: one 400 Gb/s InfiniBand port per GPU, as
  in an 8-GPU HGX H100 node. A 16-wide mesh axis spans two such nodes,
  so its collectives run at the network's rate, not NVLink's.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
NET_BW = 50e9

# the collective op DTensor dispatches -> the reference's kind; another
# collective op is counted under its own name
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """While entered, counts every collective DTensor dispatches on this
    rank: its operand's bytes (the local tensor it sends: a shard for an
    all-gather, the whole input of a reduce-scatter or an all-reduce), as
    the reference's parser sums operand sizes. DTensor ops pass through
    to DTensor, so what is counted is the local ops they become.
    ``CommDebugMode`` counts the same ops but gives no bytes.

    It also counts, on this rank's local tensors (not the global op's):
    ``flops`` by ``torch.utils.flop_counter``'s formulas, and
    ``peak_bytes``, the most bytes of storage live at once, the tensors
    given to :meth:`hold` (a step's inputs) included; a storage counts
    from the op that makes it until it is freed. Ops that DTensor's
    sharding propagation runs on global shapes under a fake mode of its
    own are not counted."""

    def __init__(self):
        super().__init__()
        self._bytes: dict = defaultdict(int)
        self._count: dict = defaultdict(int)
        self.flops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()
        self._fake_mode = None

    def __enter__(self):
        self._fake_mode = active_fake_mode()
        return super().__enter__()

    def hold(self, tensors) -> None:
        """Count the storages of ``tensors`` (DTensors: their local
        shards) as live from now on."""
        for t in tensors:
            self._hold(t)

    def _hold(self, t) -> None:
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        weakref.finalize(st, self._release, n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_mode:
            return out
        packet = func._overloadpacket
        if func.namespace in _COLLECTIVE_NAMESPACES:
            if packet.__name__ not in _NOT_COLLECTIVES:
                kind = _KINDS.get(packet.__name__, packet.__name__)
                self._bytes[kind] += _nbytes(args[0])
                self._count[kind] += 1
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return out

    def stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self._bytes), dict(self._count))


@dataclasses.dataclass
class Roofline:
    """Roofline terms from PER-RANK quantities: ``term = per_rank_quantity
    / per_card_rate``, which equals ``global_quantity / (chips * rate)``
    (the reference's arithmetic, the H100's rates)."""

    flops: float             # per rank
    hbm_bytes: float         # per rank
    collective_bytes: float  # per rank
    chips: int

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / NET_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6·N·D for training (fwd+bwd+update), 2·N·D for inference.
    Callers pass N_active for MoE."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_params_active * tokens
