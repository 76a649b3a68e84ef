"""Continuous-batching serving engine over the paged KV pool, and the
async front door over it (SLO-aware admission, token streaming, latency
metrics)."""
from repro_torch.serving.engine import PageAllocator, Request, ServingEngine
from repro_torch.serving.scheduler import (
    FifoPolicy, QueueEntry, SchedulingPolicy, SloPolicy, make_policy,
)
from repro_torch.serving.server import (
    AsyncServer, RejectedRequest, RequestCost, TokenStream, price_request,
)

__all__ = [
    "AsyncServer",
    "FifoPolicy",
    "PageAllocator",
    "QueueEntry",
    "RejectedRequest",
    "Request",
    "RequestCost",
    "SchedulingPolicy",
    "ServingEngine",
    "SloPolicy",
    "TokenStream",
    "make_policy",
    "price_request",
]
