"""(The decode cell's copy of ``prefill_pad_share``, which moves its token
gaps: every active row waits out an admission's prefill.)"""
from perfcells.metrics.prefill_pad_share import read  # noqa: F401
