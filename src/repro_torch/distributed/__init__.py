"""Gradient compression with error feedback (the port of
``repro.distributed.compression``)."""
