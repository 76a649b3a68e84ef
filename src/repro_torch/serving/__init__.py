"""Continuous-batching serving engine over the paged KV pool."""
