"""Synthetic training data (the port of ``repro.data``)."""
from repro_torch.data.pipeline import SyntheticLM

__all__ = ["SyntheticLM"]
