"""Quantization policy, symmetric quantizer and SAMD weight packing."""
