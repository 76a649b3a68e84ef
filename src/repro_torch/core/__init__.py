"""SAMD lane format: masks and 32-bit word pack/unpack."""
