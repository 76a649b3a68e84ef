"""SAMD lane format and arithmetic, conv-as-multiplication, the overflow
analysis and the op generator."""
