"""Static lane-safety checks of SAMD configurations (the port's part of
``repro.analysis``): the bit-width abstract interpreter (``lanes``) and
the matmul and conv contracts that ``kernels.ops`` runs before every
matmul and conv."""
