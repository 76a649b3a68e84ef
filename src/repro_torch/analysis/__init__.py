"""Static lane-safety analysis of SAMD configurations (the port's copy of
``repro.analysis``): the bit-width abstract interpreter (``lanes``), the
kernel contracts and shared-memory budgets (``contracts``) that
``kernels.ops`` and the serving engine run, and the repo-wide sweep
(``python -m repro_torch.analysis.certify``)."""
