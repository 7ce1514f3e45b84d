"""Managed-Retention Memory (MRM) control plane, copied from ``repro.core``
(pure Python, no tensors): memory technologies, DCM retention programming,
ECC sizing, endurance, refresh, tiering and the instrumented simulator the
serving engine meters every byte through."""
