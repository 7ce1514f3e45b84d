"""Mamba2 SSD chunk scan: one kernel for every prefill and extend chunk of
an SSM layer, continuing from the state page it reads."""
from .ops import ssd_scan
from .ref import ssd_scan_ref, ssd_scan_sequential

__all__ = ["ssd_scan", "ssd_scan_ref", "ssd_scan_sequential"]
