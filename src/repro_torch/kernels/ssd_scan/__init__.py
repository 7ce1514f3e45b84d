"""Mamba2 SSD chunk scan: one kernel for every prefill and extend chunk of
an SSM layer, continuing from the state page it reads, and the backward
kernels of the training path under one autograd function (``SSDScan``)."""
from .ops import SSDScan, ssd_scan, ssd_scan_bwd
from .ref import ssd_scan_bwd_ref, ssd_scan_ref, ssd_scan_sequential

__all__ = ["SSDScan", "ssd_scan", "ssd_scan_bwd", "ssd_scan_bwd_ref", "ssd_scan_ref",
           "ssd_scan_sequential"]
