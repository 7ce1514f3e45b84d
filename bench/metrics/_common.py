"""Arithmetic the metric readers share: a percentile over every sample,
means, and the bounds of the window's kernel launches."""
from __future__ import annotations

import numpy as np

from bench import peaks, work


def p95_ms(samples):
    """The 95th percentile (linear between order statistics) of every
    sample, in ms; None without samples."""
    if not samples:
        return None
    return float(np.percentile(np.asarray(samples, dtype=np.float64), 95) * 1e3)


def mean_ms(values):
    return float(np.mean(values) * 1e3) if len(values) else None


def roofline(run, fragment: str, call_bound):
    """100 * (sum of the window's launches' bounds) / (their device time):
    ``call_bound`` gives one model call's launches' bound in
    seconds (``kind`` "prefill" or "decode"); the device time is every
    traced kernel whose name holds ``fragment``. None untraced, or where no
    such kernel ran. ``call_bound(call, kind, config)``."""
    if run.trace is None:
        return None
    launches, device_s = 0, 0.0
    for name, (count, seconds) in run.trace["kernels"].items():
        if fragment in name:
            launches += count
            device_s += seconds
    if not launches or device_s <= 0:
        return None
    bound = (sum(call_bound(c, "prefill", run.config) for c in run.prefill_calls)
             + sum(call_bound(c, "decode", run.config) for c in run.decode_calls))
    return 100.0 * bound / device_s


def bound_s(n_bytes, flops):
    return peaks.bound_s(flops, n_bytes, "bfloat16")


__all__ = ["p95_ms", "mean_ms", "roofline", "bound_s", "work", "peaks"]
