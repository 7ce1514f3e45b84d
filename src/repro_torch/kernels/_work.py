"""The kernels' hook for the dry run and the per-device analysis
(``launch/hlo_analysis.py``).

``entry(work, meta, shard)`` wraps a kernel wrapper. With no analysis
active and a plain tensor on the CPU or the card first, the wrapper runs
as written: that one check is all the card's paths pay. Otherwise:

- DTensor inputs go to ``shard``, which runs the wrapper on each device's
  local tensors (``runtime/sharding.py``'s ``local_of`` / ``global_of``)
  or raises for a placement the kernel cannot honour;
- while an analysis is active, the call is recorded as one launch of the
  kernel with ``work(*args, **kwargs)`` -> (flops, bytes) — the formulas
  of PERF.md's bound column, from shapes alone — and the ops inside it
  (the plain version's, on the CPU) are not counted on top, and its
  outputs are made dense as the kernels write them, so a CPU step and its
  meta trace count the same;
- ``meta`` tensors get ``meta(*args, **kwargs)``: outputs of the kernel's
  shapes and dtypes, no arithmetic.
"""
from __future__ import annotations

import functools

import torch

TRACE = None    # the active analysis (hlo_analysis.Trace), or None


def _plain(t) -> bool:
    return type(t) is torch.Tensor and not t.is_meta


def entry(work, meta, shard=None):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if TRACE is None and _plain(args[0]):
                return fn(*args, **kwargs)
            return _slow(wrapper, fn, work, meta, shard, args, kwargs)
        return wrapper
    return deco


def _slow(wrapper, fn, work, meta, shard, args, kwargs):
    from repro_torch.runtime.sharding import is_dtensor
    tensors = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
    if any(is_dtensor(t) for t in tensors):
        if shard is None:
            raise NotImplementedError(f"{fn.__name__} takes no DTensor inputs")
        return shard(wrapper, *args, **kwargs)
    body = meta if args[0].is_meta else fn
    if TRACE is None or work is None:
        return body(*args, **kwargs)
    flops, n_bytes = work(*args, **kwargs)
    with TRACE.kernel(fn.__name__, flops, n_bytes) as record:
        out = body(*args, **kwargs)
        if isinstance(out, tuple):
            return record(tuple(_dense(t) for t in out))
        return record(_dense(out))


def _dense(t):
    return t.contiguous() if isinstance(t, torch.Tensor) else t
