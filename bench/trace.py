"""Reduction of a ``torch.profiler`` trace of the card over the measured
window: device busy time (a frozen copy of ``scripts/profile_port_serve.py``'s
``device_busy_s``: the union of the device activities' intervals), device
time by kernel name, and the idle gaps labelled by the harness span that
was open on the host. Only device activity is traced (recording every host
operator doubled a step and took minutes to read); the host spans are the
harness's own, on the host clock, which a marker kernel aligns with the
trace's. The events stay in memory; nothing is exported."""
from __future__ import annotations

import numpy as np

# host spans the harness records, inner first: a gap is labelled by the
# innermost one open at its midpoint
SPANS = ("bench.run_prefill_chunk", "bench.run_decode", "bench.step")


def _union(starts, ends) -> tuple:
    """Disjoint sorted (starts, ends) of the union of the intervals."""
    if not len(starts):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(s) - 1)
    return s[first], reach[last]


def device_busy_s(starts, ends) -> float:
    """Seconds in which the card ran anything (kernel, copy, memset): the
    union of the device activities' intervals, in ns. Summing
    ``key_averages()``' self device times would count a kernel twice — once
    under its own name and once under the operator (or autograd node) that
    launched it."""
    s, e = _union(np.asarray(starts, np.int64), np.asarray(ends, np.int64))
    return float((e - s).sum()) / 1e9


def device_events(prof) -> tuple:
    """(device activities (names, starts_ns, ends_ns), the marker's start)
    of a stopped ``torch.profiler.profile`` of the card (``lazy``): its
    CUDA-side events that are not user annotations. The marker is the first
    ``torch.cuda._sleep`` spin kernel, which the harness launches at a known
    host time when tracing starts."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    names, starts, durs, marker = [], [], [], None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        name = e.name()
        if marker is None and "spin_kernel" in name:
            marker = e.start_ns()
            continue
        names.append(name)
        starts.append(e.start_ns())
        durs.append(e.duration_ns())
    starts = np.asarray(starts, np.int64)
    return (names, starts, starts + np.asarray(durs, np.int64)), marker


def reduce(dev, spans, window_s: float, top: int = 10) -> dict:
    """Everything the harness reads from one trace: ``busy_s``, ``kernels``
    (name -> [launches, device seconds]) and ``breakdown`` (``device_ops``:
    the ``top`` names by device seconds; ``idle_gaps``: idle seconds by the
    host span open during them, then the longest single gaps). ``dev`` is
    (names, starts_ns, ends_ns) of the device activities, ``spans`` the
    harness's host spans [(name, start_ns, end_ns)], both on one clock.
    Both are cut to the window: the ``bench.step`` spans but the first,
    which is warm-up under the profiler. The gaps before the first
    activity and after the last run to the window's ends."""
    names, starts, ends = dev
    host = {n: np.array(sorted((s, e) for k, s, e in spans if k == n), np.int64).reshape(-1, 2)
            for n in SPANS}
    steps = host["bench.step"][1:]
    if not len(steps):
        return {"busy_s": 0.0, "window_s": window_s, "kernels": {},
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    lo, hi = int(steps[0, 0]), int(steps[:, 1].max())
    starts, ends = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    keep = np.flatnonzero((ends > lo) & (starts < hi))
    s, e = np.maximum(starts[keep], lo), np.minimum(ends[keep], hi)
    kernels: dict = {}
    for i, d in zip(keep.tolist(), (e - s).tolist()):
        k = kernels.setdefault(names[i], [0, 0.0])
        k[0] += 1
        k[1] += d / 1e9
    bs, be = _union(s, e)
    gs = np.concatenate([[lo], be]) if len(bs) else np.array([lo])
    ge = np.concatenate([bs, [hi]]) if len(bs) else np.array([hi])
    pos = ge > gs
    gs, ge = gs[pos], ge[pos]
    label = np.full(len(gs), len(SPANS), np.int64)      # "between steps"
    mid = (gs + ge) // 2
    for j in range(len(SPANS) - 1, -1, -1):             # inner spans win
        sp = host[SPANS[j]]
        if not len(sp):
            continue
        i = np.searchsorted(sp[:, 0], mid, side="right") - 1
        inside = (i >= 0) & (mid <= sp[np.maximum(i, 0), 1])
        label[inside] = j
    names_l = [n.removeprefix("bench.") for n in SPANS] + ["the harness between steps"]
    sec = (ge - gs) / 1e9
    idle = sorted(([f"idle in {names_l[j]} (total)", float(sec[label == j].sum())]
                   for j in set(label.tolist())), key=lambda kv: -kv[1])
    for i in np.argsort(-sec, kind="stable")[:max(0, top - len(idle))]:
        idle.append([f"longest gap in {names_l[label[i]]}", float(sec[i])])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "busy_s": float((be - bs).sum()) / 1e9,
        "window_s": window_s,
        "kernels": kernels,
        "breakdown": {"device_ops": [[name, v[1]] for name, v in ops],
                      "idle_gaps": idle[:top]},
    }


def lazy(prof) -> None:
    """Keep a started profiler's raw events and skip building its event
    tree at stop (minutes for a window of host-bound steps): the harness
    reads the raw events."""
    prof.profiler._parse_kineto_results = lambda results: []
