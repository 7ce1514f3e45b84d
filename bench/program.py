#!/usr/bin/env python3
"""The traced run of one cell with the program's own spans
(``repro_torch.runtime.tracing``) read beside the card's trace.

    python3 bench/program.py --workload mamba2.chat --seed 12345 --seconds 50

Runs ``bench/run.py``'s traced run (``--trace 1``) as it is, with the
program's tracer on from set-up to the end of the window, and prints
``run.py``'s result line, its breakdown's idle gaps labelled by the
innermost span open at each gap, the program's included; then one more
JSON line: the program-span metrics (``bench/metrics/engine_self_ms.py``,
``memplane_ms``, ``decode_host_ms``, ``decode_sync_ms``,
``decode_launches``), the idle seconds inside each harness span by
innermost span, the device activities by the span open at their launch,
and what reading them cost. The harness's own files run unchanged:
``program_spans`` wraps, while it is open, ``harness.build`` (the tracer
on), ``torch.cuda._sleep`` (the host time of the marker that aligns the
clocks), ``trace.device_events`` (the tracer drained, the CUDA runtime's
launch records read), ``trace.reduce`` (the harness's spans) and
``harness.run_cell`` (the attribution). Where the
program has no tracer, the run is ``run.py``'s and the new metrics print
nothing.
"""
import os
import sys
import time

T_START = time.perf_counter()      # CLOCK_MONOTONIC: it holds across exec
if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    # one hash seed, as ``run.py`` runs; set-up counts from the first start
    os.environ["PYTHONHASHSEED"] = "0"
    os.environ["BENCH_PROCESS_START"] = repr(T_START)
    os.execv(sys.executable, [sys.executable, *sys.argv])

import collections  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, trace  # noqa: E402

# the metrics read from the program's spans, and their units
METRICS = {"engine_self_ms": "ms", "memplane_ms": "ms", "decode_host_ms": "ms",
           "decode_sync_ms": "ms", "decode_launches": "launches"}


def program_tracer():
    """The program's own tracer, or None for a program without one."""
    try:
        from repro_torch.runtime.tracing import TRACER
    except ImportError:
        return None
    return TRACER


def launch_times(prof) -> tuple:
    """(the host time each device activity was launched, the count of CUDA
    runtime records read, the marker's launch time) of a stopped
    ``torch.profiler.profile`` of the card: the activities in
    ``device_events``' order, each paired with the runtime call
    (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) that shares its
    correlation id; the profiler records these calls as CPU-side events on
    the trace's clock. -1 for an activity without a record; None for a
    marker without one."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    corr, launched, marker = [], {}, None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            launched[e.correlation_id()] = e.start_ns()
            continue
        if e.is_user_annotation():
            continue
        if marker is None and "spin_kernel" in e.name():
            marker = e.correlation_id()
            continue
        corr.append(e.correlation_id())
    launched.pop(0, None)                # events outside any correlation
    return (np.array([launched.get(c, -1) for c in corr], np.int64), len(launched),
            launched.get(marker))


def clock_offset(before: int, after: int, record) -> int:
    """What to add to a ``time.time_ns()`` stamp to put it on the clock of
    the runtime records, from the marker's launch: ``before`` and
    ``after`` are stamps taken around the call that launched it, ``record``
    its runtime record's start. 0 where the record lies between the stamps
    (the two clocks agree to within that call), else the record less the
    first stamp; 0 without a record."""
    if record is None or before <= record <= after:
        return 0
    return int(record) - int(before)


def nest(spans) -> tuple:
    """The innermost of nested spans at every instant: (bounds, inner) with
    ``inner[k]`` the index into ``spans`` of the innermost span open from
    ``bounds[k]`` to ``bounds[k + 1]`` (-1: none). ``spans`` is a list of
    (start, end, rank), each holding [start, end], its end included, as
    ``reduce`` counts it: at one start, the longer span is the outer one,
    then the lower rank."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][0], -spans[i][1], spans[i][2]))
    bounds, inner, stack = [], [], []

    def mark(t):
        bounds.append(max(t, bounds[-1]) if bounds else t)
        inner.append(stack[-1] if stack else -1)

    for i in order:
        s = spans[i][0]
        while stack and spans[stack[-1]][1] < s:
            mark(spans[stack.pop()][1] + 1)
        stack.append(i)
        mark(s)
    while stack:
        mark(spans[stack.pop()][1] + 1)
    return np.asarray(bounds, np.int64), np.asarray(inner, np.int64)


def innermost(nested, times) -> np.ndarray:
    """The index of the innermost span open at each of ``times`` (-1: none)."""
    bounds, inner = nested
    if not len(bounds):
        return np.full(len(times), -1, np.int64)
    k = np.searchsorted(bounds, np.asarray(times, np.int64), side="right") - 1
    return np.where(k >= 0, inner[np.maximum(k, 0)], -1)


def attribute(dev, launch_ns, spans, program, top: int = 10) -> dict:
    """What the program's spans say about one trace. ``dev`` and ``spans``
    are as ``bench/trace.py``'s ``reduce`` takes them, ``program`` the program's spans
    (``Span``: name, start, end, id, parent, ...) on the same clock, and
    ``launch_ns`` the launch time of each device activity (``launch_times``;
    where every one is -1, the activity's device start stands in). Cut to
    the window as ``reduce`` cuts it. Returns:

    - ``idle_gaps``: ``reduce``'s breakdown with each gap labelled by the
      innermost span open at its midpoint, the program's included;
    - ``idle_inside``: {harness label: {innermost label: idle seconds}};
    - ``launches``: {span name: [device activities launched with it
      innermost, spans of that name, their device seconds]};
    - ``decode_launches``: device activities launched inside each
      ``backend.decode`` span of the window, one count a call;
    - ``launch_clock``: ``runtime``, ``device_start`` or ``mixed`` (how
      many activities had a runtime record); ``none`` without activities."""
    _, starts, ends = dev
    steps = np.array(sorted((s, e) for k, s, e in spans if k == "bench.step"),
                     np.int64).reshape(-1, 2)[1:]
    if not len(steps):
        return {"idle_gaps": [], "idle_inside": {}, "launches": {}, "decode_launches": [],
                "launch_clock": "none"}
    lo, hi = int(steps[0, 0]), int(steps[:, 1].max())
    starts, ends = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    keep = np.flatnonzero((ends > lo) & (starts < hi))
    bs, be = trace._union(np.maximum(starts[keep], lo), np.minimum(ends[keep], hi))
    gs = np.concatenate([[lo], be]) if len(bs) else np.array([lo])
    ge = np.concatenate([bs, [hi]]) if len(bs) else np.array([hi])
    pos = ge > gs
    gs, ge = gs[pos], ge[pos]
    mid, sec = (gs + ge) // 2, (ge - gs) / 1e9

    bench = [(s, e, n.removeprefix("bench.")) for n, s, e in spans if n in trace.SPANS]
    outside = "the harness between steps"
    # every label by id: the harness's, the program's names, then outside
    kinds = sorted({n for _, _, n in bench}) + sorted({p.name for p in program}) + [outside]
    kid = {n: k for k, n in enumerate(kinds)}
    none = kid[outside]
    bench_k = np.array([kid[n] for _, _, n in bench] + [none], np.int64)
    prog_k = np.array([kid[p.name] for p in program] + [none], np.int64)
    both_k = np.concatenate([bench_k[:-1], prog_k])
    both = both_k[innermost(nest([(s, e, 0) for s, e, _ in bench]
                                 + [(p.start, p.end, 1) for p in program]), mid)]
    harness = bench_k[innermost(nest([(s, e, 0) for s, e, _ in bench]), mid)]
    totals = np.bincount(both, weights=sec, minlength=len(kinds))
    pair = np.bincount(harness * len(kinds) + both, weights=sec,
                       minlength=len(kinds) ** 2).reshape(len(kinds), len(kinds))
    inside = {kinds[h]: {kinds[k]: float(pair[h, k]) for k in np.flatnonzero(pair[h])}
              for h in np.flatnonzero(pair.sum(axis=1))}
    idle = sorted(([f"idle in {kinds[k]} (total)", float(totals[k])]
                   for k in np.flatnonzero(totals)), key=lambda kv: -kv[1])
    for i in np.argsort(-sec, kind="stable")[:max(0, top - len(idle))]:
        idle.append([f"longest gap in {kinds[both[i]]}", float(sec[i])])

    have = np.asarray(launch_ns, np.int64) >= 0
    clock = ("none" if not len(have) else "runtime" if have.all()
             else "device_start" if not have.any()
             else f"mixed ({int(have.sum())} of {len(have)})")
    when = np.where(have, launch_ns, starts) if have.any() else starts
    win = np.flatnonzero((when >= lo) & (when <= hi))
    at = innermost(nest([(p.start, p.end, 0) for p in program]), when[win])
    dur = (ends[win] - starts[win]) / 1e9
    in_win = np.array([lo <= p.start and p.end <= hi for p in program], bool)
    n_spans = np.bincount(prog_k[:-1][in_win], minlength=len(kinds))
    n_launch = np.bincount(prog_k[at], minlength=len(kinds))
    dev_s = np.bincount(prog_k[at], weights=dur, minlength=len(kinds))
    launches = {kinds[k]: [int(n_launch[k]), int(n_spans[k]), float(dev_s[k])]
                for k in range(len(kinds)) if n_spans[k] or n_launch[k]}
    launches.pop(outside, None)
    # each span's enclosing backend.decode (itself included), parents first
    index = {p.id: i for i, p in enumerate(program)}
    call = np.full(len(program) + 1, -1, np.int64)
    for i in sorted(range(len(program)), key=lambda i: (program[i].start, -program[i].end)):
        p = program[i]
        call[i] = i if p.name == "backend.decode" else call[index.get(p.parent, -1)]
    owner = call[at]
    counts = np.bincount(owner[owner >= 0], minlength=len(program) + 1)
    calls = [i for i, p in enumerate(program) if p.name == "backend.decode" and in_win[i]]
    return {"idle_gaps": idle[:top], "idle_inside": inside, "launches": launches,
            "decode_launches": [int(counts[i]) for i in calls], "launch_clock": clock}


def with_program(traced: dict, prog: dict) -> dict:
    """``reduce``'s result with the program's attribution (``attribute``):
    the finer idle gaps in the breakdown, the rest under ``program``."""
    out = dict(traced)
    out["breakdown"] = dict(traced["breakdown"], idle_gaps=prog["idle_gaps"])
    out["program"] = prog
    return out


def covered_ns(intervals, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) that the union of ``intervals`` covers."""
    s = np.clip(np.asarray([a for a, _ in intervals], np.int64), lo, hi)
    e = np.clip(np.asarray([b for _, b in intervals], np.int64), lo, hi)
    us, ue = trace._union(s, e)
    return int((ue - us).sum())


def self_ms(program, name: str, children, also=()) -> list:
    """Per span named ``name``: its wall less the time covered by its
    descendants whose name starts with one of ``children`` and by the
    intervals ``also`` (start, end) inside it, ms."""
    index = {p.id: p for p in program}
    below = {}
    for p in program:
        if p.name.startswith(tuple(children)):
            q = index.get(p.parent)
            while q is not None and q.name != name:
                q = index.get(q.parent)
            if q is not None:
                below.setdefault(q.id, []).append((p.start, p.end))
    out = []
    for p in program:
        if p.name == name:
            cov = below.get(p.id, []) + [(s, e) for s, e in also if s < p.end and e > p.start]
            out.append((p.end - p.start - covered_ns(cov, p.start, p.end)) / 1e6)
    return out


def window_spans(spans, steps: int) -> list:
    """The last ``steps`` ``engine.step`` spans, which the harness's
    window ran, with every span below them."""
    keep = {p.id for p in [p for p in spans if p.name == "engine.step"][-steps:]} \
        if steps else set()
    index = {p.id: p for p in spans}
    out = []
    for p in spans:
        q = p
        while q is not None and q.id not in keep:
            q = index.get(q.parent)
        if q is not None:
            out.append(p)
    return out


@contextlib.contextmanager
def program_spans(log=print):
    """While open, every traced ``harness.run_cell`` records the program's
    spans from set-up on and hands them, cut to the window and moved onto
    the trace's clock, to the ``Run`` it returns (``run.program``: spans,
    counters, the harness's spans), with ``attribute``'s reading of the
    trace (``run.trace["program"]``; the breakdown's idle gaps labelled by
    the program's spans). Yields a dict of what was read; nothing of the
    harness's own arithmetic changes."""
    import torch
    tracer = program_tracer()
    state: dict = {}
    if tracer is None:
        yield state
        return
    patched = [(harness, "build"), (harness, "run_cell"), (trace, "device_events"),
               (trace, "reduce"), (torch.cuda, "_sleep")]
    orig = {name: getattr(mod, name) for mod, name in patched}

    def build(*args, **kwargs):
        state.clear()
        tracer.drain()
        tracer.enable()
        return orig["build"](*args, **kwargs)

    def sleep(cycles):
        before = time.time_ns()
        out = orig["_sleep"](cycles)
        state.setdefault("marker_ns", (before, time.time_ns()))
        return out

    def device_events(prof):
        tracer.disable()
        state["drained"] = tracer.drain()
        out = orig["device_events"](prof)
        t0 = time.perf_counter()
        state["launch_ns"], state["records"], state["marker_launch"] = launch_times(prof)
        state["records_s"] = time.perf_counter() - t0
        state["dev"], state["marker"] = out
        return out

    def reduce(dev, spans, *args, **kwargs):
        state["bench"] = spans
        return orig["reduce"](dev, spans, *args, **kwargs)

    def run_cell(cell, seed, seconds, traced, *args, **kwargs):
        out = orig["run_cell"](cell, seed, seconds, traced, *args, **kwargs)
        if traced and "drained" in state:
            attach(out[0], state, log)
        state["run"] = out[0]
        return out

    wrap = {"build": build, "run_cell": run_cell, "device_events": device_events,
            "reduce": reduce, "_sleep": sleep}
    for mod, name in patched:
        setattr(mod, name, wrap[name])
    try:
        yield state
    finally:
        for mod, name in patched:
            setattr(mod, name, orig[name])
        tracer.disable()
        tracer.drain()


def attach(run, state: dict, log) -> None:
    """The program's spans of one traced run onto its ``Run``, all on the
    trace's clock: the runtime records' launch times as they are; the
    program's spans moved by ``clock_offset``; the harness's spans, which
    the harness moved by its marker shift (the marker's device start less
    the host stamp before its launch, which also holds the host's time
    inside that first launch), moved back by it and by ``clock_offset``."""
    spans, counters = state["drained"]
    log_setup(spans, log)
    marker = state["marker"]
    before, after = state.get("marker_ns") or (None, None)
    shift = 0 if marker is None or before is None else marker - before
    offset = 0 if before is None else clock_offset(before, after, state["marker_launch"])
    state["clock"] = {"device_minus_stamp_ns": shift,
                      "launch_call_ns": None if before is None else after - before,
                      "record_minus_stamp_ns": None if state["marker_launch"] is None
                      or before is None else state["marker_launch"] - before,
                      "offset_ns": offset}
    bench = [(n, s - shift + offset, e - shift + offset) for n, s, e in state["bench"]]
    moved = [p._replace(start=p.start + offset, end=p.end + offset)
             for p in window_spans(spans, len(run.steps))]
    t0 = time.perf_counter()
    got = attribute(state["dev"], state["launch_ns"], bench, moved)
    state["attribute_s"] = time.perf_counter() - t0
    run.trace = with_program(run.trace, got)
    run.program = {"spans": moved, "counters": counters, "bench": bench}
    calls = sum(1 for p in spans if p.name == "model.forward")
    state["h2d_per_model_call"] = counters.get("backend.h2d_copies", 0) / calls if calls else None
    log_program(got, moved, state, log)


def log_setup(spans, log) -> None:
    """The kernel libraries' builds and loads (``kernels.*``)."""
    loads = [s for s in spans if s.name == "kernels.load"]
    builds = [s for s in spans if s.name == "kernels.build"]
    log(f"program set-up: {len(loads)} kernel libraries loaded in "
        f"{sum(s.end - s.start for s in loads) / 1e9:.2f} s ("
        + ", ".join(f"{s.attrs.get('source')} {(s.end - s.start) / 1e9:.2f} s" for s in loads)
        + f"); nvcc ran for {sum(s.attrs.get('nvcc', 0) for s in builds)} sources")


def log_program(got: dict, spans, state: dict, log) -> None:
    """What the program's spans said of the window."""
    for h in ("run_decode", "run_prefill_chunk"):
        inside = got["idle_inside"].get(h, {})
        total = sum(inside.values())
        named = sum(v for k, v in inside.items() if "." in k)
        log(f"idle inside {h}: {total:.3f} s, {100 * named / total if total else 0:.2f}% "
            "under a program span: " + ", ".join(
                f"{k} {v:.3f}" for k, v in sorted(inside.items(), key=lambda kv: -kv[1])[:6]))
    calls = got["decode_launches"]
    log(f"program: {len(spans)} spans in the window; {state['records']} runtime records "
        f"read in {state['records_s']:.1f} s, launch clock {got['launch_clock']}, "
        f"attribution {state['attribute_s']:.1f} s; decode launches a call "
        f"{min(calls, default=0)}-{max(calls, default=0)} over {len(calls)} calls; "
        f"host-to-device copies a model call {state['h2d_per_model_call']}; clocks "
        f"{state['clock']}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run_py = harness.load_module(ROOT / "bench" / "run.py", "bench_cli")

    def log(*parts):
        print(*parts, file=sys.stderr, flush=True)

    with program_spans(log) as state:
        rc = run_py.main(["--workload", args.workload, "--seed", str(args.seed),
                          "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0:
        return rc
    run = state.get("run")
    out = {"metrics": {}}
    for name, unit in METRICS.items():
        value = harness.metric_reader(name).read(run) if run is not None else None
        if value is not None:
            out["metrics"][name] = {"value": value, "unit": unit}
    prog = (run.trace or {}).get("program") if run is not None else None
    if prog is not None:
        counts = prog["decode_launches"]
        out["decode_launches_per_call"] = [min(counts, default=0), max(counts, default=0),
                                           len(counts)]
        out["decode_launches_counts"] = {str(k): v for k, v in
                                         sorted(collections.Counter(counts).items())}
        out["clock"] = state.get("clock")
        out["idle_inside"] = prog["idle_inside"]
        out["launches"] = dict(sorted(prog["launches"].items(), key=lambda kv: -kv[1][0]))
        out["launch_clock"] = prog["launch_clock"]
        out["read_s"] = {"records": state.get("records_s"),
                         "attribution": state.get("attribute_s")}
        out["h2d_per_model_call"] = state.get("h2d_per_model_call")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
