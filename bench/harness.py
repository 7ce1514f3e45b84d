"""One cell of the benchmark, driven end to end: set-up (the engine
through the launcher's ``build_engine``, weights drawn on the device from
the seed), a closed-loop client pool over ``ServeEngine.submit`` /
``step`` with warm-up and a measured window on the host clock, optionally
traced, then the check of what the window served against the plain
reference. ``run.py`` is the command; tests and ``control.py`` call
``run_cell`` with other devices or configurations.

Everything a cell names is found by name: ``BENCHMARK.json``'s workload,
its configuration's ``file``, ``bench/traffic/<traffic>.json``,
``bench/reference/<reference>.py`` and ``bench/metrics/<metric>.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import pathlib
import time

import numpy as np

from bench import generator as traffic_mod
from bench import weights as weights_mod

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# Finding a cell's pieces by name
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's parameters
    end_to_end: list      # metric entries of BENCHMARK.json that apply here
    per_layer: list
    chips: int


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(wl)})")
    w = wl[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name=name, workload=w,
                config=json.loads((root / conf["file"]).read_text()),
                traffic=traffic_mod.load(root / "bench" / "traffic" / f"{w['traffic']}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                chips=int(w["chips"]))


def load_module(path: pathlib.Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: pathlib.Path = ROOT):
    return load_module(root / "bench" / "metrics" / f"{name}.py", "bench_metric")


def reference(kind: str, root: pathlib.Path = ROOT):
    return load_module(root / "bench" / "reference" / f"{kind}.py", "bench_reference")


# ---------------------------------------------------------------------------
# What a run records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Req:
    rid: int
    client: int
    prompt: list
    max_new: int
    submit_t: float
    emit_t: list = dataclasses.field(default_factory=list)
    slot: int = -1          # the decode slot its prefill ran on

    @property
    def done_t(self):
        return self.emit_t[-1] if len(self.emit_t) >= self.max_new else None


class Recorder:
    """The harness's own spans and counters around the program's calls,
    set as instance attributes of the engine's backend: no program file
    is edited. ``on`` gates the window's records."""

    def __init__(self, eng, trace: bool, sync):
        self.eng, self.trace, self.sync = eng, trace, sync
        self.on = False
        self.prefill_calls: list = []   # window: dicts
        self.decode_calls: list = []
        self.backend_s = 0.0            # backend wall inside the current step
        self.reqs: dict = {}
        self.spans: list = []           # traced runs: (name, start_ns, end_ns)
        be = eng.backend
        self._prefill, self._decode = be.run_prefill_chunk, be.run_decode
        be.run_prefill_chunk = self.run_prefill_chunk
        be.run_decode = self.run_decode

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span (name, start, end) on the trace's clock (epoch ns),
        kept when tracing."""
        start = time.time_ns()
        try:
            yield
        finally:
            if self.trace:
                self.spans.append((name, start, time.time_ns()))

    def run_prefill_chunk(self, ck, page_table):
        self.reqs[ck.request_id].slot = int(ck.slot)
        t0 = time.perf_counter()
        with self.span("bench.run_prefill_chunk"):
            out = self._prefill(ck, page_table)
            if self.trace:
                # a traced span closes when the chunk's device work is done
                self.sync()
        dt = time.perf_counter() - t0
        self.backend_s += dt
        if self.on:
            self.prefill_calls.append({"wall_s": dt, "offset": ck.offset,
                                       "tokens": len(ck.tokens),
                                       "table_width": int(len(page_table))})
        return out

    def run_decode(self, slots, page_tables=None, audit_pages=None):
        be = self.eng.backend
        kv = [int(be.positions[s]) + 2 if s in slots else 0
              for s in range(len(be.positions))]
        t0 = time.perf_counter()
        with self.span("bench.run_decode"):
            out = self._decode(slots, page_tables=page_tables, audit_pages=audit_pages)
        dt = time.perf_counter() - t0
        self.backend_s += dt
        if self.on:
            self.decode_calls.append({"wall_s": dt, "rows": len(be.positions),
                                      "active": len(slots), "kv_lens": kv,
                                      "table_width": int(page_tables.shape[1])
                                      if page_tables is not None else 0})
        return out


# ---------------------------------------------------------------------------
# Set-up
# ---------------------------------------------------------------------------


def build(cell: Cell, seed: int, device, port_cfg=None):
    """(engine, weights, port config, set-up facts) for ``cell``: the
    published config (``get_config``; ``port_cfg`` replaces it in tests),
    weights drawn from ``seed`` on ``device``, the engine from the
    launcher's parser and ``build_engine`` with the cell's flags. The KV
    tier (``--mrm-gb``, which also holds the metered weights) is sized so
    that the memory plane starts evicting where the compute page pool,
    allocated whole at start with one compute page per memory-plane page,
    would otherwise have to grow."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import EngineConfig

    conf, mix = cell.config, cell.traffic
    if mix.get("loop") != "closed":
        raise ValueError(f"traffic loop {mix.get('loop')!r}: the harness drives a closed loop")
    full = get_config(conf["arch"])
    cfg = port_cfg or full
    params = weights_mod.draw(tfm.model_defs(cfg), seed, device, cfg.param_dtype)
    slots, mcl, pt = int(mix["clients"]), int(mix["max_cache_len"]), int(conf["page_tokens"])
    pool_pages = max(16, 1 + slots * -(-mcl // pt))
    metered_page = full.kv_bytes_per_token() * pt + full.state_bytes_per_page()
    weights_metered = full.param_counts()["total"] * 2
    # the engine evicts cached prefixes above this share of the tier, which
    # also holds the metered weights: put that mark at the pool's last page
    mark = EngineConfig().kv_high_watermark
    mrm_bytes = (weights_metered + (pool_pages - 1 - slots) * metered_page) / mark
    args = serve.parser().parse_args([
        "--arch", conf["arch"], "--slots", str(slots), "--page-tokens", str(pt),
        "--chunk-tokens", str(conf["chunk_tokens"]), "--paged-kernel", "on",
        "--mrm-gb", repr(mrm_bytes / 2 ** 30), "--seed", str(seed)])
    eng = serve.build_engine(args, cfg, full, params, device=device, max_cache_len=mcl)
    eng.ecfg.eos_token = -1          # random weights: a request ends at its length
    leaves = _leaves(eng.backend.paged_caches)
    if leaves[0].shape[1] != pool_pages:
        raise RuntimeError(f"compute pool has {leaves[0].shape[1]} pages, "
                           f"the harness sized the KV tier for {pool_pages}")
    compute_page = sum(a.shape[0] * a[0, 0].numel() * a.element_size() for a in leaves)
    facts = {"pool_pages": pool_pages, "metered_page_bytes": float(metered_page),
             "compute_page_bytes": float(compute_page), "mrm_gb": mrm_bytes / 2 ** 30}
    return eng, params, cfg, facts


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


# ---------------------------------------------------------------------------
# The host: a CPU of its own for the thread that drives the card
# ---------------------------------------------------------------------------


def cpu_list(text: str) -> set:
    """The CPUs of a kernel CPU list such as ``0-3,8``."""
    out = set()
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            out.update(range(int(lo), int(hi or lo) + 1))
    return out


def siblings(cpu: int) -> set:
    """``cpu`` and its hyperthread siblings (read from sysfs)."""
    path = pathlib.Path(f"/sys/devices/system/cpu/cpu{cpu}/topology/thread_siblings_list")
    try:
        return cpu_list(path.read_text()) | {cpu}
    except OSError:
        return {cpu}


def cpu_plan(allowed, siblings_of=siblings):
    """(the driving thread's CPU, the other threads' CPUs): the highest
    allowed CPU, and every allowed CPU off its core, or every other one
    where its core holds them all. None with a single CPU."""
    allowed = sorted(allowed)
    if len(allowed) < 2:
        return None
    main = allowed[-1]
    core = siblings_of(main)
    return main, ([c for c in allowed if c not in core] or allowed[:-1])


class HostPin:
    """The calling thread alone on one CPU, and this process's other
    threads on the rest (``cpu_plan``), so that the thread that launches
    every kernel neither moves between CPUs nor shares its core with the
    process's own helpers. ``apply`` again once more threads have started
    (a new thread inherits its creator's CPU); ``restore`` puts back the
    affinities found. Touches this process's threads alone."""

    def __init__(self):
        import threading
        self.me = threading.get_native_id()
        self.before = {}
        for tid in self._threads():
            try:
                self.before[tid] = os.sched_getaffinity(tid)
            except OSError:                       # the thread has ended
                pass
        self.plan = cpu_plan(self.before[self.me])

    @staticmethod
    def _threads() -> list:
        return [int(t) for t in os.listdir("/proc/self/task")]

    def _set(self, tid: int, cpus) -> None:
        try:
            os.sched_setaffinity(tid, cpus)
        except OSError:                           # the thread has ended
            pass

    def apply(self) -> None:
        if self.plan is None:
            return
        main, others = self.plan
        for tid in self._threads():
            self._set(tid, {main} if tid == self.me else set(others))

    def restore(self) -> None:
        for tid in self._threads():
            self._set(tid, self.before.get(tid, self.before[self.me]))

    def counters(self) -> dict:
        """Steal time (s) of the driving CPU and of all CPUs, and the
        driving thread's involuntary context switches, for the log."""
        hz = os.sysconf("SC_CLK_TCK")
        out = {"steal_cpu_s": 0.0, "steal_all_s": 0.0, "involuntary": 0}
        try:
            for line in pathlib.Path("/proc/stat").read_text().splitlines():
                f = line.split()
                if f and f[0] == "cpu" and len(f) > 8:
                    out["steal_all_s"] = int(f[8]) / hz
                elif self.plan and f and f[0] == f"cpu{self.plan[0]}" and len(f) > 8:
                    out["steal_cpu_s"] = int(f[8]) / hz
            status = pathlib.Path(f"/proc/self/task/{self.me}/status").read_text()
            for line in status.splitlines():
                if line.startswith("nonvoluntary_ctxt_switches:"):
                    out["involuntary"] = int(line.split()[1])
        except OSError:
            pass
        return out


# ---------------------------------------------------------------------------
# The closed loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    """What the window measured, read by the metric files."""
    setup_s: float
    window_s: float
    tokens_out: int
    ttft_s: list
    itl_s: list
    steps: list           # (wall_s, backend_s, prompt tokens computed)
    prefill_calls: list
    decode_calls: list
    counters: dict
    config: dict
    trace: dict = None
    finished: list = None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, port_cfg=None, log=print):
    """Set up, warm up, measure ``seconds`` on the host clock, and check.
    Returns (Run, check dict, device dict, sampled sequences, weights)."""
    import torch

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    eng, params, cfg, facts = build(cell, seed, device, port_cfg)
    log(f"pool {facts['pool_pages']} pages; a page meters "
        f"{facts['metered_page_bytes']:.0f} B and holds {facts['compute_page_bytes']:.0f} B "
        f"on the device (ratio {facts['compute_page_bytes'] / facts['metered_page_bytes']:.4f}); "
        f"KV tier {facts['mrm_gb']:.3f} GiB with the weights")
    stream = traffic_mod.Stream(cell.traffic, seed, cfg.vocab_size)
    rec = Recorder(eng, trace, sync)
    clients = int(cell.traffic["clients"])
    inflight: dict = {}
    finished_by: dict = {c: 0 for c in range(clients)}

    def submit(client: int, now: float):
        r = stream.next()
        rid = eng.submit(r.prompt, max_new_tokens=r.max_new)
        req = Req(rid, client, r.prompt, r.max_new, now)
        rec.reqs[rid] = req
        inflight[rid] = req

    def step():
        rec.backend_s = 0.0
        pf0 = eng.prefill_tokens_computed
        t0 = time.perf_counter()
        with rec.span("bench.step"):
            eng.step()
        t1 = time.perf_counter()
        for rid, req in list(inflight.items()):
            n = len(eng.outputs[rid])
            while len(req.emit_t) < n:
                req.emit_t.append(t1)
            if n >= req.max_new:
                del inflight[rid]
                finished_by[req.client] += 1
                submit(req.client, t1)
        return t1 - t0, rec.backend_s, t1, eng.prefill_tokens_computed - pf0

    host = HostPin() if cuda else None
    if host is not None:
        host.apply()
    now = time.perf_counter()
    for c in range(clients):
        submit(c, now)
    while min(finished_by.values()) < 1:        # warm-up: every slot turned over
        step()
    sync()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        from bench import trace as trace_mod
        prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        prof.__enter__()
        trace_mod.lazy(prof)
        rec.spans.clear()               # warm-up before the profiler: not traced
        marker_ns = time.time_ns()
        if cuda:
            torch.cuda._sleep(1000)     # the marker that aligns the two clocks
        # one more warm-up step under the profiler: its start-up delay
        # lands before the window, not in a gap the window measures
        step()
        sync()
    gc_pauses = []

    def gc_watch(phase, info, _t=[0.0]):
        if phase == "start":
            _t[0] = time.perf_counter()
        else:
            gc_pauses.append((info["generation"], time.perf_counter() - _t[0]))
    gc.callbacks.append(gc_watch)
    if host is not None:
        host.apply()                    # threads started in warm-up or tracing
        host0 = host.counters()
    cpu0 = time.process_time()
    skipped0, computed0 = eng.prefill_tokens_skipped, eng.prefill_tokens_computed
    rec.on = True
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    steps, t1 = [], w0
    while t1 - w0 < seconds:
        wall, backend, t1, prefilled = step()
        steps.append((wall, backend, prefilled))
    rec.on = False
    window_s = t1 - w0
    gc.callbacks.remove(gc_watch)
    if host is not None:
        host1 = host.counters()
        host.restore()
        log(f"host: the driving thread on cpu {host.plan[0] if host.plan else 'any'}, "
            f"others on {host.plan[1] if host.plan else 'any'}; steal "
            f"{host1['steal_cpu_s'] - host0['steal_cpu_s']:.2f} s on its cpu, "
            f"{host1['steal_all_s'] - host0['steal_all_s']:.2f} s on all; "
            f"{host1['involuntary'] - host0['involuntary']} involuntary switches")
    # where a window's host time went: CPU share and garbage collection
    pauses = [p for _, p in gc_pauses]
    log(f"window cpu {time.process_time() - cpu0:.3f} s of {window_s:.3f} wall; gc "
        f"{len(pauses)} collections, {sum(pauses):.3f} s, gen2 "
        f"{sum(1 for g, _ in gc_pauses if g == 2)}, max {max(pauses or [0]):.3f} s")
    counters = {"prefill_tokens_skipped": eng.prefill_tokens_skipped - skipped0,
                "prefill_tokens_computed": eng.prefill_tokens_computed - computed0,
                "steps": len(steps)}
    traced = None
    if trace:
        tt = [time.perf_counter()]
        prof.__exit__(None, None, None)
        tt.append(time.perf_counter())
        dev_events, marker = trace_mod.device_events(prof)
        tt.append(time.perf_counter())
        shift = 0 if marker is None else marker - marker_ns
        spans = [(n, s + shift, e + shift) for n, s, e in rec.spans]
        traced = trace_mod.reduce(dev_events, spans, window_s)
        tt.append(time.perf_counter())
        log(f"trace: stop {tt[1] - tt[0]:.1f} s, events {tt[2] - tt[1]:.1f} s "
            f"({len(dev_events[0])} device), reduce {tt[3] - tt[2]:.1f} s")
        del prof, dev_events
    reqs = list(rec.reqs.values())
    tokens_out = sum(1 for r in reqs for t in r.emit_t if w0 < t <= t1)
    ttft = [r.emit_t[0] - r.submit_t for r in reqs if r.emit_t and w0 < r.emit_t[0] <= t1]
    itl = [b - a for r in reqs for a, b in zip(r.emit_t, r.emit_t[1:]) if w0 < b <= t1]
    done = [r for r in reqs if r.done_t is not None and w0 < r.done_t <= t1]
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = window_s
    walls = sorted(steps, key=lambda s: -s[0])
    log("step wall s (max 5, with prompt tokens computed): "
        + ", ".join(f"{w:.3f} ({p})" for w, _, p in walls[:5])
        + f"; median {np.median([s[0] for s in steps]) if steps else 0:.3f}"
        + f"; itl max {max(itl) if itl else 0:.3f} s over {len(itl)} gaps")
    pool_after = _leaves(eng.backend.paged_caches)[0].shape[1]
    if pool_after != facts["pool_pages"]:
        log(f"the compute pool grew to {pool_after} pages")
    run = Run(setup_s=setup_s, window_s=window_s, tokens_out=tokens_out, ttft_s=ttft,
              itl_s=itl, steps=steps, prefill_calls=rec.prefill_calls,
              decode_calls=rec.decode_calls, counters=counters, config=cell.config,
              trace=traced, finished=done)

    # --- the check: a sample of the requests the window finished --------
    seqs = sample(cell, seed, done, eng)
    del eng, rec, stream, inflight
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    check = compare(cell, cfg, params, seqs)
    return run, check, dev, seqs, params


def sample(cell: Cell, seed: int, done: list, eng) -> list:
    """Requests the window finished, for the reference to score: the
    longest, then one from each of ``check.slots`` equal ranges of the
    decode slots (a fault in one part of the batch cannot hide), then more
    until ``check.served_tokens`` served tokens, each draw in an order
    drawn from the seed. Each as the sequence the reference scores (prompt
    + served tokens but the last) and the served tokens."""
    chk = cell.config["check"]
    want, strata = int(chk["served_tokens"]), int(chk["slots"])
    if not done:
        return []
    slots = int(cell.traffic["clients"])
    rng = np.random.default_rng([int(seed), 0x5eed])
    longest = max(done, key=lambda r: (len(r.prompt) + r.max_new, -r.rid))
    order = [done[i] for i in rng.permutation(len(done))]
    picked = [longest]
    for k in range(strata):
        lo, hi = k * slots // strata, (k + 1) * slots // strata
        got = next((r for r in order if lo <= r.slot < hi and r not in picked), None)
        if got is not None:
            picked.append(got)
    n = sum(r.max_new for r in picked)
    for r in order:
        if n >= want:
            break
        if r not in picked:
            picked.append(r)
            n += r.max_new
    seqs = []
    for r in picked:
        served = [int(t) for t in eng.outputs[r.rid][: r.max_new]]
        seqs.append({"rid": r.rid, "slot": r.slot, "tokens": list(r.prompt) + served[:-1],
                     "score_from": len(r.prompt) - 1, "served": served})
    return seqs


def reference_logits(cell: Cell, cfg, params, seqs, precision: str = "fp32") -> list:
    """The plain reference's logits at every scored position of ``seqs``."""
    w = weights_mod.per_layer(params, [(len(g.unit), g.repeats) for g in cfg.scan_groups()])
    return reference(cell.config["reference"]).logits(cell.config, w, seqs, precision)


def gaps(ref_logits, tokens) -> list:
    """How far below the reference's best logit each token's logit lies."""
    out = []
    import torch
    for lg, tok in zip(ref_logits, tokens):
        t = torch.as_tensor(tok, dtype=torch.long, device=lg.device)
        best = lg.max(dim=-1).values
        got = lg.gather(1, t[:, None])[:, 0]
        out.append((best - got).double().cpu().numpy())
    return out


def compare(cell: Cell, cfg, params, seqs, ref_logits=None) -> dict:
    """The reference over the sampled sequences in fp32 (or its logits
    ``ref_logits`` of these sequences, already computed); the widest gap of
    a served token below the reference's best logit, against its limit (a
    configuration whose limit is null has none that holds: not correct)."""
    conf = cell.config
    limit = conf["check"]["max_logit_gap"]
    if not seqs:
        return {"correct": False, "max_logit_gap": None, "limit": limit,
                "served_tokens": 0, "requests": 0}
    t0 = time.perf_counter()
    lg = ref_logits if ref_logits is not None else reference_logits(cell, cfg, params, seqs)
    g = gaps(lg, [s["served"] for s in seqs])
    worst = max(float(x.max()) for x in g)
    over = len(g) if limit is None else sum(1 for x in g if float(x.max()) > limit)
    return {"correct": over == 0, "max_logit_gap": worst, "limit": limit,
            "served_tokens": int(sum(len(s["served"]) for s in seqs)),
            "requests": len(seqs), "slots": len({s.get("slot") for s in seqs}),
            "reference_s": time.perf_counter() - t0,
            "failed_requests": int(over)}
