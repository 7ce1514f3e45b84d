"""The program's own spans in the traced run, on synthetic spans and device
events: self time less child spans, idle gaps labelled by the innermost
span (the program's inside the harness's), device activities put down to
the span open at their launch (by correlation id, or by device start where
the card gives no runtime records), each new reader's arithmetic, and
every existing metric reading the same with and without program spans."""
import json
import types

import numpy as np
import pytest

from bench import harness, program, trace
from repro_torch.runtime.tracing import Span

CONFIG = json.loads((harness.ROOT / "bench" / "configs" / "mamba2-2.7b.json").read_text())
NEW = ("engine_self_ms", "memplane_ms", "decode_host_ms", "decode_sync_ms", "decode_launches")


def sp(name, start, end, id, parent=0, rid=None, **attrs):
    return Span(name, start, end, id, parent, rid, attrs)


# two measured steps after a warm-up step; step 1 prefills a chunk (the
# harness syncs after it, outside the program's span) and decodes, step 2
# decodes
BENCH = [("bench.step", 0, 100),
         ("bench.step", 100, 300), ("bench.run_prefill_chunk", 120, 160),
         ("bench.run_decode", 200, 280),
         ("bench.step", 300, 400), ("bench.run_decode", 320, 390)]
PROGRAM = [
    sp("engine.step", 102, 298, 1, chunks=1, rows=4),
    sp("memplane.begin_step", 104, 106, 2, 1),
    sp("engine.prefill", 110, 180, 3, 1, rid=7),
    sp("kv.append_tokens", 112, 115, 4, 3, rid=7),
    sp("backend.prefill_chunk", 121, 150, 5, 3, rid=7),
    sp("memplane.meter_reads", 165, 170, 6, 3, rid=7),
    sp("engine.decode", 190, 290, 7, 1, rows=4),
    sp("backend.decode", 201, 279, 8, 7, rows=4),
    sp("backend.inputs", 202, 206, 9, 8),
    sp("model.forward", 206, 260, 10, 8),
    sp("model.ssm", 207, 230, 11, 10, layer=0),
    sp("model.ssm", 230, 259, 12, 10, layer=1),
    sp("backend.sample_sync", 262, 278, 13, 8),
    sp("memplane.meter_reads", 282, 286, 14, 7, rid=7),
    sp("engine.step", 302, 398, 15, rows=4),
    sp("engine.decode", 310, 395, 16, 15, rows=4),
    sp("backend.decode", 321, 389, 17, 16, rows=4),
    sp("model.forward", 322, 370, 18, 17),
    sp("model.ssm", 323, 345, 19, 18, layer=0),
    sp("model.ssm", 345, 369, 20, 18, layer=1),
    sp("backend.sample_sync", 371, 388, 21, 17),
    sp("kv.maintain", 396, 397, 22, 15),
]
# device activities (name, start, end) and the host time of their launch
DEV = [("k_warm", 10, 20, 5),
       ("ssd", 125, 158, 122), ("gemv", 212, 220, 208), ("gemv", 232, 240, 231),
       ("copy", 270, 275, 263), ("gemv", 330, 335, 324), ("gemv", 350, 360, 346),
       ("copy", 375, 380, 372)]


def _dev():
    names, starts, ends, launched = zip(*DEV)
    return (list(names), np.array(starts, np.int64), np.array(ends, np.int64)), \
        np.array(launched, np.int64)


def test_self_time_is_the_wall_less_what_children_cover():
    # engine.step 1: 196 ns less backend.prefill_chunk (29) and backend.decode
    # (78), and the harness's wrappers around them (40 and 80, which hold the
    # backend spans): 196 - 40 - 80 + (overlap the wrappers leave outside the
    # step: none) = 76
    wrappers = [(s, e) for n, s, e in BENCH if n in ("bench.run_prefill_chunk",
                                                     "bench.run_decode")]
    got = program.self_ms(PROGRAM, "engine.step", ("backend.",), wrappers)
    assert got == pytest.approx([(196 - 40 - 80) / 1e6, (96 - 70) / 1e6])
    # without the wrappers, only the backend spans
    assert program.self_ms(PROGRAM, "engine.step", ("backend.",)) == pytest.approx(
        [(196 - 29 - 78) / 1e6, (96 - 68) / 1e6])
    # descendants at any depth, and only those under the span itself
    assert program.self_ms(PROGRAM, "backend.decode", ("backend.sample_sync",)) == \
        pytest.approx([(78 - 16) / 1e6, (68 - 17) / 1e6])


def test_gaps_take_the_innermost_span_the_programs_inside_the_harnesss():
    dev, launched = _dev()
    got = program.attribute(dev, launched, BENCH, PROGRAM)
    idle = {k: v for k, v in got["idle_gaps"] if k.endswith("(total)")}
    # gaps in the window [100, 400): 100-125 (mid 112: kv.append_tokens),
    # 158-212 (mid 185: engine.prefill... 185 > 180: engine.step), 220-232
    # (mid 226: model.ssm), 240-270 (mid 255: model.ssm), 275-330 (mid 302:
    # engine.step of step 2 starts at 302 -> its span), 335-350 (mid 342:
    # model.ssm), 360-375 (mid 367: model.ssm), 380-400 (mid 390: a span
    # holds its end, as ``reduce`` counts it: bench.run_decode, 320-390)
    assert idle == pytest.approx({
        "idle in kv.append_tokens (total)": 25e-9, "idle in engine.step (total)": 109e-9,
        "idle in model.ssm (total)": (12 + 30 + 15 + 15) * 1e-9,
        "idle in run_decode (total)": 20e-9})
    inside = got["idle_inside"]
    assert inside["run_decode"] == pytest.approx({"model.ssm": 72e-9, "run_decode": 20e-9})
    assert inside["step"] == pytest.approx({"kv.append_tokens": 25e-9, "engine.step": 109e-9})
    # without program spans, the harness's labels as ``reduce`` gives them
    plain = program.attribute(dev, launched, BENCH, [])["idle_gaps"]
    want = trace.reduce(dev, BENCH, 300e-9)["breakdown"]["idle_gaps"]
    assert [k for k, _ in plain] == [k for k, _ in want]
    assert [v for _, v in plain] == pytest.approx([v for _, v in want])


def test_launches_go_to_the_span_open_at_the_launch():
    dev, launched = _dev()
    got = program.attribute(dev, launched, BENCH, PROGRAM)
    assert got["launch_clock"] == "runtime"
    # per decode call: gemv, gemv, copy under model.ssm / sample_sync
    assert got["decode_launches"] == [3, 3]
    assert got["launches"]["model.ssm"][:2] == [4, 4]
    assert got["launches"]["backend.sample_sync"][:2] == [2, 2]
    assert got["launches"]["backend.prefill_chunk"] == [1, 1, pytest.approx(33e-9)]
    assert "k_warm" not in str(got["launches"])      # before the window
    # no runtime records: the device start stands in
    fall = program.attribute(dev, np.full(len(launched), -1), BENCH, PROGRAM)
    assert fall["launch_clock"] == "device_start"
    assert fall["decode_launches"] == [3, 3]
    assert fall["launches"]["model.ssm"][0] == 4


class _Ev:
    def __init__(self, name, dev, start, end, corr, annotation=False):
        self._n, self._d, self._s, self._e, self._c, self._a = \
            name, dev, start, end, corr, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._a


def test_device_activities_pair_with_their_runtime_records_by_correlation_id():
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_Ev("cudaLaunchKernel", cpu, 5, 6, 3),
              _Ev("void at::native::(anonymous namespace)::spin_kernel(long)", cuda, 7, 8, 3),
              _Ev("cudaLaunchKernel", cpu, 9, 10, 11),
              _Ev("cudaMemcpyAsync", cpu, 30, 31, 12),
              _Ev("bench.step", cuda, 10, 50, 0, annotation=True),
              _Ev("k1", cuda, 12, 20, 11),
              _Ev("Memcpy HtoD", cuda, 32, 33, 12),
              _Ev("k2", cuda, 40, 45, 99)]                    # no record
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    (names, starts, _), marker = trace.device_events(prof)
    launched, records, marker_launch = program.launch_times(prof)
    assert names == ["k1", "Memcpy HtoD", "k2"] and marker == 7
    assert launched.tolist() == [9, 30, -1] and records == 3 and marker_launch == 5
    dev = (names, starts, starts + 1)
    spans = [("bench.step", 0, 1), ("bench.step", 1, 50)]
    assert program.attribute(dev, launched, spans, [])["launch_clock"] == "mixed (2 of 3)"


def test_the_clock_offset_is_read_off_the_markers_launch():
    # the record between the stamps around its launch: one clock
    assert program.clock_offset(100, 140, 120) == 0
    assert program.clock_offset(100, 140, 100) == program.clock_offset(100, 140, 140) == 0
    # outside them: the record less the first stamp, either way
    assert program.clock_offset(100, 140, 1_000_100) == 1_000_000
    assert program.clock_offset(100, 140, 40) == -60
    assert program.clock_offset(100, 140, None) == 0


@pytest.mark.parametrize("offset", [0, 500])
def test_attach_puts_every_span_on_the_traces_clock(offset):
    # the host's clock runs ``offset`` behind the trace's; the harness moved
    # its spans by its marker shift (1,000 ns: the marker's device start
    # less the stamp before its launch), the program's are as recorded
    shift = 1_000
    dev, launched = _dev()
    run = _run(spans=False)
    before = 10_000
    state = {"drained": ([p._replace(start=p.start - offset, end=p.end - offset)
                          for p in PROGRAM], {"backend.h2d_copies": 6}),
             "marker": before + shift, "marker_ns": (before, before + 4),
             "marker_launch": before + 2 if offset == 0 else before + offset,
             "bench": [(n, s_ - offset + shift, e - offset + shift) for n, s_, e in BENCH],
             "dev": dev, "launch_ns": launched, "records": len(launched), "records_s": 0.0}
    program.attach(run, state, log=lambda *a: None)
    assert state["clock"]["offset_ns"] == offset
    assert run.program["bench"] == BENCH
    assert run.program["spans"] == PROGRAM
    want = program.attribute(dev, launched, BENCH, PROGRAM)
    assert run.trace["program"] == want
    assert want["decode_launches"] == [3, 3]
    assert run.trace["breakdown"]["idle_gaps"] == want["idle_gaps"]
    assert state["h2d_per_model_call"] == 3.0          # 6 copies over 2 model calls


def _run(spans=True):
    dev, launched = _dev()
    traced = trace.reduce(dev, BENCH, 300e-9)
    run = harness.Run(setup_s=1.0, window_s=300e-9, tokens_out=8, ttft_s=[0.1], itl_s=[0.2],
                      steps=[(196e-9, 120e-9, 32), (96e-9, 70e-9, 0)],
                      prefill_calls=[{"wall_s": 40e-9, "offset": 0, "tokens": 32,
                                      "table_width": 1}],
                      decode_calls=[{"wall_s": 80e-9, "rows": 4, "active": 4,
                                     "kv_lens": [40, 0, 0, 0], "table_width": 1},
                                    {"wall_s": 70e-9, "rows": 4, "active": 4,
                                     "kv_lens": [41, 0, 0, 0], "table_width": 1}],
                      counters={"steps": 2}, config=CONFIG, trace=traced, finished=[])
    if spans:
        run.trace = program.with_program(traced, program.attribute(dev, launched, BENCH, PROGRAM))
        run.program = {"spans": PROGRAM, "counters": {}, "bench": BENCH}
    return run


def test_each_new_reader():
    run = _run()
    read = {m: harness.metric_reader(m).read(run) for m in NEW}
    assert read["engine_self_ms"] == pytest.approx((76 + 26) / 2 / 1e6)
    # memplane.*, kv.*: 2 + 3 + 5 + 4 (step 1) and 1 (step 2) over 2 steps
    assert read["memplane_ms"] == pytest.approx((2 + 3 + 5 + 4 + 1) / 2 / 1e6)
    assert read["decode_host_ms"] == pytest.approx((78 - 16 + 68 - 17) / 2 / 1e6)
    assert read["decode_sync_ms"] == pytest.approx((16 + 17) / 2 / 1e6)
    assert read["decode_launches"] == 3.0
    # a program without spans, or an untraced run: nothing to read
    for m in NEW:
        assert harness.metric_reader(m).read(_run(spans=False)) is None


def test_existing_metrics_and_busy_read_the_same_with_program_spans():
    with_p, without = _run(), _run(spans=False)
    assert with_p.trace["busy_s"] == without.trace["busy_s"]
    assert with_p.trace["kernels"] == without.trace["kernels"]
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] not in NEW:
            reader = harness.metric_reader(m["name"])
            assert reader.read(with_p) == reader.read(without), m["name"]


def test_a_program_without_the_tracer_gives_none(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.tracing", None)
    assert program.program_tracer() is None


def test_a_traced_run_under_program_spans_carries_the_programs_spans():
    import time

    import torch

    from bench.tests import tiny
    from repro_torch.runtime.tracing import TRACER
    cell, cfg = tiny.cell("mamba2.chat")
    before = (harness.build, harness.run_cell, trace.device_events, trace.reduce,
              torch.cuda._sleep)
    with program.program_spans(log=lambda *a: None) as state:
        run, *_ = harness.run_cell(cell, 2 ** 31 + 9, 0.5, True, "cpu", time.perf_counter(),
                                   port_cfg=cfg, log=lambda *a: None)
    assert state["run"] is run
    assert (harness.build, harness.run_cell, trace.device_events, trace.reduce,
            torch.cuda._sleep) == before
    assert not TRACER.on and TRACER.drain() == ([], {})
    steps = [p for p in run.program["spans"] if p.name == "engine.step"]
    assert len(steps) == len(run.steps) > 0
    read = {m: harness.metric_reader(m).read(run) for m in NEW}
    assert read["decode_launches"] is None                 # no device on the CPU
    assert all(read[m] > 0 for m in NEW if m != "decode_launches")
    assert run.trace["program"]["launch_clock"] == "none"
    # no device activity: one gap, the window, under whichever span was open
    totals = [v for k, v in run.trace["breakdown"]["idle_gaps"] if k.endswith("(total)")]
    assert len(totals) == 1 and totals[0] == pytest.approx(run.window_s, rel=0.05)
