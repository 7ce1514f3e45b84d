"""The port's in-memory tracer (``repro_torch.runtime.tracing``) on the
reduced mamba2 engine the benchmark's CPU tests build (``bench/tests/tiny.py``):
spans nest, carry their request, cover the engine, memory plane, backend
and model at every step; off, a site records nothing, allocates nothing
and reads no clock; on or off, the engine serves the same tokens and
reports the same numbers. A reduced deepseek prefill shows each MoE
block's ``model.moe`` span inside its layer's."""
import pathlib
import sys
import tracemalloc

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402
from bench.tests import tiny  # noqa: E402
from repro_torch.runtime import tracing  # noqa: E402
from repro_torch.runtime.tracing import NOOP, TRACER  # noqa: E402

PROMPTS = [(7, 40, 5), (11, 21, 4), (13, 9, 6)]       # (seed, prompt length, new tokens)
ENGINE = {"engine.step", "engine.plan", "engine.prefill", "engine.session_table",
          "engine.decode", "engine.inject_faults", "engine.decode_tables",
          "engine.emit", "engine.finish"}
MEMPLANE = {"memplane.begin_step", "memplane.weight_pass", "memplane.meter_reads",
            "memplane.finish_step", "kv.append_tokens", "kv.maintain"}
BACKEND = {"backend.prefill_chunk", "backend.decode", "backend.inputs", "model.forward",
           "backend.sample_sync", "model.embed", "model.head", "model.ssm"}


@pytest.fixture(autouse=True)
def quiet_tracer():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    TRACER.disable()
    TRACER.drain()
    yield
    TRACER.disable()
    TRACER.drain()
    torch.set_num_threads(threads)


def _engine():
    cell, cfg = tiny.cell("mamba2.chat")
    eng, _, cfg, _ = harness.build(cell, 5, "cpu", cfg)
    for seed, n, new in PROMPTS:
        prompt = np.random.default_rng(seed).integers(1, cfg.vocab_size, n).tolist()
        eng.submit(prompt, max_new_tokens=new)
    return eng, cfg


def _serve(traced: bool):
    """(outputs, report, spans per step, counters) of the prompts served to
    the end."""
    eng, cfg = _engine()
    steps = []
    if traced:
        TRACER.enable()
    while not eng.sched.idle:
        eng.step()
        steps.append(TRACER.drain().spans if traced else [])
    TRACER.disable()
    return dict(eng.outputs), eng.report(), steps, cfg


def test_spans_nest_and_carry_their_request():
    _, _, steps, _ = _serve(True)
    spans = [s for step in steps for s in step]
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.name and s.start <= s.end
        if s.parent:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
        else:
            assert s.name == "engine.step", s
    chunks = [s for s in spans if s.name == "engine.prefill"]
    assert chunks
    for ck in chunks:
        inside = [s for s in spans if s.parent == ck.id]
        assert {s.name for s in inside} >= {"engine.session_table", "kv.append_tokens",
                                             "backend.prefill_chunk"}
        for s in inside:
            if s.name != "memplane.weight_pass":
                assert s.rid == ck.rid is not None, s
        assert ck.attrs["tokens"] > 0 and "offset" in ck.attrs


def test_every_step_is_covered_and_each_model_call_has_one_span_a_layer():
    _, _, steps, cfg = _serve(True)
    names = {s.name for step in steps for s in step}
    assert names == ENGINE | MEMPLANE | BACKEND
    for step in steps:
        top = [s for s in step if s.name == "engine.step"]
        assert len(top) == 1
        got = {s.name for s in step}
        assert got >= {"engine.plan", "memplane.begin_step", "memplane.finish_step",
                       "kv.maintain"}
        assert (top[0].attrs["chunks"] > 0) == ("engine.prefill" in got)
        assert (top[0].attrs["rows"] > 0) == ("backend.decode" in got)
        for call in (s for s in step if s.name == "model.forward"):
            layers = [s for s in step if s.name.startswith("model.")
                      and "layer" in s.attrs and s.parent == call.id]
            assert sorted(s.attrs["layer"] for s in layers) == list(range(cfg.num_layers))
            assert {s.name for s in layers} == {"model.ssm"}
    decode = [s for step in steps for s in step if s.name == "backend.decode"]
    assert all(s.attrs["rows"] > 0 for s in decode)


def test_off_records_nothing_reads_no_clock_and_makes_no_span(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a span site ran while tracing was off")
    monkeypatch.setattr(TRACER, "span", boom)
    monkeypatch.setattr(TRACER, "count", boom)
    monkeypatch.setattr(tracing, "time_ns", boom)
    outputs, _, steps, _ = _serve(False)
    assert outputs and steps
    monkeypatch.undo()
    assert TRACER.drain() == ([], {})


def test_an_off_site_allocates_nothing():
    def site(n):
        for i in range(n):
            with TRACER.span("model.ssm", layer=i) if TRACER.on else NOOP:
                pass

    def peak_growth(n):
        tracemalloc.start()
        try:
            tracemalloc.reset_peak()
            base = tracemalloc.get_traced_memory()[0]
            site(n)
            return tracemalloc.get_traced_memory()[1] - base
        finally:
            tracemalloc.stop()
    site(10)                                    # warm the loop's own objects
    # the loop's own counter and bookkeeping only: the same for 10 sites
    # as for 100,000
    assert peak_growth(100_000) - peak_growth(10) < 64


def test_tokens_and_report_are_the_same_on_and_off():
    out_off, rep_off, _, _ = _serve(False)
    out_on, rep_on, steps, _ = _serve(True)
    assert out_on == out_off
    assert rep_on == rep_off
    assert sum(len(s) for s in steps) > 0


def test_drain_empties_the_buffer():
    TRACER.enable()
    with TRACER.span("outer", 3, tokens=4):
        with TRACER.span("inner", rows=2):
            TRACER.count("backend.h2d_copies", 2)
    TRACER.disable()
    spans, counters = TRACER.drain()
    assert [s.name for s in spans] == ["outer", "inner"]      # in the order they start
    outer, inner = spans
    assert inner.parent == outer.id and outer.parent == 0
    assert (outer.rid, outer.attrs, inner.attrs) == (3, {"tokens": 4}, {"rows": 2})
    assert counters == {"backend.h2d_copies": 2}
    assert TRACER.drain() == ([], {})
    # a span still open at a drain is handed over by the drain after it closes
    TRACER.enable()
    with TRACER.span("open"):
        assert TRACER.drain() == ([], {})
    TRACER.disable()
    assert [s.name for s in TRACER.drain().spans] == ["open"]
    with TRACER.span("after") if TRACER.on else NOOP:
        pass
    assert TRACER.drain() == ([], {})


def test_a_moe_block_holds_one_moe_span_in_its_layers_span():
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as tfm
    cfg = reduced(get_config("deepseek-v2-lite-16b"), dtype="float32", param_dtype="float32")
    params = tfm.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(1, cfg.vocab_size, (1, 8), generator=torch.Generator().manual_seed(0))
    TRACER.enable()
    tfm.prefill(cfg, params, {"tokens": tokens}, page_tokens=8)
    TRACER.disable()
    spans = TRACER.drain().spans
    specs = [spec for g in cfg.scan_groups() for _ in range(g.repeats) for spec in g.unit]
    blocks = sorted((s for s in spans if "layer" in s.attrs), key=lambda s: s.attrs["layer"])
    assert [s.name for s in blocks] == [f"model.{spec.kind}" for spec in specs]
    moe_layers = [s.attrs["layer"] for s in blocks
                  for m in spans if m.name == "model.moe" and m.parent == s.id]
    assert moe_layers == [i for i, spec in enumerate(specs) if spec.mlp == "moe"]
    assert moe_layers and len(moe_layers) == sum(s.name == "model.moe" for s in spans)
