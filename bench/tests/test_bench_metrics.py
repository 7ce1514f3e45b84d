"""The metric arithmetic on synthetic records: the union of device
intervals, the window's edges, a p95 with ten samples beyond it, and the
frozen bound formulas against the originals in ``chip_smoke.py``."""
import types

import numpy as np
import pytest
import torch

from bench import harness, trace, work
from bench.metrics import _common


def test_busy_is_the_union_of_device_intervals_inside_the_window():
    spans = [("bench.step", 0, 100),                 # warm-up step: outside
             ("bench.step", 100, 200), ("bench.run_decode", 120, 190),
             ("bench.step", 200, 300)]
    dev = [("k_warm", 10, 90), ("k1", 110, 150), ("k2", 140, 160),   # k2 overlaps k1
           ("k4", 170, 175), ("k1", 250, 270), ("k3", 295, 320)]     # k3 cut at the end
    names, starts, ends = zip(*dev)
    r = trace.reduce((list(names), np.array(starts), np.array(ends)), spans, window_s=200e-9)
    assert r["busy_s"] == pytest.approx((50 + 5 + 20 + 5) * 1e-9)
    assert r["kernels"]["k1"] == [2, pytest.approx(60e-9)]
    assert "k_warm" not in r["kernels"]
    idle = dict(r["breakdown"]["idle_gaps"][:3])
    # gaps: 160-170 inside run_decode's span; 100-110, 175-250 (its midpoint
    # in the second step) and 270-295 in a step
    assert idle["idle in run_decode (total)"] == pytest.approx(10e-9)
    assert idle["idle in step (total)"] == pytest.approx(110e-9)


class _Ev:
    def __init__(self, name, dev, start, end, annotation=False):
        self._n, self._d, self._s, self._e, self._a = name, dev, start, end, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return self._a


def test_device_events_skip_host_annotations_and_find_the_marker():
    from torch.autograd import DeviceType
    events = [_Ev("aten::mul", DeviceType.CPU, 0, 5),
              _Ev("void at::native::(anonymous namespace)::spin_kernel(long)",
                  DeviceType.CUDA, 7, 8),
              _Ev("bench.step", DeviceType.CUDA, 10, 50, annotation=True),
              _Ev("k1", DeviceType.CUDA, 12, 20)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    (names, starts, ends), marker = trace.device_events(prof)
    assert (names, starts.tolist(), ends.tolist(), marker) == (["k1"], [12], [20], 7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_union_matches_a_plain_sweep(seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 10_000, 500)
    e = s + rng.integers(0, 300, 500)
    covered = np.zeros(10_400, bool)
    for a, b in zip(s, e):
        covered[a:b] = True
    assert trace.device_busy_s(s, e) == pytest.approx(covered.sum() / 1e9)


def test_p95_with_ten_samples_beyond_it():
    samples = [0.001 * i for i in range(1, 201)]      # 200 samples: 10 above p95
    p = _common.p95_ms(samples)
    assert sum(s * 1e3 > p for s in samples) == 10
    assert p == pytest.approx(np.percentile(samples, 95) * 1e3)
    assert _common.p95_ms([]) is None


def _run(**kw):
    base = dict(setup_s=50.0, window_s=10.0, tokens_out=1000, ttft_s=[0.5], itl_s=[0.2],
                steps=[(0.5, 0.4, 0), (0.7, 0.5, 100)], prefill_calls=[], decode_calls=[],
                counters={"prefill_tokens_skipped": 3900, "prefill_tokens_computed": 100,
                          "steps": 2}, config={}, trace=None, finished=[])
    base.update(kw)
    return harness.Run(**base)


def test_window_metrics():
    run = _run()
    assert harness.metric_reader("output_tok_s").read(run) == 100.0
    assert harness.metric_reader("setup_s").read(run) == 50.0
    assert harness.metric_reader("engine_host_ms").read(run) == pytest.approx(150.0)
    assert harness.metric_reader("device_idle_share").read(run) is None
    assert harness.metric_reader("itl_p95_ms.host").read(run) == pytest.approx(200.0)
    traced = _run(trace={"busy_s": 2.5, "kernels": {}, "breakdown": {}})
    assert harness.metric_reader("device_idle_share").read(traced) == pytest.approx(75.0)
    assert harness.metric_reader("ssd_scan_roofline").read(traced) is None


def test_paged_attention_bound_equals_chip_smoke():
    import chip_smoke
    ps, D, H = 32, 576, 16
    kv = [100, 0, 4097, 33]
    q_lens = [1, 1, 64, 1]
    table = torch.zeros((4, 256), dtype=torch.int32)
    for s, n in enumerate(kv):
        if s != 1:
            table[s, : -(-n // ps)] = torch.arange(1, -(-n // ps) + 1)
    cu = torch.tensor([0] + list(np.cumsum(q_lens)), dtype=torch.int32)
    q = torch.zeros((sum(q_lens), H, D), dtype=torch.bfloat16)
    pages = torch.zeros((200, ps, 2, D), dtype=torch.bfloat16)
    want = chip_smoke.work((q, pages, table, cu, torch.tensor(kv, dtype=torch.int32)),
                           "bfloat16")
    got = work.paged_attention_work(sum(q_lens), H, D, 2, 2, ps, 256, q_lens, kv,
                                    [k > 0 and s != 1 for s, k in enumerate(kv)])
    assert got == (want[0], want[1])


@pytest.mark.parametrize("S", [1, 37, 256])
def test_ssd_bound_equals_chip_smoke(S):
    import chip_smoke
    B, H, P, G, N = 1, 80, 64, 1, 128
    x = torch.zeros((B, S, H, P), dtype=torch.bfloat16)
    dt = torch.zeros((B, S, H))
    a = torch.zeros((H,))
    b = c = torch.zeros((B, S, G, N), dtype=torch.bfloat16)
    init = torch.zeros((B, H, P, N))
    want = chip_smoke.ssd_work((x, dt, a, b, c), init, "bfloat16")
    assert work.ssd_work(B, S, H, P, G, N, 2, True) == (want[0], want[1])
