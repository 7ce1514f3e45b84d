"""The port's fleet plane (``repro_torch.serving.{events,fabric,directory,
fleet_sim}``) against the JAX package's, which are pure Python on both
sides:

- every scenario of ``experiments/scenarios.py`` at preset ``smoke``,
  built once and fed to the reference's ``FleetSim`` and the port's
  (configs and requests converted through ``dataclasses.asdict``): the
  same report, the same trace digest, and ``check()`` passes on both;
- the event-queue, trace and fabric unit properties of
  ``tests/test_fleet_events.py`` and ``tests/test_fabric.py`` on the
  port's classes, each case also reproducing the reference's numbers.

Every comparison is exact: the simulator is float arithmetic in one
order on both sides.
"""
import dataclasses
import random
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import repro.serving.events as jax_events
import repro.serving.fabric as jax_fabric
import repro.serving.fleet_sim as jax_fleet_sim
import repro_torch.serving.events as torch_events
import repro_torch.serving.fabric as torch_fabric
import repro_torch.serving.fleet_sim as torch_fleet_sim
from experiments.scenarios import SCENARIOS, build

GB = 1e9


class _Recorder:
    """Stands in for a FleetSim while a scenario submits: keeps every
    ``submit`` and ``chain`` call in order, to replay into both sims."""

    def __init__(self):
        self.ops = []

    def submit(self, req):
        self.ops.append(("submit", req))

    def chain(self, key, req, gap):
        self.ops.append(("chain", key, req, gap))


def _replay(mod, fleet_cfg, ops):
    sim = mod.FleetSim(mod.FleetConfig(**dataclasses.asdict(fleet_cfg)))

    def conv(r):
        return mod.FleetRequest(**dataclasses.asdict(r))

    for op in ops:
        if op[0] == "submit":
            sim.submit(conv(op[1]))
        else:
            sim.chain(op[1], conv(op[2]), op[3])
    report = sim.run(max_events=20_000_000)
    sim.check()
    return report


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_sim_smoke_scenario_equals_reference(name):
    sc = build(name, "smoke")
    rec = _Recorder()
    sc.submit_all(rec, random.Random(sc.seed))
    assert rec.ops
    ref = _replay(jax_fleet_sim, sc.fleet(), rec.ops)
    got = _replay(torch_fleet_sim, sc.fleet(), rec.ops)
    assert got["trace"]["digest"] == ref["trace"]["digest"]
    assert got["trace"]["n_events"] == ref["trace"]["n_events"] > 0
    assert got == ref
    assert got["quiesced"]


def test_fleet_sim_latency_slo_equals_reference():
    rng = random.Random(3)
    xs = [{"ttft": rng.expovariate(1.0), "itl": rng.expovariate(4.0)}
          for _ in range(101)]
    assert torch_fleet_sim.latency_slo(xs) == jax_fleet_sim.latency_slo(xs)
    assert torch_fleet_sim.latency_slo([]) == jax_fleet_sim.latency_slo([])


# ---------------------------------------------------------------------------
# event queue / trace and fabric properties, each run on both packages
# ---------------------------------------------------------------------------


def _pop_order(m):
    rng = random.Random(7)
    events = [m.Event(time=rng.choice([0.0, 1.0, 1.0, 2.5]),
                      kind=rng.choice(list(m.EventKind)),
                      replica=rng.randrange(4), key=rng.randrange(8), info=(i,))
              for i in range(200)]
    orders = []
    for shuffle_seed in range(5):
        shuffled = list(events)
        random.Random(shuffle_seed).shuffle(shuffled)
        q = m.EventQueue()
        for ev in shuffled:
            q.push(ev)
        order = [ev.sort_key for ev in q.drain()]
        assert order == sorted(order)
        orders.append(order)
    assert all(o == orders[0] for o in orders)
    return [(t, int(k), r, key) for t, k, r, key, *_ in orders[0]]


def _rejects_past(m):
    q = m.EventQueue()
    q.push(m.Event(5.0, m.EventKind.ARRIVAL, 0))
    q.pop()
    assert q.last_time == 5.0
    with pytest.raises(ValueError, match="past"):
        q.push(m.Event(4.0, m.EventKind.STEP, 0))
    return q.last_time


def _trace_digest(m):
    a, b = m.EventTrace(), m.EventTrace()
    ev = m.Event(1.0, m.EventKind.ARRIVAL, 0, key=3, info=("x",))
    a.add(ev)
    b.add(ev)
    assert a.digest() == b.digest()
    b.add(m.Event(1.0, m.EventKind.ARRIVAL, 0, key=4))
    assert a.digest() != b.digest() and b.n_events == 2
    return a.digest(), b.digest()


def _up_link(m):
    fab = m.Fabric(4, link_gbps=100.0, bisection_gbps=400.0)
    s0, d0 = fab.reserve(0, 1, int(100 * GB), 0.0)
    s1, d1 = fab.reserve(0, 2, int(100 * GB), 0.0)
    assert (s0, d0) == (0.0, pytest.approx(1.0))
    assert s1 == pytest.approx(d0) and d1 == pytest.approx(2.0)
    assert fab.queue_wait_s == pytest.approx(1.0)
    return s0, d0, s1, d1, fab.queue_wait_s


def _down_link(m):
    fab = m.Fabric(4, link_gbps=100.0, bisection_gbps=400.0)
    _, d0 = fab.reserve(1, 0, int(50 * GB), 0.0)
    s1, d1 = fab.reserve(2, 0, int(50 * GB), 0.0)
    assert s1 == pytest.approx(d0)
    return d0, s1, d1


def _bisection(m):
    fab = m.Fabric(8, link_gbps=100.0, bisection_gbps=200.0)
    assert fab.n_channels == 2
    _, d0 = fab.reserve(0, 1, int(100 * GB), 0.0)
    s1, _ = fab.reserve(2, 3, int(100 * GB), 0.0)
    s2, _ = fab.reserve(4, 5, int(100 * GB), 0.0)
    assert s1 == 0.0 and s2 == pytest.approx(d0)
    return d0, s1, s2


def _free_at_and_hot(m):
    fab = m.Fabric(4, link_gbps=100.0, bisection_gbps=400.0)
    assert not fab.hot(0, 1, 0.0)
    _, done = fab.reserve(0, 1, int(100 * GB), 0.0)
    assert fab.hot(0, 1, 0.5) and fab.hot(0, 2, 0.5) and fab.hot(2, 1, 0.5)
    assert not fab.hot(2, 3, 0.5)
    assert fab.free_at(0, 2, 0.5) == pytest.approx(done)
    assert not fab.hot(0, 1, done)
    return done, fab.free_at(0, 2, 0.5)


def _half_bisection(m):
    fab = m.Fabric(8, link_gbps=100.0)
    assert fab.bisection_gbps == pytest.approx(400.0) and fab.n_channels == 4
    with pytest.raises(ValueError, match="below a single link"):
        m.Fabric(4, link_gbps=100.0, bisection_gbps=50.0)
    with pytest.raises(ValueError, match="positive"):
        m.Fabric(4, link_gbps=0.0)
    return fab.bisection_gbps, fab.n_channels


def _ledgers(m):
    fab = m.Fabric(4, link_gbps=100.0)
    fab.reserve(0, 1, int(10 * GB), 0.0)
    fab.reserve(0, 2, int(30 * GB), 0.0)
    rep = fab.report()
    assert rep["transfers"] == 2 and rep["bytes"] == int(40 * GB)
    assert rep["up_bytes"] == {0: int(40 * GB)}
    assert rep["down_bytes"] == {1: int(10 * GB), 2: int(30 * GB)}
    assert rep["busy_s"] == pytest.approx(0.4)
    return rep


def _demand_preempts_push(m):
    fab = m.Fabric(4, link_gbps=100.0, bisection_gbps=100.0)   # one channel
    fab.reserve(0, 1, int(100 * GB), 0.0)
    assert fab.hot(2, 3, 0.5)
    retry_at = fab.free_at(2, 3, 0.5)
    assert retry_at == pytest.approx(1.0)
    s, d = fab.reserve(2, 3, int(100 * GB), 0.8)
    assert s == pytest.approx(1.0) and d == pytest.approx(2.0)
    assert fab.hot(2, 3, retry_at)
    assert fab.free_at(2, 3, retry_at) == pytest.approx(d)
    return retry_at, s, d


def _push_lowest_priority(m):
    assert m.EventKind.REPLICATION_PUSH == max(m.EventKind)
    assert m.EventKind.REPLICATION_PUSH > m.EventKind.MIGRATION_DELIVERY
    return [(k.name, int(k)) for k in m.EventKind]


PROPERTIES = {
    "event_queue_pop_order_is_content_derived": _pop_order,
    "event_queue_rejects_scheduling_in_the_past": _rejects_past,
    "trace_digest_reflects_event_content": _trace_digest,
    "up_link_serializes_concurrent_exports": _up_link,
    "down_link_serializes_concurrent_imports": _down_link,
    "bisection_core_caps_disjoint_pairs": _bisection,
    "free_at_and_hot_track_the_full_path": _free_at_and_hot,
    "half_bisection_default_and_validation": _half_bisection,
    "ledgers_meter_every_byte_once": _ledgers,
    "demand_migration_preempts_queued_speculative_push": _demand_preempts_push,
    "replication_push_is_lowest_priority_event_kind": _push_lowest_priority,
}


class _Ns:
    def __init__(self, *mods):
        for mod in mods:
            for k in dir(mod):
                if not k.startswith("_"):
                    setattr(self, k, getattr(mod, k))


@pytest.mark.parametrize("prop", sorted(PROPERTIES))
def test_fleet_unit_property_holds_and_equals_reference(prop):
    fn = PROPERTIES[prop]
    got = fn(_Ns(torch_events, torch_fabric))
    ref = fn(_Ns(jax_events, jax_fabric))
    assert got == ref
