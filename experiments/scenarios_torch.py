"""Scenario zoo for the event-driven fleet simulator (DESIGN.md §12), over
the PyTorch port's ``FleetSim`` (a copy of ``experiments/scenarios.py``,
which builds the JAX package's configs and requests).

Each scenario family is a config dataclass with a ``generate(rng)``
method yielding symbolic :class:`~repro_torch.serving.fleet_sim.FleetRequest`
streams, plus a ``fleet()`` method building the matching
:class:`~repro_torch.serving.fleet_sim.FleetConfig`. The scenario owns ALL
randomness (one seeded ``random.Random``); the simulator itself is
deterministic, so ``(scenario, seed)`` fixes the full event trace — the
contract the determinism harness and the CI trace-hash gate rely on.

The families map to the traffic structures the paper argues MRM can
exploit (PAPER.md §4, "Towards Memory Specialization" in PAPERS.md):

- **bursty** — open-loop Poisson arrivals with burst multipliers: reuse
  windows under load spikes. The ``scale`` preset is the acceptance run
  (≥ 64 replicas, ≥ 100k queued sessions to quiescence).
- **diurnal** — multi-tenant sinusoidal rate over simulated hours; the
  lull is where retention decay either saves energy or evicts tomorrow's
  prefixes.
- **agentic** — tool-call loops re-entering with *grown* prefixes: the
  registered group extends page by page, the re-entry always hits.
- **rag_storm** — fan-out bursts over one fresh document context:
  directory registration races, migration storms, link serialization.
- **long_doc** — few sessions, huge shared contexts: capacity pressure,
  evict/spill/recompute chain, cold-tier reads in the decode path.
- **abandonment** — offered load beyond fleet capacity with impatient
  users: queued sessions time out and must never leak state.

``SCENARIOS`` maps family name -> config class; every class has
``presets()`` with at least ``smoke`` (CI-feasible) and ``default``.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, replace
from typing import Dict, Iterator

from repro_torch.serving.fleet_sim import FleetConfig, FleetRequest


@dataclass(frozen=True)
class ScenarioBase:
    n_replicas: int = 8
    slots_per_replica: int = 16
    sessions: int = 5_000
    seed: int = 0

    def fleet(self) -> FleetConfig:
        return FleetConfig(n_replicas=self.n_replicas,
                           slots_per_replica=self.slots_per_replica)

    def generate(self, rng: random.Random) -> Iterator[FleetRequest]:
        raise NotImplementedError

    def submit_all(self, sim, rng: random.Random) -> None:
        """Feed the scenario into a :class:`FleetSim`. The default is
        open-loop: every arrival is pre-scheduled by ``generate``.
        Closed-loop families override this to chain follow-ups off
        completion times (``FleetSim.chain``) — the RNG draw order must
        stay independent of execution order (pre-draw all think times)
        so the trace-digest determinism contract holds."""
        for req in self.generate(rng):
            sim.submit(req)

    @classmethod
    def presets(cls) -> Dict[str, "ScenarioBase"]:
        raise NotImplementedError


@dataclass(frozen=True)
class Bursty(ScenarioBase):
    """Open-loop Poisson arrivals with square-wave burst multipliers."""
    rate_per_s: float = 2000.0
    burst_multiplier: float = 4.0
    burst_every_s: float = 5.0
    burst_len_s: float = 1.0
    groups: int = 200
    shared_tokens: int = 512
    unique_tokens: int = 64
    max_new_tokens: int = 8
    abandon_after_s: float = 120.0

    def generate(self, rng: random.Random) -> Iterator[FleetRequest]:
        t = 0.0
        for i in range(self.sessions):
            in_burst = (t % self.burst_every_s) < self.burst_len_s
            rate = self.rate_per_s * (self.burst_multiplier if in_burst
                                      else 1.0)
            t += rng.expovariate(rate)
            yield FleetRequest(
                session_key=i, group=rng.randrange(self.groups),
                shared_tokens=self.shared_tokens,
                unique_tokens=self.unique_tokens,
                max_new_tokens=self.max_new_tokens, arrival_s=t,
                abandon_after_s=self.abandon_after_s)

    @classmethod
    def presets(cls) -> Dict[str, "Bursty"]:
        smoke = cls(n_replicas=8, sessions=4_000, rate_per_s=1500.0)
        return {
            "smoke": smoke,
            "default": cls(n_replicas=16, sessions=50_000,
                           rate_per_s=4000.0, groups=400),
            # the acceptance run: >= 64 replicas, >= 100k queued sessions
            "scale": cls(n_replicas=64, slots_per_replica=32,
                         sessions=100_000, rate_per_s=20_000.0, groups=800),
        }


@dataclass(frozen=True)
class Diurnal(ScenarioBase):
    """Multi-tenant sinusoidal arrival rate over simulated hours: tenants
    share prefix pools; the trough spans the retention window, so decayed
    prefixes must be recomputed at the next peak."""
    peak_rate_per_s: float = 800.0
    trough_frac: float = 0.1
    period_s: float = 600.0         # compressed "day"
    tenants: int = 8
    groups_per_tenant: int = 25
    shared_tokens: int = 512
    unique_tokens: int = 96
    max_new_tokens: int = 8

    def fleet(self) -> FleetConfig:
        # a cold TTL shorter than the trough: the lull decays idle tenants
        return replace(super().fleet(), cold_ttl_s=self.period_s / 4)

    def generate(self, rng: random.Random) -> Iterator[FleetRequest]:
        t = 0.0
        for i in range(self.sessions):
            phase = 0.5 * (1 - math.cos(2 * math.pi * t / self.period_s))
            rate = self.peak_rate_per_s * (
                self.trough_frac + (1 - self.trough_frac) * phase)
            t += rng.expovariate(max(rate, 1e-6))
            tenant = rng.randrange(self.tenants)
            yield FleetRequest(
                session_key=i,
                group=tenant * self.groups_per_tenant
                + rng.randrange(self.groups_per_tenant),
                shared_tokens=self.shared_tokens,
                unique_tokens=self.unique_tokens,
                max_new_tokens=self.max_new_tokens, arrival_s=t,
                tenant=f"tenant{tenant}")

    @classmethod
    def presets(cls) -> Dict[str, "Diurnal"]:
        return {
            "smoke": cls(n_replicas=8, sessions=4_000, period_s=120.0,
                         peak_rate_per_s=600.0),
            "default": cls(n_replicas=16, sessions=40_000),
        }


@dataclass(frozen=True)
class Agentic(ScenarioBase):
    """Tool-call loops: each agent re-enters ``calls_per_agent`` times,
    its scratchpad prefix growing by ``growth_tokens`` per round — the
    registered prefix group extends, so every re-entry is a longest-match
    hit on pages the agent itself registered.

    ``closed_loop`` (the default) makes the loop real: call *k+1*
    arrives one think-time after call *k* **completes**
    (``FleetSim.chain``), so achieved latency shapes the arrival process
    — a slow fleet sees agents back off, a fast one sees them hammer.
    Think times are pre-drawn in generation order, so the RNG stream
    never depends on completion order and the trace digest stays
    bit-stable. ``closed_loop=False`` recovers the original open-loop
    pre-scheduled arrivals."""
    agents: int = 400
    calls_per_agent: int = 8
    base_shared_tokens: int = 256
    growth_tokens: int = 128
    think_time_s: float = 2.0
    unique_tokens: int = 32
    max_new_tokens: int = 16
    closed_loop: bool = True

    def fleet(self) -> FleetConfig:
        # sticky loops: don't migrate a scratchpad around the fleet
        return replace(super().fleet(), migrate_load_gap=16)

    def _agent_calls(self, rng: random.Random, agent: int, sid0: int):
        """One agent's call sequence with pre-drawn gaps — the exact RNG
        consumption of the original open-loop generator (uniform start, one
        expovariate per call), so both loop modes share a seed stream."""
        t = rng.uniform(0.0, 10.0)
        calls, gaps = [], []
        for call in range(self.calls_per_agent):
            calls.append(FleetRequest(
                session_key=sid0 + call, group=agent,
                shared_tokens=self.base_shared_tokens
                + call * self.growth_tokens,
                unique_tokens=self.unique_tokens,
                max_new_tokens=self.max_new_tokens, arrival_s=t))
            gap = rng.expovariate(1.0 / self.think_time_s)
            gaps.append(gap)
            t += gap
        return calls, gaps

    def generate(self, rng: random.Random) -> Iterator[FleetRequest]:
        for a in range(self.agents):
            calls, _ = self._agent_calls(rng, a, a * self.calls_per_agent)
            yield from calls

    def submit_all(self, sim, rng: random.Random) -> None:
        if not self.closed_loop:
            super().submit_all(sim, rng)
            return
        for a in range(self.agents):
            calls, gaps = self._agent_calls(rng, a,
                                            a * self.calls_per_agent)
            sim.submit(calls[0])
            for k in range(1, len(calls)):
                sim.chain(calls[k - 1].session_key, calls[k], gaps[k - 1])

    @property
    def sessions_total(self) -> int:
        return self.agents * self.calls_per_agent

    @classmethod
    def presets(cls) -> Dict[str, "Agentic"]:
        return {
            "smoke": cls(n_replicas=8, agents=300, calls_per_agent=6),
            "default": cls(n_replicas=16, agents=2_000, calls_per_agent=10),
        }


@dataclass(frozen=True)
class RagStorm(ScenarioBase):
    """RAG fan-out: every storm shares one *fresh* document group. The
    document's first ``heralds`` queries trickle in (the leading edge a
    trending document always has), then ``fanout`` near-simultaneous
    requests land ``lead_s`` later — the reactive plane answers the burst
    with a pile-up on the one registered owner plus demand-migration
    bursts that serialize on the donor's up-link; the predictive plane
    (DESIGN §13) sees the herald hits cross the replication threshold and
    pre-places the document on warm owners before the burst arrives."""
    storms: int = 120
    fanout: int = 32
    heralds: int = 2
    herald_gap_s: float = 0.15
    lead_s: float = 0.4
    storm_gap_s: float = 0.5
    doc_tokens: int = 1024
    unique_tokens: int = 48
    max_new_tokens: int = 8

    def generate(self, rng: random.Random) -> Iterator[FleetRequest]:
        sid = 0
        t = 0.0
        for storm in range(self.storms):
            t += rng.expovariate(1.0 / self.storm_gap_s)
            for h in range(self.heralds):
                yield FleetRequest(
                    session_key=sid, group=storm,
                    shared_tokens=self.doc_tokens,
                    unique_tokens=self.unique_tokens,
                    max_new_tokens=self.max_new_tokens,
                    arrival_s=t + h * self.herald_gap_s)
                sid += 1
            burst = t + (self.heralds - 1) * self.herald_gap_s + self.lead_s
            for _ in range(self.fanout):
                yield FleetRequest(
                    session_key=sid, group=storm,
                    shared_tokens=self.doc_tokens,
                    unique_tokens=self.unique_tokens,
                    max_new_tokens=self.max_new_tokens,
                    arrival_s=burst + rng.uniform(0.0, 0.05))
                sid += 1

    @classmethod
    def presets(cls) -> Dict[str, "RagStorm"]:
        return {
            "smoke": cls(n_replicas=8, storms=60, fanout=24),
            "default": cls(n_replicas=16, storms=400, fanout=64),
        }


@dataclass(frozen=True)
class LongDoc(ScenarioBase):
    """Few sessions, huge shared contexts: registration overflows the
    warm tier, driving the evict -> spill-to-cold -> recompute pressure
    chain; matched cold groups read at cold-tier bandwidth in decode."""
    docs: int = 24
    readers_per_doc: int = 6
    doc_tokens: int = 32_768
    unique_tokens: int = 128
    max_new_tokens: int = 16
    reader_gap_s: float = 3.0

    def fleet(self) -> FleetConfig:
        # warm tier sized to hold only a fraction of the document set
        doc_bytes = self.doc_tokens * 131072
        return replace(super().fleet(),
                       warm_capacity_bytes=float(doc_bytes * self.docs // 3),
                       cold_capacity_bytes=float(doc_bytes * self.docs),
                       hot_capacity_bytes=192e9)

    def generate(self, rng: random.Random) -> Iterator[FleetRequest]:
        sid = 0
        for doc in range(self.docs):
            t = rng.uniform(0.0, 5.0)
            for _ in range(self.readers_per_doc):
                yield FleetRequest(
                    session_key=sid, group=doc,
                    shared_tokens=self.doc_tokens,
                    unique_tokens=self.unique_tokens,
                    max_new_tokens=self.max_new_tokens, arrival_s=t)
                sid += 1
                t += rng.expovariate(1.0 / self.reader_gap_s)

    @classmethod
    def presets(cls) -> Dict[str, "LongDoc"]:
        return {
            "smoke": cls(n_replicas=4, docs=12, readers_per_doc=4,
                         doc_tokens=16_384),
            "default": cls(n_replicas=8, docs=48, readers_per_doc=8),
        }


@dataclass(frozen=True)
class Abandonment(ScenarioBase):
    """Offered load beyond fleet capacity with impatient users: a large
    fraction of queued sessions times out before first token. The gate is
    structural — abandoned sessions leave zero pins, zero hot bytes, and
    the fleet still quiesces."""
    rate_per_s: float = 4000.0
    abandon_after_s: float = 0.5
    groups: int = 100
    shared_tokens: int = 512
    unique_tokens: int = 64
    max_new_tokens: int = 8

    def fleet(self) -> FleetConfig:
        return replace(super().fleet(), n_replicas=max(2, self.n_replicas))

    def generate(self, rng: random.Random) -> Iterator[FleetRequest]:
        t = 0.0
        for i in range(self.sessions):
            t += rng.expovariate(self.rate_per_s)
            yield FleetRequest(
                session_key=i, group=rng.randrange(self.groups),
                shared_tokens=self.shared_tokens,
                unique_tokens=self.unique_tokens,
                max_new_tokens=self.max_new_tokens, arrival_s=t,
                abandon_after_s=self.abandon_after_s)

    @classmethod
    def presets(cls) -> Dict[str, "Abandonment"]:
        return {
            "smoke": cls(n_replicas=4, sessions=4_000, rate_per_s=3000.0),
            "default": cls(n_replicas=8, sessions=40_000),
        }


SCENARIOS: Dict[str, type] = {
    "bursty": Bursty,
    "diurnal": Diurnal,
    "agentic": Agentic,
    "rag_storm": RagStorm,
    "long_doc": LongDoc,
    "abandonment": Abandonment,
}


def build(name: str, preset: str = "smoke") -> ScenarioBase:
    """Resolve ``(family, preset)`` to a scenario config."""
    try:
        cls = SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"choose from {sorted(SCENARIOS)}") from None
    presets = cls.presets()
    try:
        return presets[preset]
    except KeyError:
        raise ValueError(f"scenario {name!r} has no preset {preset!r}; "
                         f"choose from {sorted(presets)}") from None
