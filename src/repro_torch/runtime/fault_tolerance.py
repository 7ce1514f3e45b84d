"""Fault tolerance for 1000+-node operation: failure detection, elastic
re-mesh planning, and straggler mitigation.

All components are deterministic and simulation-time-driven so they are unit-
testable on this CPU container; the same logic drives a real deployment with
wall-clock timestamps (heartbeats come from the per-host agent; re-mesh
plans feed the launcher which restarts the jit program on the new mesh and
restores the latest checkpoint with resharding — see repro.ckpt).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Failure detection
# ---------------------------------------------------------------------------


class HeartbeatMonitor:
    def __init__(self, workers: Sequence[str], timeout_s: float = 30.0):
        self.timeout = timeout_s
        self.last: Dict[str, float] = {w: 0.0 for w in workers}

    def beat(self, worker: str, now: float) -> None:
        self.last[worker] = now

    def failed(self, now: float) -> List[str]:
        return sorted(w for w, t in self.last.items() if now - t > self.timeout)

    def alive(self, now: float) -> List[str]:
        return sorted(w for w, t in self.last.items() if now - t <= self.timeout)


# ---------------------------------------------------------------------------
# Elastic re-mesh planning
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    n_chips: int
    dropped_chips: int
    notes: str = ""


def plan_mesh(available_chips: int, *, model_parallel: int = 16,
              chips_per_host: int = 4, multi_pod_threshold: int = 512) -> MeshPlan:
    """Largest usable (data, model) mesh from the surviving chips.

    Policy: keep the model axis fixed at the sharding-rule size (16) when
    possible (no resharding of the TP dimension => restore is a pure DP
    re-layout); shrink the data axis to the largest fit; drop the remainder
    (they become hot spares). Falls back to smaller model axes (8, 4, 2, 1)
    when fewer than one TP group survives.
    """
    for mp in [model_parallel, 8, 4, 2, 1]:
        if available_chips >= mp:
            data = available_chips // mp
            used = data * mp
            if used >= multi_pod_threshold and data % 2 == 0:
                return MeshPlan((2, data // 2, mp), ("pod", "data", "model"),
                                used, available_chips - used,
                                f"multi-pod: model axis {mp}")
            return MeshPlan((data, mp), ("data", "model"), used,
                            available_chips - used, f"model axis {mp}")
    return MeshPlan((1, 1), ("data", "model"), 1, available_chips - 1,
                    "degenerate single chip")


def resharding_moves(old: MeshPlan, new: MeshPlan,
                     param_bytes: float) -> dict:
    """Estimate the data movement for an elastic transition. With the model
    axis preserved, each surviving chip keeps its TP shard and only the
    optimizer-state DP partitioning changes; otherwise all params reload
    from the checkpoint."""
    old_mp = old.shape[-1]
    new_mp = new.shape[-1]
    if old_mp == new_mp:
        return {"kind": "dp_relayout", "bytes_moved": 0.0,
                "ckpt_reload": False}
    return {"kind": "tp_reshard", "bytes_moved": param_bytes,
            "ckpt_reload": True}


# ---------------------------------------------------------------------------
# Straggler mitigation
# ---------------------------------------------------------------------------


@dataclass
class StragglerPolicy:
    ewma_alpha: float = 0.2
    slow_factor: float = 1.8      # flag if > factor x median
    strikes_to_evict: int = 3


class StragglerMitigator:
    """Per-worker EWMA step times; flags persistent stragglers for eviction
    (at which point the elastic planner produces a new mesh without them)."""

    def __init__(self, workers: Sequence[str],
                 policy: Optional[StragglerPolicy] = None):
        self.policy = policy or StragglerPolicy()
        self.ewma: Dict[str, float] = {w: 0.0 for w in workers}
        self.strikes: Dict[str, int] = {w: 0 for w in workers}

    def record_step(self, times: Dict[str, float]) -> List[str]:
        """Record one step's per-worker durations; returns workers to evict."""
        a = self.policy.ewma_alpha
        for w, t in times.items():
            self.ewma[w] = t if self.ewma[w] == 0.0 else (1 - a) * self.ewma[w] + a * t
        vals = sorted(self.ewma[w] for w in self.ewma if self.ewma[w] > 0)
        if not vals:
            return []
        median = vals[len(vals) // 2]
        evict = []
        for w, e in self.ewma.items():
            if e > self.policy.slow_factor * median:
                self.strikes[w] += 1
                if self.strikes[w] >= self.policy.strikes_to_evict:
                    evict.append(w)
            else:
                self.strikes[w] = 0
        return sorted(evict)


# ---------------------------------------------------------------------------
# Orchestration state machine (drives train.py's recovery loop)
# ---------------------------------------------------------------------------


@dataclass
class ClusterState:
    workers: List[str]
    chips_per_worker: int
    monitor: HeartbeatMonitor = field(init=False)
    stragglers: StragglerMitigator = field(init=False)
    evicted: List[str] = field(default_factory=list)
    _last_healthy: int = field(init=False, default=-1)

    def __post_init__(self):
        self.monitor = HeartbeatMonitor(self.workers)
        self.stragglers = StragglerMitigator(self.workers)
        self._last_healthy = len(self.workers)

    def healthy_workers(self, now: float) -> List[str]:
        failed = set(self.monitor.failed(now)) | set(self.evicted)
        return [w for w in self.workers if w not in failed]

    def current_plan(self, now: float, **kw) -> MeshPlan:
        return plan_mesh(len(self.healthy_workers(now)) * self.chips_per_worker,
                         **kw)

    def handle_step(self, now: float, step_times: Dict[str, float]) -> Optional[MeshPlan]:
        """Returns a new MeshPlan when the cluster shape changed since the
        last step (heartbeat failures, external evictions, or stragglers)."""
        for w in self.stragglers.record_step(step_times):
            if w not in self.evicted:
                self.evicted.append(w)
        healthy = len(self.healthy_workers(now))
        if healthy != self._last_healthy:
            self._last_healthy = healthy
            return self.current_plan(now)
        return None
