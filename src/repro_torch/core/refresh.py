"""Cluster-level retention tracking + refresh scheduling (paper §4:
"the scheduler will need to track the data expiration times, and decide
whether to refresh it or move it to another tier based on the state of the
requests that depend on that data").

The tracker is deterministic and simulation-time-driven (the serving engine
advances time); policies are pluggable. Actions:

- REFRESH: rewrite in place (costs a write + wear) — live data
- MIGRATE: move to a colder tier — idle-but-retained data (e.g. paused session)
- DROP:    let soft state expire — recompute on demand (KV is soft state)
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import dcm
from repro_torch.core.memclass import MemTechnology


class Action(Enum):
    REFRESH = "refresh"
    MIGRATE = "migrate"
    DROP = "drop"


@dataclass
class TrackedRegion:
    region_id: int
    owner: str               # e.g. "weights", "session:42"
    tier: str
    n_blocks: int
    bytes: float
    written_at: float
    retention_s: float
    deadline: float
    live: bool = True
    idle_since: Optional[float] = None


@dataclass
class ScheduledAction:
    at: float
    action: Action
    region: TrackedRegion


class RetentionTracker:
    """Priority queue of retention deadlines over all tracked regions."""

    def __init__(self, margin: float = 2.0, idle_migrate_after_s: float = 300.0):
        self.margin = margin
        self.idle_migrate_after_s = idle_migrate_after_s
        self._regions: Dict[int, TrackedRegion] = {}
        self._heap: List[Tuple[float, int, int]] = []
        self._ids = itertools.count()
        self.stats = {"refresh": 0, "migrate": 0, "drop": 0,
                      "refresh_bytes": 0.0}

    def track(self, owner: str, tier: str, n_blocks: int, nbytes: float,
              now: float, retention_s: float) -> int:
        rid = next(self._ids)
        deadline = now + retention_s / self.margin
        region = TrackedRegion(rid, owner, tier, n_blocks, nbytes, now,
                               retention_s, deadline)
        self._regions[rid] = region
        heapq.heappush(self._heap, (deadline, rid, 0))
        return rid

    def touch(self, rid: int, now: float) -> None:
        """Mark a region as just-accessed (resets idleness)."""
        r = self._regions.get(rid)
        if r:
            r.idle_since = None

    def mark_idle(self, rid: int, now: float) -> None:
        r = self._regions.get(rid)
        if r and r.idle_since is None:
            r.idle_since = now

    def release(self, rid: int) -> Optional[TrackedRegion]:
        return self._regions.pop(rid, None)

    def get(self, rid: int) -> Optional[TrackedRegion]:
        """O(1) region lookup by id — the serving hot path (every KV page
        read) goes through this, never through `regions()`."""
        return self._regions.get(rid)

    def regions(self) -> List[TrackedRegion]:
        return list(self._regions.values())

    def due(self, now: float) -> List[TrackedRegion]:
        out = []
        while self._heap and self._heap[0][0] <= now:
            deadline, rid, gen = heapq.heappop(self._heap)
            r = self._regions.get(rid)
            if r is None or r.deadline != deadline:
                continue  # stale entry (released or re-armed)
            out.append(r)
        return out

    def rearm(self, r: TrackedRegion, now: float,
              retention_s: Optional[float] = None) -> None:
        r.written_at = now
        if retention_s is not None:
            r.retention_s = retention_s
        r.deadline = now + r.retention_s / self.margin
        heapq.heappush(self._heap, (r.deadline, r.region_id, 0))


PolicyFn = Callable[[TrackedRegion, float], Action]


def default_policy(tracker: RetentionTracker) -> PolicyFn:
    """Paper-default policy: refresh live data, migrate long-idle data,
    drop dead soft state (the engine releases dead regions eagerly, so DROP
    here is the backstop for orphaned state)."""
    def policy(region: TrackedRegion, now: float) -> Action:
        if not region.live:
            return Action.DROP
        if (region.idle_since is not None and
                now - region.idle_since > tracker.idle_migrate_after_s):
            return Action.MIGRATE
        return Action.REFRESH
    return policy


class RefreshScheduler:
    """Drives tracker deadlines into device refresh/migrate/drop work."""

    def __init__(self, tracker: RetentionTracker, policy: Optional[PolicyFn] = None):
        self.tracker = tracker
        self.policy = policy or default_policy(tracker)

    def tick(self, now: float) -> List[ScheduledAction]:
        """Process due regions; returns the actions taken (the memory
        simulator charges their cost)."""
        actions = []
        for region in self.tracker.due(now):
            act = self.policy(region, now)
            actions.append(ScheduledAction(at=now, action=act, region=region))
            if act == Action.REFRESH:
                self.tracker.stats["refresh"] += 1
                self.tracker.stats["refresh_bytes"] += region.bytes
                self.tracker.rearm(region, now)
            elif act == Action.MIGRATE:
                self.tracker.stats["migrate"] += 1
                self.tracker.release(region.region_id)
            else:
                self.tracker.stats["drop"] += 1
                self.tracker.release(region.region_id)
        return actions
