"""Typed events, a deterministic priority queue, and a hashed event trace
— the spine of the event-driven fleet simulator (DESIGN.md §12).

The paper's §4 bet is that retention can be *managed* because inference
traffic has structure: reuse bursts, diurnal lulls, abandonment. Seeing
that structure in simulation requires retention decay, refresh scheduling
and migration queuing to meet realistic *timescales* — which the lockstep
shared-clock rounds of ``ClusterFrontend.step()`` compress away (every
replica advances to the fleet max each round). This module provides the
event plumbing both fleet simulations share:

- :class:`EventKind` — the closed set of typed events: request arrival,
  prefill chunk completion, decode round, cross-replica migration
  delivery, wall-clock retention decay / scrub-due, abandonment timeout,
  and the generic replica step the real-engine cluster schedules.
- :class:`EventQueue` — a binary heap whose ordering is **fully
  content-derived**: events sort by ``(time, kind, replica, key)`` where
  ``key`` is caller-supplied identity (session id, migration id, ...),
  never queue insertion order. Two simulations that schedule the same
  events in a different order therefore pop them in the same order —
  the determinism harness asserts trace-hash equality across tie-break
  insertion shuffles.
- :class:`EventTrace` — an incrementally-hashed record of every event
  processed. ``digest()`` is a sha1 over the canonical event tuples, so
  two runs are *bit-identical* iff their digests match; with
  ``record=True`` the concrete tuples are kept for debugging. The hash
  accumulates in O(1) memory, so million-event scenario runs stay cheap.
- :class:`NonQuiescentError` — raised when a ``run_until_idle`` /
  scenario run hits its step or event budget with work still pending
  (non-quiescence is an explicit error or a flagged report field, never
  a *silent* return at ``max_steps``).
"""
from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Iterator, List, Optional, Tuple


class NonQuiescentError(RuntimeError):
    """A simulation run exhausted its step/event budget with requests
    still queued or resident. Carries the partial report so callers that
    *expect* truncation (``on_stall="report"``) can still inspect it."""

    def __init__(self, msg: str, report: Optional[dict] = None):
        super().__init__(msg)
        self.report = report


class EventKind(IntEnum):
    """Typed fleet events. The integer value is the tie-break priority at
    equal timestamps (lower fires first): deliveries land before the
    arrivals that might use them; arrivals enter queues before the step
    that could admit them; decay and abandonment sweep *after* compute at
    the same instant (a request finishing exactly at its abandonment
    deadline finishes)."""
    MIGRATION_DELIVERY = 0
    ARRIVAL = 1
    STEP = 2            # real-engine cluster: one ServeEngine.step() due
    CHUNK_COMPLETE = 3  # analytic replica: a prefill chunk finished
    DECODE_ROUND = 4    # analytic replica: one batched decode round
    RETENTION_DECAY = 5  # wall-clock cold-leaf decay sweep
    ABANDON = 6         # abandonment timeout check for one session
    SCRUB_DUE = 7       # periodic retention-plane scrub read (DESIGN §11)
    REPLICATION_PUSH = 8  # speculative prefix push decision (DESIGN §13);
    #                       lowest priority: at an equal timestamp every
    #                       demand-side event (arrivals, their migrations)
    #                       fires first, so pushes see — and yield to —
    #                       the fabric reservations demand traffic made.


@dataclass(frozen=True, order=True)
class Event:
    """One scheduled fleet event. ``key`` is content-derived identity
    (session id, migration id, a per-replica step counter) — the
    tie-breaker beyond (time, kind, replica), so heap order never depends
    on insertion order. ``info`` is free-form trace payload; it only
    participates in ordering as the final dataclass-order tie-break when
    two events collide on the entire ``sort_key`` (still content-derived,
    never insertion order)."""
    time: float
    kind: EventKind
    replica: int
    key: int = 0
    info: Tuple = ()

    @property
    def sort_key(self) -> tuple:
        return (self.time, int(self.kind), self.replica, self.key)


class EventQueue:
    """Deterministic binary heap of :class:`Event`.

    Invariants the tests rely on:

    - **content-derived order** — pop order is exactly sorted
      ``(time, kind, replica, key)``; pushing the same event set in any
      order yields the same pop sequence (tie-break invariance).
    - **monotonic pops** — ``pop()`` never returns an event earlier than
      the last popped time (the fleet clock never runs backwards).
    """

    def __init__(self):
        self._heap: List[tuple] = []
        self.pushed = 0
        self.popped = 0
        self.last_time = 0.0

    def push(self, ev: Event) -> None:
        if ev.time < self.last_time - 1e-12:
            raise ValueError(
                f"event scheduled in the past: {ev.time} < {self.last_time}")
        heapq.heappush(self._heap, (ev.sort_key, ev))
        self.pushed += 1

    def pop(self) -> Event:
        _, ev = heapq.heappop(self._heap)
        self.popped += 1
        self.last_time = max(self.last_time, ev.time)
        return ev

    def peek_time(self) -> Optional[float]:
        return self._heap[0][1].time if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def drain(self) -> Iterator[Event]:
        while self._heap:
            yield self.pop()


@dataclass
class EventTrace:
    """Incrementally sha1-hashed trace of processed events.

    The canonical line for an event is ``time|kind|replica|key|info``
    with the time printed at fixed 9-decimal precision — enough that two
    runs agree iff their float trajectories are bit-identical at the
    event grain, without hashing raw float bits (repr noise). The
    determinism harness asserts ``digest()`` equality across
    reruns and across tie-break insertion orderings; CI pins the smoke
    scenario's digest via the fleet report."""
    record: bool = False
    n_events: int = 0
    events: List[tuple] = field(default_factory=list)

    def __post_init__(self):
        self._h = hashlib.sha1()

    def add(self, ev: Event) -> None:
        line = (f"{ev.time:.9e}|{int(ev.kind)}|{ev.replica}|{ev.key}|"
                f"{ev.info!r}\n")
        self._h.update(line.encode())
        self.n_events += 1
        if self.record:
            self.events.append((ev.time, int(ev.kind), ev.replica, ev.key,
                                ev.info))

    def digest(self) -> str:
        return self._h.hexdigest()

    def as_dict(self) -> dict:
        return {"n_events": self.n_events, "digest": self.digest()}
