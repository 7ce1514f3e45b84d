"""Continuous-batching request scheduler with prefill/decode separation.

Splitwise-style ([34], cited by the paper) phase awareness: prefill work is
admitted up to `max_prefills_per_step` per engine step so decode latency
stays bounded; decode rounds run over all resident sessions. With chunked
prefill, a slot can be resident but still *prefilling* (its prompt is being
fed in `chunk_tokens` pieces interleaved with decode rounds); such slots
are excluded from decode until the engine marks them decoding.

Prefix-aware admission: when the engine supplies a ``match_len`` scorer
(longest radix prefix the KV tree already holds for a request),
``admissions`` prefers the queued request with the longest match — requests
sharing a hot prefix batch together, so the shared pages are attached while
still pinned-hot instead of after eviction. FIFO breaks ties, and a
request bypassed ``max_skip`` times is admitted regardless (no starvation).

Deterministic (no wall clock — simulation time comes from the engine).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Set


@dataclass
class Request:
    request_id: int
    prompt_tokens: list       # list[int] (or list[list[int]] multi-codebook)
    max_new_tokens: int
    submitted_at: float
    prefilled_at: Optional[float] = None
    first_token_at: Optional[float] = None  # TTFT = this - submitted_at
    finished_at: Optional[float] = None
    generated: int = 0
    prompt_pos: int = 0       # prompt tokens prefilled so far (chunked prefill)
    sched_skipped: int = 0    # times bypassed by prefix-aware admission
    # prefix tokens a cross-replica migration grafted here for this
    # request: prefix-aware admission counts them as a match even if the
    # grafted leaf is evicted before the request is picked
    migrated_tokens: int = 0
    # earliest simulated time this request may be admitted — event-mode
    # migrations land their pages at the link's delivery time, and the
    # triggering request waits for them (TTFT pays queue wait + transfer)
    admit_after: float = 0.0
    abandoned_at: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)


@dataclass
class SchedulerStats:
    admitted: int = 0
    finished: int = 0
    queue_peak: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_chunks: int = 0
    prefix_reorders: int = 0  # admissions that jumped the FIFO order
    migrated_admissions: int = 0  # admitted requests with a migrated prefix
    abandoned: int = 0        # queued requests dropped by timeout/cancel


class ContinuousBatchScheduler:
    """Slot bookkeeping + admission policy for one engine.

    Invariants the tests rely on: every submitted request is admitted
    exactly once and finished exactly once; ``len(active) <= max_slots``
    at all times; prefix-aware admission never starves the FIFO head
    beyond ``max_skip`` bypasses; slots marked ``prefilling`` are excluded
    from decode until the engine marks them decoding."""

    def __init__(self, max_batch_slots: int, max_prefills_per_step: int = 2,
                 max_skip: int = 4):
        self.max_slots = max_batch_slots
        self.max_prefills = max_prefills_per_step
        self.max_skip = max_skip
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        self.free_slots: List[int] = list(range(max_batch_slots))
        self.prefilling: Set[int] = set()     # slots mid-chunked-prefill
        self.stats = SchedulerStats()
        self.latency: List[dict] = []         # per-finished-request records

    def submit(self, req: Request) -> None:
        self.queue.append(req)
        self.stats.queue_peak = max(self.stats.queue_peak, len(self.queue))

    def _pick(self, match_len: Optional[Callable[[Request], int]],
              now: Optional[float] = None) -> Optional[Request]:
        """Next request to admit: FIFO head, unless prefix-aware scoring
        finds a longer-match request further back (bounded by max_skip).
        With ``now`` (arrival-time admission, event clock), requests whose
        ``admit_after`` is still in the future are invisible — their pages
        (or their arrival itself) haven't happened yet on this replica's
        clock. Returns None when nothing is admissible."""
        if now is None:
            eligible = list(range(len(self.queue)))
        else:
            eligible = [i for i, r in enumerate(self.queue)
                        if r.admit_after <= now]
            if not eligible:
                return None

        def _take(idx: int) -> Request:
            req = self.queue[idx]
            del self.queue[idx]
            return req

        first = eligible[0]
        if match_len is None or len(eligible) == 1:
            return _take(first)
        head = self.queue[first]
        if head.sched_skipped >= self.max_skip:
            return _take(first)
        # a freshly migrated prefix scores as a match even when the
        # grafted leaf was evicted between migration and admission
        scores = [max(match_len(self.queue[i]), self.queue[i].migrated_tokens)
                  for i in eligible]
        best = max(scores)
        idx = eligible[scores.index(best)]  # earliest submitter among ties
        if idx == first or best <= 0:
            return _take(first)
        req = _take(idx)
        for i in eligible:
            if i < idx:  # indices below idx are unshifted by the delete
                self.queue[i].sched_skipped += 1
        self.stats.prefix_reorders += 1
        return req

    def admissions(self, limit: Optional[int] = None,
                   match_len: Optional[Callable[[Request], int]] = None,
                   now: Optional[float] = None) -> List[tuple]:
        """Pick (slot, request) pairs to start prefilling this step."""
        n = self.max_prefills if limit is None else min(limit, self.max_prefills)
        out = []
        while self.queue and self.free_slots and len(out) < n:
            req = self._pick(match_len, now)
            if req is None:
                break
            slot = self.free_slots.pop(0)
            self.active[slot] = req
            self.stats.admitted += 1
            if req.migrated_tokens > 0:
                self.stats.migrated_admissions += 1
            self.stats.prefill_tokens += req.prompt_len
            out.append((slot, req))
        return out

    def abandon_timed_out(self, now: float, timeout: float) -> List[Request]:
        """Drop queued requests older than ``timeout`` — the user hung up
        before first token. Only *queued* requests abandon (a session
        already holding slots runs to completion); every dropped request
        is fully removed, so abandonment can never leak queue entries."""
        dropped = [r for r in self.queue if now - r.submitted_at >= timeout]
        if dropped:
            self.queue = deque(r for r in self.queue
                               if now - r.submitted_at < timeout)
            for r in dropped:
                r.abandoned_at = now
            self.stats.abandoned += len(dropped)
        return dropped

    def abandon(self, request_id: int, now: float) -> bool:
        """Drop one queued request by id (event-driven abandonment).
        Returns False if it already left the queue (admitted/finished)."""
        for i, r in enumerate(self.queue):
            if r.request_id == request_id:
                del self.queue[i]
                r.abandoned_at = now
                self.stats.abandoned += 1
                return True
        return False

    # -- chunked-prefill phase tracking (engine-driven) ----------------
    def mark_prefilling(self, slot: int) -> None:
        self.prefilling.add(slot)

    def mark_decoding(self, slot: int) -> None:
        self.prefilling.discard(slot)

    def decode_slots(self) -> List[int]:
        return sorted(s for s in self.active if s not in self.prefilling)

    def finish(self, slot: int, now: float) -> Request:
        req = self.active.pop(slot)
        self.prefilling.discard(slot)
        req.finished_at = now
        self.free_slots.append(slot)
        self.free_slots.sort()
        self.stats.finished += 1
        self.latency.append(_latency_record(req))
        return req

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active


def _latency_record(req: Request) -> dict:
    """TTFT/ITL sample for one finished request (simulated seconds)."""
    ttft = (req.first_token_at - req.submitted_at
            if req.first_token_at is not None else None)
    itl = None
    if (req.first_token_at is not None and req.finished_at is not None
            and req.generated > 1):
        itl = (req.finished_at - req.first_token_at) / (req.generated - 1)
    return {"request_id": req.request_id, "ttft": ttft, "itl": itl,
            "generated": req.generated}
