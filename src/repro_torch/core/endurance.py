"""Endurance accounting and software wear-levelling (paper §4:
"lightweight memory controllers" — refresh and wear-levelling lifted out of
the device into the control plane).

Also hosts the Figure-1 arithmetic: writes/cell over a device lifetime for
the weight-update and KV-cache-append workloads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.memclass import YEAR, MemTechnology


# ---------------------------------------------------------------------------
# Figure-1 arithmetic
# ---------------------------------------------------------------------------


def writes_per_cell(write_bytes_per_s: float, capacity_bytes: float,
                    lifetime_s: float = 5 * YEAR,
                    leveling_efficiency: float = 1.0) -> float:
    """Average writes per cell over the device lifetime.

    Perfect wear-levelling spreads the write stream uniformly; a real
    software leveller achieves `leveling_efficiency` (<= 1) of that.
    """
    total_writes = write_bytes_per_s * lifetime_s
    return total_writes / capacity_bytes / max(leveling_efficiency, 1e-9)


def weight_update_writes(update_period_s: float, lifetime_s: float = 5 * YEAR) -> float:
    """Paper §3: weights are bulk-overwritten when the model is replaced —
    each update writes every cell of the weight region exactly once."""
    return lifetime_s / update_period_s


# ---------------------------------------------------------------------------
# Block wear state + software wear-levelling allocator
# ---------------------------------------------------------------------------


@dataclass
class WearState:
    """Per-block write counters for one MRM device/region."""
    n_blocks: int
    block_bytes: int
    endurance: float
    writes: np.ndarray = field(default=None)  # type: ignore
    scrub_rewrites: int = 0  # corrective rewrites (DESIGN.md §11 scrubs)

    def __post_init__(self):
        if self.writes is None:
            self.writes = np.zeros(self.n_blocks, dtype=np.float32)

    def record_write(self, block_ids) -> None:
        self.writes[np.asarray(block_ids)] += 1.0

    def record_scrub(self, block_ids) -> None:
        """Scrub-on-read rewrite: same wear as a refresh rewrite, counted
        separately so the endurance budget attributes reliability traffic."""
        self.scrub_rewrites += len(block_ids)
        self.record_write(block_ids)

    @property
    def max_wear(self) -> float:
        return float(self.writes.max(initial=0.0))

    @property
    def mean_wear(self) -> float:
        return float(self.writes.mean()) if self.n_blocks else 0.0

    @property
    def wear_ratio(self) -> float:
        """max/mean — 1.0 is perfect levelling."""
        m = self.mean_wear
        return self.max_wear / m if m > 0 else 1.0

    def life_used(self) -> float:
        return self.max_wear / self.endurance

    def project_lifetime_s(self, write_bytes_per_s: float, now_s: float) -> float:
        """Remaining seconds until the most-worn block hits endurance,
        extrapolating the current write rate with the current wear ratio."""
        if write_bytes_per_s <= 0:
            return float("inf")
        mean_rate = write_bytes_per_s / (self.n_blocks * self.block_bytes)
        max_rate = mean_rate * self.wear_ratio
        remaining = self.endurance - self.max_wear
        return remaining / max(max_rate, 1e-30)


class WearLevelingAllocator:
    """Least-worn-first free-block allocator, O(log n) per op.

    The control plane owns allocation, so levelling is a policy, not device
    firmware. Never-written blocks (wear 0) are handed out from a sequential
    frontier (also giving new allocations *physically sequential* block
    runs — the paper's sequential-IO property); freed blocks re-enter via a
    min-heap keyed by wear, so reuse prefers the least-worn.
    """

    def __init__(self, wear: WearState):
        import heapq
        self.wear = wear
        self._frontier = 0                      # next never-used block
        self._freed: list = []                  # heap of (wear, block)
        self._heapq = heapq
        self._n_free = wear.n_blocks

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > self._n_free:
            return None
        picked: List[int] = []
        fresh = min(n, self.wear.n_blocks - self._frontier)
        if fresh > 0:
            picked.extend(range(self._frontier, self._frontier + fresh))
            self._frontier += fresh
        while len(picked) < n:
            _, b = self._heapq.heappop(self._freed)
            picked.append(b)
        self._n_free -= n
        self.wear.record_write(picked)
        return picked

    def free_blocks(self, block_ids) -> None:
        for b in block_ids:
            self._heapq.heappush(self._freed, (float(self.wear.writes[int(b)]), int(b)))
        self._n_free += len(block_ids)

    def rewrite_in_place(self, block_ids) -> None:
        """A refresh rewrite (costs wear, keeps placement)."""
        self.wear.record_write(block_ids)

    def scrub_in_place(self, block_ids) -> None:
        """A scrub's corrective rewrite — refresh wear, scrub-attributed."""
        self.wear.record_scrub(block_ids)

    @property
    def utilization(self) -> float:
        return 1.0 - self._n_free / max(self.wear.n_blocks, 1)
