"""Hash-sharded ownership directory for the fleet plane (DESIGN.md §13).

A single-dict ``PrefixDirectory`` is one process-local dict keyed by
full token tuples — every page-aligned prefix stores its entire token
sequence as the key (unbounded key bytes, one lock domain, O(prefix-length)
comparisons per probe). Production directories shard: this module holds
the generic machinery — fixed-width keys hashed across
:class:`DirectoryShard` partitions, per-shard lookup/update counters that
*prove* the control plane balances, per-entry fleet-wide hit counters
(the predictive replicator's signal), and a delta batch API so an
eviction sweep applies O(changed entries) directory ops in one flush.

Keys are opaque: the cluster frontend uses page-aligned prefix *digests*
(sha1 over page chunks, computed incrementally in one pass — see
``cluster.PrefixDirectory``), the analytic ``FleetSim`` uses integer
group ids. Shard choice avoids Python's randomized ``hash()`` — digests
use their leading bytes, ints a Fibonacci mix — so shard assignment (and
therefore every counter this module reports) is bit-stable across runs.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

_FIB = 0x9E3779B97F4A7C15  # 2^64 / golden ratio; Fibonacci-hash multiplier


def _mix(key) -> int:
    """Deterministic 64-bit spread of a directory key (bytes digest or
    int group id). Never uses built-in ``hash`` (PYTHONHASHSEED)."""
    if isinstance(key, (bytes, bytearray)):
        return int.from_bytes(key[:8], "big")
    return (int(key) * _FIB) & 0xFFFFFFFFFFFFFFFF


class DirectoryShard:
    """One partition: owner sets + hit counts for its keys, plus the
    lookup/update tallies the load-balance report is built from."""

    __slots__ = ("owners", "hits", "lookups", "updates")

    def __init__(self):
        self.owners: Dict[object, Set[int]] = {}
        self.hits: Dict[object, int] = {}
        self.lookups = 0
        self.updates = 0


class ShardedDirectory:
    """Ownership map hash-partitioned over :class:`DirectoryShard`s."""

    def __init__(self, n_shards: int = 8):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.shards: List[DirectoryShard] = [DirectoryShard()
                                             for _ in range(n_shards)]
        self._len = 0
        self.delta_batches = 0
        self.delta_ops = 0

    def shard_of(self, key) -> int:
        return _mix(key) % self.n_shards

    def _shard(self, key) -> DirectoryShard:
        return self.shards[self.shard_of(key)]

    # -- single-key ops -----------------------------------------------------

    def add(self, key, replica: int) -> None:
        sh = self._shard(key)
        sh.updates += 1
        owners = sh.owners.get(key)
        if owners is None:
            sh.owners[key] = {replica}
            sh.hits[key] = 0
            self._len += 1
        else:
            owners.add(replica)

    def discard(self, key, replica: int) -> None:
        sh = self._shard(key)
        sh.updates += 1
        owners = sh.owners.get(key)
        if owners is None:
            return
        owners.discard(replica)
        if not owners:
            del sh.owners[key]
            del sh.hits[key]
            self._len -= 1

    def owners(self, key) -> Optional[Set[int]]:
        """Owner set for ``key`` (live reference), or None. Counts one
        shard lookup."""
        sh = self._shard(key)
        sh.lookups += 1
        return sh.owners.get(key)

    def hit(self, key) -> int:
        """Record one fleet-wide hit on ``key``; returns the new count.
        The replicator compares this against its threshold."""
        sh = self._shard(key)
        n = sh.hits.get(key, 0) + 1
        sh.hits[key] = n
        return n

    # -- delta batches ------------------------------------------------------

    def apply_delta(self, ops: Iterable[Tuple[str, object, int]]) -> int:
        """Apply an ordered batch of ``("add"|"discard", key, replica)``
        ops — an eviction sweep's invalidations land as one O(changes)
        flush. Returns the op count (0-op batches are not counted)."""
        n = 0
        for op, key, replica in ops:
            (self.add if op == "add" else self.discard)(key, replica)
            n += 1
        if n:
            self.delta_batches += 1
            self.delta_ops += n
        return n

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        return self._len

    def shard_counters(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "entries": [len(sh.owners) for sh in self.shards],
            "lookups": [sh.lookups for sh in self.shards],
            "updates": [sh.updates for sh in self.shards],
            "delta_batches": self.delta_batches,
            "delta_ops": self.delta_ops,
        }
