"""Shared-fabric interconnect topology for the fleet plane (DESIGN.md §13).

A per-receiver model treats the interconnect as one independent serialized
link per *receiver* (``_link_busy_until``): a donor could feed any number
of receivers at full line rate simultaneously, and the fleet-wide core is
infinite — replication storms were free parallelism. This module replaces
that with the smallest topology that makes contention real:

- **per-replica NIC links** — every replica has one full-duplex NIC: an
  *up* (egress) link and a *down* (ingress) link, each serializing at
  ``link_gbps``. Two concurrent exports from the same donor now queue on
  the donor's up-link even when their receivers differ.
- **a bisection-bandwidth core** — the switch core carries at most
  ``bisection_gbps`` of aggregate traffic, modeled as
  ``floor(bisection / link)`` virtual channels each at line rate (a
  transfer occupies exactly one channel: NIC rate is the per-flow cap, so
  a fractional channel can never help). Defaults to half-bisection
  (``link_gbps * max(1, n_replicas // 2)``), the classic oversubscribed
  fat-tree shape.

``reserve`` is first-come-first-served at call time: a transfer starts at
the earliest instant its donor up-link, receiver down-link, and one core
channel are all free, and holds all three for ``nbytes / rate``. The
speculative replicator deliberately does *not* reserve while the fabric
is hot (``free_at() > now``): it re-defers instead, so a demand migration
that arrives in the gap reserves first — that asymmetry is the whole
admission-control/preemption story (tested in ``tests/test_fabric.py``).

Determinism: every quantity is derived from reserve-call order, which the
event queue makes content-derived; channel selection tie-breaks on index.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

_EPS = 1e-12


class Fabric:
    """Per-replica NIC up/down links plus a bisection-limited core."""

    def __init__(self, n_replicas: int, link_gbps: float,
                 bisection_gbps: Optional[float] = None):
        if link_gbps <= 0:
            raise ValueError(f"link_gbps must be positive, got {link_gbps}")
        if bisection_gbps is None:
            bisection_gbps = link_gbps * max(1, n_replicas // 2)
        if bisection_gbps < link_gbps:
            raise ValueError(
                f"bisection ({bisection_gbps} GB/s) below a single link "
                f"({link_gbps} GB/s): no transfer could ever run")
        self.n_replicas = n_replicas
        self.link_gbps = float(link_gbps)
        self.bisection_gbps = float(bisection_gbps)
        self.n_channels = max(1, int(bisection_gbps / link_gbps))
        self._up: Dict[int, float] = {}    # donor egress busy-until
        self._down: Dict[int, float] = {}  # receiver ingress busy-until
        self._core: List[float] = [0.0] * self.n_channels
        # ledgers — every reserved byte is metered here exactly once
        self.transfers = 0
        self.bytes_total = 0
        self.busy_s = 0.0        # sum of transfer durations
        self.queue_wait_s = 0.0  # sum of (start - requested) waits
        self.up_bytes: Dict[int, int] = {}
        self.down_bytes: Dict[int, int] = {}

    # -- capacity queries ---------------------------------------------------

    def free_at(self, src: int, dst: int, t: float) -> float:
        """Earliest instant a ``src -> dst`` transfer requested at ``t``
        could start (no reservation made)."""
        return max(t, self._up.get(src, 0.0), self._down.get(dst, 0.0),
                   min(self._core))

    def hot(self, src: int, dst: int, t: float) -> bool:
        """True when a ``src -> dst`` transfer requested now would queue —
        the replicator's admission-control signal."""
        return self.free_at(src, dst, t) > t + _EPS

    # -- reservation --------------------------------------------------------

    def reserve(self, src: int, dst: int, nbytes: int,
                t: float) -> Tuple[float, float]:
        """Reserve the path for ``nbytes`` requested at ``t``; returns
        ``(start, done)`` and holds up-link, down-link and one core
        channel for the duration."""
        dur = nbytes / (self.link_gbps * 1e9)
        chan = min(range(self.n_channels), key=lambda i: (self._core[i], i))
        start = max(t, self._up.get(src, 0.0), self._down.get(dst, 0.0),
                    self._core[chan])
        done = start + dur
        self._up[src] = done
        self._down[dst] = done
        self._core[chan] = done
        self.transfers += 1
        self.bytes_total += int(nbytes)
        self.busy_s += dur
        self.queue_wait_s += start - t
        self.up_bytes[src] = self.up_bytes.get(src, 0) + int(nbytes)
        self.down_bytes[dst] = self.down_bytes.get(dst, 0) + int(nbytes)
        return start, done

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        return {
            "link_gbps": self.link_gbps,
            "bisection_gbps": self.bisection_gbps,
            "n_channels": self.n_channels,
            "transfers": self.transfers,
            "bytes": self.bytes_total,
            "busy_s": self.busy_s,
            "queue_wait_s": self.queue_wait_s,
            "up_bytes": dict(sorted(self.up_bytes.items())),
            "down_bytes": dict(sorted(self.down_bytes.items())),
        }
