"""Analytic event-driven fleet simulator (DESIGN.md §12).

The real ``ServeEngine`` runs actual JAX compute, so a fleet of replicas
tops out at a handful of requests per test. ROADMAP open item 2 needs the
opposite regime: dozens–hundreds of replicas and ~10⁶ queued sessions, so
that retention decay, refresh scheduling and migration queuing meet
*realistic timescales* — the regime where the paper's managed-retention
bet (PAPER.md §4) either pays or doesn't. :class:`FleetSim` closes that
gap with an analytic replica model on the event core of
:mod:`repro_torch.serving.events`:

- **Requests are symbolic.** A :class:`FleetRequest` carries a prefix
  *group* plus shared/unique token counts instead of token lists, so
  prefix matching is a dict lookup and a million sessions fit in memory.
- **Latency is byte-accounted, not made up.** A replica round costs one
  weight pass plus the KV bytes it moves, at the per-tier bandwidths of
  the :mod:`repro_torch.core.memclass` technology table (HBM hot tier, MRM
  warm tier, NAND cold tier). DRAM refresh and MRM scrub traffic are
  integrated over simulated wall-clock, mirroring the §11 metering.
- **Fleet semantics match the real cluster plane.** Route-first /
  migrate-on-miss against a hash-sharded prefix directory (DESIGN §13),
  transfers contending on a shared :class:`~repro_torch.serving.fabric.Fabric`
  (per-replica NIC up/down links + bisection core), optional predictive
  replication (hit-threshold-triggered low-priority pushes that yield to
  demand traffic), retention registration/decay with pins, and the
  pressure policy chain (evict-LRU → spill-to-cold → recompute) with a
  balancing ledger — the same invariants the engine-backed
  ``ClusterFrontend`` enforces, checked by :meth:`FleetSim.check`.

Every processed event feeds the sha1 :class:`~repro_torch.serving.events.EventTrace`;
``report()["trace"]["digest"]`` is the determinism contract asserted by
the test harness and CI. The simulator draws no randomness itself —
scenario generators (see ``experiments/scenarios.py``) own the RNG, so
one seed fixes the whole trajectory.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.memclass import TECHNOLOGIES
from .directory import ShardedDirectory
from .events import Event, EventKind, EventQueue, EventTrace, NonQuiescentError
from .fabric import Fabric

_EPS = 1e-12


@dataclass(frozen=True)
class FleetRequest:
    """One symbolic inference session.

    ``shared_tokens`` is the reusable prefix (system prompt, document,
    agent scratchpad) identified fleet-wide by ``group``; ``unique_tokens``
    is the per-session suffix that can never hit. Token counts, not token
    ids — the analytic plane only moves bytes."""
    session_key: int
    group: int
    shared_tokens: int
    unique_tokens: int
    max_new_tokens: int
    arrival_s: float
    abandon_after_s: Optional[float] = None
    tenant: str = "default"


@dataclass
class FleetConfig:
    """Knobs for the analytic fleet. Bandwidths/refresh come from the
    named :mod:`repro_torch.core.memclass` technologies, so the scenario zoo
    measures the same memory classes as the TCO/reliability sweeps."""
    n_replicas: int = 4
    slots_per_replica: int = 16
    max_prefills_per_round: int = 8
    chunk_tokens: int = 256
    page_tokens: int = 64
    kv_bytes_per_token: int = 131072      # 32L x 2 x 8H x 128d x fp16
    weight_bytes: float = 14e9
    hot_tech: str = "hbm3e"
    warm_tech: str = "mrm_pcm"
    cold_tech: str = "nand_slc"
    hot_capacity_bytes: float = 64e9
    warm_capacity_bytes: float = 256e9
    cold_capacity_bytes: float = 1e12
    interconnect_gbps: float = 100.0
    # shared fabric (DESIGN §13): per-replica NIC links at
    # interconnect_gbps; the switch core carries fabric_bisection_gbps
    # aggregate (None = half-bisection: link * n_replicas // 2)
    fabric_bisection_gbps: Optional[float] = None
    migrate_prefixes: bool = True
    migrate_load_gap: int = 4
    # predictive replication (DESIGN §13): once a group's fleet-wide
    # directory hit count reaches the threshold, push it to the
    # replicate_copies least-loaded non-owners (None = reactive only)
    replicate_threshold: Optional[int] = None
    replicate_copies: int = 2
    push_max_defers: int = 8
    directory_shards: int = 8
    cold_ttl_s: float = 300.0
    scrub_interval_s: Optional[float] = None
    record_trace: bool = False


@dataclass(slots=True)
class _Session:
    sid: int
    req: FleetRequest
    replica: int = -1
    phase: str = "queued"   # queued | prefill | decode | done | abandoned
    match_tokens: int = 0
    prefill_done: int = 0
    generated: int = 0
    hot_bytes: float = 0.0
    pinned_group: int = -1
    first_token_at: float = -1.0
    finished_at: float = -1.0


@dataclass(slots=True)
class _Group:
    group: int
    pages: int            # longest registered shared prefix, in pages
    bytes: float
    tier: str             # "warm" | "cold"
    pins: int = 0
    hits: int = 0
    hot: bool = False     # promoted to long-retention programming
    last_access: float = 0.0
    available_at: float = 0.0   # > now while a migration is in flight


class _Replica:
    """Per-replica state. Replicas advance independently: ``now`` only
    moves when one of this replica's events fires."""

    __slots__ = (
        "rid", "now", "queue", "active", "groups", "hot_live", "warm_live",
        "cold_live", "pending_prefills", "pending_decodes",
        "service_pending", "round_counter", "decay_next", "last_integrated",
    )

    def __init__(self, rid: int):
        self.rid = rid
        self.now = 0.0
        self.queue: deque = deque()          # sids, lazily skipping abandoned
        self.active: Dict[int, _Session] = {}
        self.groups: Dict[int, _Group] = {}
        self.hot_live = 0.0
        self.warm_live = 0.0
        self.cold_live = 0.0
        self.pending_prefills: List[Tuple[int, int]] = []   # (sid, chunk_toks)
        self.pending_decodes: List[int] = []
        self.service_pending = False
        self.round_counter = 0
        self.decay_next: Optional[float] = None
        self.last_integrated = 0.0

    def load(self) -> int:
        return len(self.queue) + len(self.active)


class FleetSim:
    """Event-driven analytic fleet. Submit :class:`FleetRequest` objects
    (any order — the queue's content-derived tie-breaks make pop order
    insertion-invariant), then :meth:`run` to quiescence."""

    def __init__(self, config: Optional[FleetConfig] = None):
        self.cfg = config or FleetConfig()
        c = self.cfg
        self.hot = TECHNOLOGIES[c.hot_tech]
        self.warm = TECHNOLOGIES[c.warm_tech]
        self.cold = TECHNOLOGIES[c.cold_tech]
        self.replicas = [_Replica(r) for r in range(c.n_replicas)]
        self.sessions: Dict[int, _Session] = {}
        self.queue = EventQueue()
        self.trace = EventTrace(record=c.record_trace)
        # fleet-shared planes: hash-sharded prefix directory (group ids
        # as keys) + the shared fabric every transfer contends on
        self.directory = ShardedDirectory(c.directory_shards)
        self.fabric = Fabric(c.n_replicas, c.interconnect_gbps,
                             c.fabric_bisection_gbps)
        # traffic + pressure counters
        self.stats = {
            "submitted": 0, "finished": 0, "abandoned": 0,
            "prefill_tokens": 0, "saved_tokens": 0, "decoded_tokens": 0,
            "kv_write_bytes": 0.0, "kv_read_bytes_hot": 0.0,
            "kv_read_bytes_warm": 0.0, "kv_read_bytes_cold": 0.0,
            "hot_refresh_bytes": 0.0, "warm_refresh_bytes": 0.0,
            "scrub_bytes": 0.0, "reprogram_bytes": 0.0,
            "reprogram_events": 0, "decayed_bytes": 0.0,
            "migrations": 0, "migrated_bytes": 0.0,
            "migration_queue_wait_s": 0.0,
            "replication_pushes": 0, "replications": 0,
            "replicated_bytes": 0.0, "pushes_deferred": 0,
            "pushes_abandoned": 0, "chained_submits": 0,
            "pressure_events": 0, "resolved_evict": 0, "resolved_spill": 0,
            "resolved_recompute": 0, "unresolved": 0,
        }
        self._records: List[dict] = []
        self._migration_seq = 0
        # speculative pushes in flight: group -> receiver rids (cleared
        # on delivery/drop, so a group is pushed at most once per target)
        self._push_inflight: Dict[int, Set[int]] = {}
        # closed-loop chains: parent session_key -> (follow-up, think_s)
        self._chained: Dict[int, Tuple[FleetRequest, float]] = {}
        # peak gauges (satellite: the fleet report used to sample these
        # after teardown, reporting 0s for any drained run)
        self.peak_directory_groups = 0
        self.peak_load = 0

    # -- submission ---------------------------------------------------------

    def submit(self, req: FleetRequest) -> None:
        sid = req.session_key
        if sid in self.sessions:
            raise ValueError(f"duplicate session_key {sid}")
        self.sessions[sid] = _Session(sid=sid, req=req)
        self.stats["submitted"] += 1
        self.queue.push(Event(req.arrival_s, EventKind.ARRIVAL, -1, key=sid))
        if req.abandon_after_s is not None:
            self.queue.push(Event(req.arrival_s + req.abandon_after_s,
                                  EventKind.ABANDON, -1, key=sid))

    def chain(self, parent_key: int, req: FleetRequest,
              think_s: float) -> None:
        """Closed-loop follow-up: when session ``parent_key`` finishes,
        ``req`` arrives ``think_s`` after the *completion instant* (its
        own ``arrival_s`` is ignored) — the arrival process is shaped by
        achieved latency, not a pre-drawn schedule. An abandoned parent
        drops its whole chain. Deterministic: the re-arrival time is
        derived from the simulated completion, and the scenario pre-draws
        ``think_s``, so no randomness depends on execution order."""
        if think_s < 0:
            raise ValueError(f"think_s must be >= 0, got {think_s}")
        if parent_key in self._chained:
            raise ValueError(f"session {parent_key} already has a chained "
                             "follow-up")
        self._chained[parent_key] = (req, think_s)

    def _drop_chain(self, sid: int) -> None:
        nxt = self._chained.pop(sid, None)
        while nxt is not None:
            nxt = self._chained.pop(nxt[0].session_key, None)

    # -- byte model ---------------------------------------------------------

    def _page_align(self, tokens: int) -> int:
        return (tokens // self.cfg.page_tokens) * self.cfg.page_tokens

    def _read_bw(self, tier: str) -> float:
        tech = {"hot": self.hot, "warm": self.warm, "cold": self.cold}[tier]
        return tech.read_bw_gbps * 1e9

    def _integrate_retention(self, rep: _Replica, t: float) -> None:
        """Charge refresh traffic for the interval since this replica last
        advanced: DRAM hot rows refresh on their interval; the MRM warm
        tier only refreshes if its technology demands it (usually not —
        that absence is the paper's density/energy discount)."""
        dt = t - rep.last_integrated
        if dt <= 0:
            return
        rep.last_integrated = t
        if self.hot.refresh_interval_s:
            self.stats["hot_refresh_bytes"] += (
                rep.hot_live * dt / self.hot.refresh_interval_s)
        if self.warm.refresh_interval_s:
            self.stats["warm_refresh_bytes"] += (
                rep.warm_live * dt / self.warm.refresh_interval_s)

    # -- pressure chain -----------------------------------------------------

    def _register_group(self, rep: _Replica, s: _Session, t: float) -> None:
        """Register/extend the shared prefix this session just computed,
        demoting its bytes from the hot working set into the retention
        plane. Capacity pressure resolves through the same policy chain
        as the real MemoryPlane: evict-LRU → spill-to-cold → recompute."""
        c = self.cfg
        pages = self._page_align(s.req.shared_tokens) // c.page_tokens
        if pages <= 0:
            return
        g = rep.groups.get(s.req.group)
        if g is not None and g.pages >= pages:
            return
        delta_pages = pages - (g.pages if g else 0)
        delta = float(delta_pages * c.page_tokens * c.kv_bytes_per_token)
        tier = g.tier if g else "warm"
        if tier == "warm" and rep.warm_live + delta > c.warm_capacity_bytes:
            self.stats["pressure_events"] += 1
            self._evict_lru(rep, delta - (c.warm_capacity_bytes
                                          - rep.warm_live))
            if rep.warm_live + delta <= c.warm_capacity_bytes + _EPS:
                self.stats["resolved_evict"] += 1
            elif rep.cold_live + delta <= c.cold_capacity_bytes:
                tier = "cold"
                self.stats["resolved_spill"] += 1
            else:
                self.stats["resolved_recompute"] += 1
                return  # nobody registers; next borrower recomputes
        elif tier == "cold" and rep.cold_live + delta > c.cold_capacity_bytes:
            self.stats["pressure_events"] += 1
            self.stats["resolved_recompute"] += 1
            return
        # move the shared delta out of this session's hot working set
        moved = min(s.hot_bytes, delta)
        s.hot_bytes -= moved
        rep.hot_live -= moved
        if tier == "warm":
            rep.warm_live += delta
        else:
            rep.cold_live += delta
        self.stats["reprogram_bytes"] += delta
        self.stats["reprogram_events"] += 1
        if g is None:
            g = _Group(group=s.req.group, pages=pages, bytes=delta,
                       tier=tier, last_access=t)
            rep.groups[s.req.group] = g
            # session keeps decoding against the pages it just registered
            if s.pinned_group < 0:
                g.pins += 1
                s.pinned_group = s.req.group
        else:
            g.pages = pages
            g.bytes += delta
            g.last_access = t
        self._dir_add(s.req.group, rep.rid)

    def _dir_add(self, group: int, rid: int) -> None:
        self.directory.add(group, rid)
        # ownership gained by any path (own compute, demand migration,
        # push delivery) cancels a pending speculative push to this rid
        inflight = self._push_inflight.get(group)
        if inflight is not None:
            inflight.discard(rid)
        n = len(self.directory)
        if n > self.peak_directory_groups:
            self.peak_directory_groups = n

    def _evict_lru(self, rep: _Replica, need: float) -> float:
        """Evict unpinned warm groups, LRU-first, until ``need`` bytes are
        freed or no candidates remain. Pinned groups are untouchable —
        the 'pinned prefixes never decay while referenced' invariant."""
        freed = 0.0
        cands = sorted(
            (g for g in rep.groups.values()
             if g.pins == 0 and g.tier == "warm"),
            key=lambda g: (g.last_access, g.group))
        for g in cands:
            if freed >= need:
                break
            self._drop_group(rep, g)
            freed += g.bytes
        return freed

    def _drop_group(self, rep: _Replica, g: _Group) -> None:
        assert g.pins == 0, "dropping a pinned prefix group"
        if g.tier == "warm":
            rep.warm_live -= g.bytes
        else:
            rep.cold_live -= g.bytes
        del rep.groups[g.group]
        self.directory.discard(g.group, rep.rid)

    # -- routing + migration ------------------------------------------------

    def _least_loaded(self) -> _Replica:
        return min(self.replicas, key=lambda r: (r.load(), r.rid))

    def _route(self, req: FleetRequest, t: float) -> _Replica:
        """Route-first / migrate-on-miss (DESIGN §7): prefer a directory
        owner of the request's group; if every owner is overloaded past
        ``migrate_load_gap`` vs the fleet minimum, send the session to the
        least-loaded replica and pull the prefix over the fabric. Every
        directory match also bumps the group's fleet-wide hit count — the
        predictive replicator's threshold signal (DESIGN §13)."""
        owners = self.directory.owners(req.group)
        best = self._least_loaded()
        if not owners or self._page_align(req.shared_tokens) <= 0:
            return best
        hits = self.directory.hit(req.group)
        if (self.cfg.replicate_threshold is not None
                and self.cfg.n_replicas > 1
                and hits >= self.cfg.replicate_threshold):
            self._maybe_replicate(req.group, t)
        owner = min((self.replicas[r] for r in owners),
                    key=lambda r: (r.load(), r.rid))
        if owner.load() - best.load() <= self.cfg.migrate_load_gap:
            return owner
        if self.cfg.migrate_prefixes and req.group not in best.groups:
            self._migrate(owner, best, req.group, t)
        return best

    def _migrate(self, src: _Replica, dst: _Replica, group: int,
                 t: float) -> None:
        """Demand pull: reserve the fabric path immediately (donor
        up-link + receiver down-link + one core channel) — speculative
        pushes queued behind this instant will see the fabric hot and
        re-defer, which is exactly how demand traffic preempts them."""
        g = src.groups[group]
        start, done = self.fabric.reserve(src.rid, dst.rid, int(g.bytes), t)
        self._migration_seq += 1
        self.queue.push(Event(done, EventKind.MIGRATION_DELIVERY, dst.rid,
                              key=self._migration_seq,
                              info=(group, g.pages, int(g.bytes), 0)))
        self.stats["migrations"] += 1
        self.stats["migrated_bytes"] += g.bytes
        self.stats["migration_queue_wait_s"] += start - t

    def _maybe_replicate(self, group: int, t: float) -> None:
        """Schedule speculative pushes so ``1 + replicate_copies``
        replicas hold the group. Pushes are REPLICATION_PUSH events — the
        lowest event priority, so at any instant every demand-side fabric
        reservation lands first and the push handler sees (and yields to)
        it."""
        owners = self.directory.owners(group)
        if not owners:
            return
        inflight = self._push_inflight.setdefault(group, set())
        need = self.cfg.replicate_copies + 1 - len(owners) - len(inflight)
        if need <= 0:
            return
        targets = sorted(
            (r for r in self.replicas
             if r.rid not in owners and r.rid not in inflight),
            key=lambda r: (r.load(), r.rid))[:need]
        for rep in targets:
            inflight.add(rep.rid)
            self.stats["replication_pushes"] += 1
            self.queue.push(Event(t, EventKind.REPLICATION_PUSH, rep.rid,
                                  key=group))

    def _on_replication_push(self, ev: Event) -> None:
        """Execute (or re-defer) one speculative push. A hot fabric means
        demand traffic reserved the path first: the push yields, retrying
        at the projected free instant, up to ``push_max_defers`` times."""
        group = ev.key
        defers = ev.info[0] if ev.info else 0
        inflight = self._push_inflight.setdefault(group, set())
        owners = self.directory.owners(group)
        if not owners or ev.replica in owners:
            inflight.discard(ev.replica)
            return  # group evicted fleet-wide / receiver already owns it
        donor = min((self.replicas[r] for r in owners),
                    key=lambda r: (r.load(), r.rid))
        if self.fabric.hot(donor.rid, ev.replica, ev.time):
            self.stats["pushes_deferred"] += 1
            if defers + 1 >= self.cfg.push_max_defers:
                self.stats["pushes_abandoned"] += 1
                inflight.discard(ev.replica)
                return
            free = self.fabric.free_at(donor.rid, ev.replica, ev.time)
            self.queue.push(Event(free, EventKind.REPLICATION_PUSH,
                                  ev.replica, key=group,
                                  info=(defers + 1,)))
            return
        g = donor.groups[group]
        start, done = self.fabric.reserve(donor.rid, ev.replica,
                                          int(g.bytes), ev.time)
        self._migration_seq += 1
        self.queue.push(Event(done, EventKind.MIGRATION_DELIVERY, ev.replica,
                              key=self._migration_seq,
                              info=(group, g.pages, int(g.bytes), 1)))
        self.stats["replications"] += 1
        self.stats["replicated_bytes"] += g.bytes
        # stays in _push_inflight until the delivery installs ownership

    # -- event handlers -----------------------------------------------------

    def _on_arrival(self, ev: Event) -> None:
        s = self.sessions[ev.key]
        rep = self._route(s.req, ev.time)
        s.replica = rep.rid
        rep.queue.append(s.sid)
        load = rep.load()
        if load > self.peak_load:
            self.peak_load = load
        self._ensure_service(rep, ev.time)

    def _on_migration_delivery(self, ev: Event) -> None:
        group, pages, nbytes = ev.info[:3]
        inflight = self._push_inflight.get(group)
        if inflight is not None:
            inflight.discard(ev.replica)
        rep = self.replicas[ev.replica]
        g = rep.groups.get(group)
        if g is not None and g.pages >= pages:
            return  # a racing registration already owns a longer prefix
        if rep.warm_live + nbytes > self.cfg.warm_capacity_bytes:
            self.stats["pressure_events"] += 1
            self._evict_lru(rep, nbytes - (self.cfg.warm_capacity_bytes
                                           - rep.warm_live))
            if rep.warm_live + nbytes > self.cfg.warm_capacity_bytes + _EPS:
                self.stats["resolved_recompute"] += 1
                return  # no room: drop the transfer, borrowers recompute
            self.stats["resolved_evict"] += 1
        if g is None:
            rep.groups[group] = _Group(
                group=group, pages=pages, bytes=float(nbytes), tier="warm",
                last_access=ev.time, available_at=ev.time)
            rep.warm_live += nbytes
        else:
            if g.tier == "cold":
                rep.cold_live -= g.bytes
                rep.warm_live += g.bytes
                g.tier = "warm"
            delta = float(nbytes) - g.bytes
            g.pages, g.bytes, g.available_at = pages, float(nbytes), ev.time
            rep.warm_live += delta
        # arrival re-programs retention on the receiving device (§8)
        self.stats["reprogram_bytes"] += nbytes
        self.stats["reprogram_events"] += 1
        self._dir_add(group, rep.rid)

    def _on_abandon(self, ev: Event) -> None:
        s = self.sessions[ev.key]
        if s.phase in ("done", "abandoned"):
            return
        self._drop_chain(s.sid)
        rep = self.replicas[s.replica]
        if s.phase in ("prefill", "decode"):
            rep.active.pop(s.sid, None)
            rep.hot_live -= s.hot_bytes
            s.hot_bytes = 0.0
            self._unpin(rep, s, ev.time)
        s.phase = "abandoned"
        self.stats["abandoned"] += 1

    def _on_retention_decay(self, ev: Event) -> None:
        rep = self.replicas[ev.replica]
        rep.decay_next = None
        expired = [g for g in rep.groups.values()
                   if g.pins == 0
                   and ev.time - g.last_access > self.cfg.cold_ttl_s - _EPS]
        for g in sorted(expired, key=lambda g: g.group):
            self.stats["decayed_bytes"] += g.bytes
            self._drop_group(rep, g)
        self._schedule_decay(rep)

    def _on_scrub(self, ev: Event) -> None:
        rep = self.replicas[ev.replica]
        self.stats["scrub_bytes"] += rep.warm_live + rep.cold_live
        # recur only while the fleet still has work — scrubbing an
        # otherwise-quiet fleet forever would never quiesce
        if self.queue:
            self.queue.push(Event(ev.time + self.cfg.scrub_interval_s,
                                  EventKind.SCRUB_DUE, rep.rid))

    # -- replica service rounds ---------------------------------------------

    def _ensure_service(self, rep: _Replica, t: float) -> None:
        if rep.service_pending:
            return
        rep.service_pending = True
        rep.round_counter += 1
        self.queue.push(Event(max(rep.now, t), EventKind.CHUNK_COMPLETE,
                              rep.rid, key=rep.round_counter))

    def _unpin(self, rep: _Replica, s: _Session, t: float) -> None:
        if s.pinned_group < 0:
            return
        g = rep.groups.get(s.pinned_group)
        s.pinned_group = -1
        if g is None:
            return
        g.pins -= 1
        g.last_access = t
        if g.pins == 0:
            self._schedule_decay(rep, g.last_access + self.cfg.cold_ttl_s)

    def _schedule_decay(self, rep: _Replica,
                        due: Optional[float] = None) -> None:
        if due is None:
            dues = [g.last_access + self.cfg.cold_ttl_s
                    for g in rep.groups.values() if g.pins == 0]
            if not dues:
                return
            due = min(dues)
        due = max(due, self.queue.last_time)
        if rep.decay_next is not None and rep.decay_next <= due + _EPS:
            return
        rep.decay_next = due
        self.queue.push(Event(due, EventKind.RETENTION_DECAY, rep.rid))

    def _admit(self, rep: _Replica, t: float) -> None:
        c = self.cfg
        admitted = 0
        while (rep.queue and len(rep.active) < c.slots_per_replica
               and admitted < c.max_prefills_per_round):
            s = self.sessions[rep.queue[0]]
            if s.phase == "abandoned":
                rep.queue.popleft()
                continue
            need = float((s.req.shared_tokens + s.req.unique_tokens
                          + s.req.max_new_tokens) * c.kv_bytes_per_token)
            if rep.hot_live + need > c.hot_capacity_bytes and rep.active:
                break  # backpressure: wait for running sessions to drain
            if rep.hot_live + need > c.hot_capacity_bytes:
                raise NonQuiescentError(
                    f"session {s.sid} needs {need:.0f}B hot KV > capacity "
                    f"{c.hot_capacity_bytes:.0f}B on replica {rep.rid}")
            rep.queue.popleft()
            admitted += 1
            g = rep.groups.get(s.req.group)
            match = 0
            if g is not None and g.available_at <= t + _EPS:
                match = min(g.pages * c.page_tokens,
                            self._page_align(s.req.shared_tokens))
                if match > 0:
                    g.pins += 1
                    g.hits += 1
                    g.last_access = t
                    s.pinned_group = s.req.group
                    if not g.hot and g.hits >= 2:
                        # observed reuse programs long retention (§5)
                        g.hot = True
                        self.stats["reprogram_bytes"] += g.bytes
                        self.stats["reprogram_events"] += 1
                    # zero-copy splice: matched pages are *read in place*
                    key = ("kv_read_bytes_warm" if g.tier == "warm"
                           else "kv_read_bytes_cold")
                    self.stats[key] += match * c.kv_bytes_per_token
            s.match_tokens = match
            s.prefill_done = match
            s.phase = "prefill"
            self.stats["saved_tokens"] += match
            rep.active[s.sid] = s

    def _on_service(self, ev: Event) -> None:
        """One replica service round: apply the work planned at the
        previous round (chunk completions, one decode token per active
        decoder), then plan and schedule the next round. The event's
        timestamp is the *completion* instant of the planned work, so
        TTFT/ITL land at byte-model-accurate times."""
        c = self.cfg
        rep = self.replicas[ev.replica]
        rep.now = ev.time
        self._integrate_retention(rep, ev.time)
        t = ev.time
        # 1. apply the round planned at the previous service event
        for sid, toks in rep.pending_prefills:
            s = self.sessions.get(sid)
            if s is None or s.phase != "prefill":
                continue
            s.prefill_done += toks
            nbytes = float(toks * c.kv_bytes_per_token)
            s.hot_bytes += nbytes
            rep.hot_live += nbytes
            self.stats["prefill_tokens"] += toks
            self.stats["kv_write_bytes"] += nbytes
            total = s.req.shared_tokens + s.req.unique_tokens
            if s.prefill_done >= s.req.shared_tokens:
                self._register_group(rep, s, t)
            if s.prefill_done >= total:
                s.phase = "decode"
        for sid in rep.pending_decodes:
            s = self.sessions.get(sid)
            if s is None or s.phase != "decode":
                continue
            s.generated += 1
            nbytes = float(c.kv_bytes_per_token)
            s.hot_bytes += nbytes
            rep.hot_live += nbytes
            self.stats["decoded_tokens"] += 1
            self.stats["kv_write_bytes"] += nbytes
            if s.first_token_at < 0:
                s.first_token_at = t
            if s.generated >= s.req.max_new_tokens:
                self._finish(rep, s, t)
        rep.pending_prefills = []
        rep.pending_decodes = []
        # 2. plan the next round
        self._admit(rep, t)
        duration = 0.0
        any_prefill = False
        for s in rep.active.values():
            total = s.req.shared_tokens + s.req.unique_tokens
            if s.phase == "prefill":
                if len(rep.pending_prefills) >= c.max_prefills_per_round:
                    continue
                toks = min(c.chunk_tokens, total - s.prefill_done)
                rep.pending_prefills.append((s.sid, toks))
                any_prefill = True
                duration += toks * c.kv_bytes_per_token / (
                    self.hot.write_bw_gbps * 1e9)
            elif s.phase == "decode":
                rep.pending_decodes.append(s.sid)
                duration += s.hot_bytes / (self.hot.read_bw_gbps * 1e9)
                g = rep.groups.get(s.pinned_group)
                if g is not None:
                    span = min(g.pages * c.page_tokens, s.match_tokens)
                    duration += (span * c.kv_bytes_per_token
                                 / self._read_bw(g.tier))
                duration += c.kv_bytes_per_token / (
                    self.hot.write_bw_gbps * 1e9)
                self.stats["kv_read_bytes_hot"] += s.hot_bytes
        rep.pending_prefills.sort()
        rep.pending_decodes.sort()
        if not rep.pending_prefills and not rep.pending_decodes:
            rep.service_pending = False
            return
        duration += c.weight_bytes / (self.hot.read_bw_gbps * 1e9)
        rep.round_counter += 1
        kind = (EventKind.CHUNK_COMPLETE if any_prefill
                else EventKind.DECODE_ROUND)
        self.queue.push(Event(t + duration, kind, rep.rid,
                              key=rep.round_counter))

    def _finish(self, rep: _Replica, s: _Session, t: float) -> None:
        s.phase = "done"
        s.finished_at = t
        rep.active.pop(s.sid, None)
        rep.hot_live -= s.hot_bytes
        s.hot_bytes = 0.0
        self._unpin(rep, s, t)
        self.stats["finished"] += 1
        gen = s.generated
        itl = ((t - s.first_token_at) / (gen - 1)) if gen > 1 else 0.0
        self._records.append({
            "request_id": s.sid,
            "ttft": s.first_token_at - s.req.arrival_s,
            "itl": itl,
            "generated": gen,
        })
        nxt = self._chained.pop(s.sid, None)
        if nxt is not None:
            # closed-loop client: the follow-up arrives think-time after
            # the completion the client actually observed
            follow, think = nxt
            self.stats["chained_submits"] += 1
            self.submit(replace(follow, arrival_s=t + think))

    # -- run loop -----------------------------------------------------------

    _HANDLERS = {
        EventKind.ARRIVAL: "_on_arrival",
        EventKind.MIGRATION_DELIVERY: "_on_migration_delivery",
        EventKind.ABANDON: "_on_abandon",
        EventKind.RETENTION_DECAY: "_on_retention_decay",
        EventKind.SCRUB_DUE: "_on_scrub",
        EventKind.CHUNK_COMPLETE: "_on_service",
        EventKind.DECODE_ROUND: "_on_service",
        EventKind.REPLICATION_PUSH: "_on_replication_push",
    }

    def run(self, max_events: Optional[int] = None,
            on_stall: str = "raise") -> dict:
        """Drain the event queue to quiescence. ``max_events`` bounds the
        run; hitting it with events still pending raises
        :class:`NonQuiescentError` (``on_stall="raise"``) or returns the
        report with ``quiesced=False`` (``on_stall="report"``)."""
        if self.cfg.scrub_interval_s and self.queue:
            for rep in self.replicas:
                self.queue.push(Event(self.cfg.scrub_interval_s,
                                      EventKind.SCRUB_DUE, rep.rid))
        processed = 0
        while self.queue:
            if max_events is not None and processed >= max_events:
                report = self.report(quiesced=False)
                if on_stall == "report":
                    return report
                raise NonQuiescentError(
                    f"fleet not quiescent after {processed} events: "
                    f"{len(self.queue)} still pending", report)
            ev = self.queue.pop()
            self.trace.add(ev)
            getattr(self, self._HANDLERS[ev.kind])(ev)
            processed += 1
        return self.report(quiesced=True)

    # -- invariants + reporting ---------------------------------------------

    def check(self) -> None:
        """Conservation invariants at an event boundary. The property
        suite calls this after every event; any drift between the ledgers
        and ground truth (recomputed from sessions/groups) is a bug."""
        for rep in self.replicas:
            hot = sum(s.hot_bytes for s in rep.active.values())
            assert abs(hot - rep.hot_live) < 1.0, (
                f"replica {rep.rid} hot ledger {rep.hot_live} != {hot}")
            for g in rep.groups.values():
                pins = sum(1 for s in rep.active.values()
                           if s.pinned_group == g.group)
                assert pins == g.pins, (
                    f"group {g.group} pins {g.pins} != {pins} referents")
            warm = sum(g.bytes for g in rep.groups.values()
                       if g.tier == "warm")
            cold = sum(g.bytes for g in rep.groups.values()
                       if g.tier == "cold")
            assert abs(warm - rep.warm_live) < 1.0, (
                f"replica {rep.rid} warm ledger {rep.warm_live} != {warm}")
            assert abs(cold - rep.cold_live) < 1.0, (
                f"replica {rep.rid} cold ledger {rep.cold_live} != {cold}")
        st = self.stats
        assert st["pressure_events"] == (
            st["resolved_evict"] + st["resolved_spill"]
            + st["resolved_recompute"] + st["unresolved"])
        # every byte a transfer moved is metered on the fabric exactly
        # once, and split exactly across the demand/speculative ledgers
        assert abs(self.fabric.bytes_total
                   - (st["migrated_bytes"] + st["replicated_bytes"])) < 1.0, (
            f"fabric bytes {self.fabric.bytes_total} != migrated "
            f"{st['migrated_bytes']} + replicated {st['replicated_bytes']}")
        for group, inflight in self._push_inflight.items():
            owners = (self.directory.owners(group) or set())
            live = inflight & owners
            assert not live, (
                f"group {group} push in flight to owners {live}")
        for pk in self._chained:
            s = self.sessions.get(pk)
            assert s is not None and s.phase not in ("done", "abandoned"), (
                f"chained follow-up parent {pk} already terminal")
        for sid, s in self.sessions.items():
            if s.phase in ("done", "abandoned"):
                assert s.hot_bytes == 0.0, f"finished {sid} leaks hot bytes"
                assert s.pinned_group < 0, f"finished {sid} leaks a pin"

    def report(self, quiesced: bool = True) -> dict:
        st = dict(self.stats)
        demanded = st["prefill_tokens"] + st["saved_tokens"]
        reuse = st["saved_tokens"] / demanded if demanded else 0.0
        ledger_imbalance = st["pressure_events"] - (
            st["resolved_evict"] + st["resolved_spill"]
            + st["resolved_recompute"] + st["unresolved"])
        loads = [r.load() for r in self.replicas]
        return {
            "quiesced": quiesced,
            "pending_events": len(self.queue),
            "pending_sessions": sum(
                1 for s in self.sessions.values()
                if s.phase not in ("done", "abandoned")),
            "n_replicas": self.cfg.n_replicas,
            "sessions": {
                "submitted": st["submitted"], "finished": st["finished"],
                "abandoned": st["abandoned"],
            },
            "slo": latency_slo(self._records),
            "fleet": {
                "prefill_tokens": st["prefill_tokens"],
                "saved_tokens": st["saved_tokens"],
                "reuse_frac": reuse,
                "decoded_tokens": st["decoded_tokens"],
                "migrations": st["migrations"],
                "migrated_bytes": st["migrated_bytes"],
                "migration_queue_wait_s": st["migration_queue_wait_s"],
                "chained_submits": st["chained_submits"],
                # peak gauges, tracked while events fire — the old
                # at-teardown samples were always 0 on a drained fleet
                "directory_groups_peak": self.peak_directory_groups,
                "peak_load": self.peak_load,
                # at-drain residue (directory entries that survived
                # decay/eviction; loads are 0 iff quiesced)
                "directory_groups_final": len(self.directory),
                "max_load": max(loads), "min_load": min(loads),
            },
            "replication": {
                "threshold": self.cfg.replicate_threshold,
                "copies": self.cfg.replicate_copies,
                "pushes_scheduled": st["replication_pushes"],
                "replications": st["replications"],
                "replicated_bytes": st["replicated_bytes"],
                "pushes_deferred": st["pushes_deferred"],
                "pushes_abandoned": st["pushes_abandoned"],
            },
            "directory": self.directory.shard_counters(),
            "fabric": self.fabric.report(),
            "retention": {
                "hot_refresh_bytes": st["hot_refresh_bytes"],
                "warm_refresh_bytes": st["warm_refresh_bytes"],
                "scrub_bytes": st["scrub_bytes"],
                "reprogram_bytes": st["reprogram_bytes"],
                "reprogram_events": st["reprogram_events"],
                "decayed_bytes": st["decayed_bytes"],
                "kv_read_bytes_warm": st["kv_read_bytes_warm"],
                "kv_read_bytes_cold": st["kv_read_bytes_cold"],
            },
            "pressure": {
                "events": st["pressure_events"],
                "resolved_evict": st["resolved_evict"],
                "resolved_spill": st["resolved_spill"],
                "resolved_recompute": st["resolved_recompute"],
                "unresolved": st["unresolved"],
                "ledger_imbalance": ledger_imbalance,
            },
            "trace": self.trace.as_dict(),
        }


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def latency_slo(records: List[dict]) -> dict:
    """TTFT/ITL p50/p95/p99 over finished-session records — same shape as
    ``repro_torch.serving.engine.latency_percentiles`` but dependency-free so
    the analytic plane never imports JAX."""
    out = {}
    for key in ("ttft", "itl"):
        vals = sorted(r[key] for r in records)
        out[key] = {"p50": _pct(vals, 0.50), "p95": _pct(vals, 0.95),
                    "p99": _pct(vals, 0.99), "n": len(vals)}
    return out
