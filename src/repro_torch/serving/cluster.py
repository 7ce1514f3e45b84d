"""Multi-replica cluster frontend over per-replica MRM control planes,
with a fleet-level prefix directory and cross-replica KV migration.

The paper's deployment unit is a fleet: many accelerators, each with its
own MRM stack, serving a shared request population (§2.2 "millions of
users"). The radix index makes prefix reuse real *inside* one replica; this module
turns the per-replica radix trees into one coherent fleet memory plane
(DESIGN.md §7): KV state is read-dominated and rewrite-tolerant, so
*moving* a hot prefix's pages between replicas is cheap relative to
recomputing them cold.

- **PrefixDirectory** — a fleet-level map from page-aligned prefix keys
  (position-space token tuples) to the replicas whose radix trees hold
  them. Ownership is registered when a replica publishes a path
  (``register_prefix`` / ``adopt_prefix``) and invalidated when a leaf
  leaves a tree (pressure eviction, watermark, cold decay) — the evicted
  run's prefixes are dropped, ancestor prefixes stay owned.
- **route-first, migrate-on-miss** — :meth:`ClusterFrontend.route`
  consults the directory: the least-loaded owner of the longest
  registered prefix wins while it has headroom; when every owner is
  overloaded (load gap above ``migrate_load_gap`` vs the least-loaded
  replica) the donor's pages and compute snapshot are *pulled* into the
  target replica as a metered inter-replica transfer — bytes charged at
  ``interconnect_gbps`` into the simulated clock, page writes metered
  against the receiving tiers, retention re-programmed on arrival through
  the one lifecycle state machine (DESIGN.md §9: a donor-hot prefix lands
  in the receiver's hot tier at long retention).
- **shared-fabric admission control** (DESIGN.md §13) — transfers run
  over a :class:`~repro_torch.serving.fabric.Fabric` topology: every replica
  has one full-duplex NIC (up + down link) and the switch core carries a
  bisection-bandwidth cap, so concurrent migrations and replications
  contend realistically (two exports from one donor serialize on its
  up-link even to distinct receivers). A transfer finding any resource
  busy queues (the wait is reported in the fleet report's
  ``interconnect`` section) and the triggering request's TTFT pays queue
  wait + transfer time.
- **predictive replication** (DESIGN.md §13) — the directory counts
  fleet-wide hits per entry; crossing ``replicate_threshold`` pushes the
  prefix to the ``replicate_copies`` least-loaded non-owners *before*
  the fan-out burst lands, as low-priority ``REPLICATION_PUSH`` events
  that yield (re-defer) whenever the fabric is carrying demand traffic.
- **session-affinity fallback** — requests carrying a ``session_key``
  with no directory match go to their sticky replica;
- **least-loaded routing** — keyless, matchless requests go to the
  replica with the fewest queued+resident requests; ties break on the KV
  tier's physical occupancy (live session pages, directory-owned
  radix-resident prefixes and metered snapshots all count, so a replica
  stuffed with pinned shared prefixes is not treated as empty);
- **two clock disciplines** (DESIGN.md §12) — ``clock_mode="lockstep"``
  is the compatibility mode: a cluster round lasts as long as
  the slowest replica and lagging replicas advance to the fleet clock
  (every existing sweep reproduces bit-for-bit). ``clock_mode="event"``
  runs the same replicas on the typed-event core of
  :mod:`repro_torch.serving.events`: each replica's steps are events on its
  *own* clock, arrivals are timestamped events, migrations deliver at
  the link's free time (the triggering request admits only after
  delivery), and replicas synchronize solely through the directory, the
  links and the fleet event queue;
- **aggregated fleet report** — tokens, per-tier bytes, energy, pressure
  resolutions, prefix-reuse and interconnect counters, pooled TTFT/ITL
  percentiles, with the per-replica breakdown attached (conservation is
  testable), plus a ``quiesced`` flag and the event-trace digest.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.serving.directory import ShardedDirectory
from repro_torch.serving.engine import ServeEngine, latency_percentiles
from repro_torch.serving.events import (Event, EventKind, EventQueue, EventTrace,
                                  NonQuiescentError)
from repro_torch.serving.fabric import Fabric
from repro_torch.serving.radix import _flat


class PrefixDirectory:
    """Fleet-level map: page-aligned prefix -> owning replicas, stored as
    fixed-width sha1 *digests* hash-partitioned over
    :class:`~repro_torch.serving.directory.DirectoryShard`s (DESIGN.md §13).

    Keys are position-space: each page's digest chains the hash state of
    every page before it (sentinel meta prefix + prompt tokens, exactly
    the radix tree's path), so a lookup agrees with what
    ``RadixKVIndex.match_len`` would find on the owner while storing 20
    bytes per entry instead of the full token tuple. Every page-aligned
    prefix of a registered path gets an entry (idempotent), which makes
    invalidation exact: an evicted leaf drops ownership of precisely the
    run it covered, as O(changed pages) shard ops.

    Hook traffic (register on publish, invalidate on evict/decay) queues
    into a pending delta and is applied as one batch at the next read
    (``flush``) — an eviction sweep's invalidations land as a single
    O(changes) delta instead of interleaved point updates. Reads
    (lookup / owned_by / n_entries) always flush first, so callers never
    observe stale ownership."""

    def __init__(self, page_tokens: int, n_shards: int = 8):
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        self.page_tokens = page_tokens
        self.shards = ShardedDirectory(n_shards)
        self.registrations = 0
        self.invalidations = 0
        self._delta: List[Tuple[str, bytes, int]] = []

    @staticmethod
    def _key(tokens: Sequence) -> list:
        return _flat(tokens)

    def _digests(self, flat: list) -> List[bytes]:
        """sha1 digest per page-aligned prefix, one incremental pass: the
        hash state carries across page boundaries, so digesting all n
        prefixes of an n-page path is O(path), not O(path^2)."""
        pt = self.page_tokens
        n = (len(flat) // pt) * pt
        h = hashlib.sha1()
        out: List[bytes] = []
        for end in range(pt, n + 1, pt):
            h.update(repr(flat[end - pt:end]).encode())
            out.append(h.digest())
        return out

    def register(self, replica: int, tokens: Sequence) -> None:
        """Replica ``replica`` now holds every page-aligned prefix of
        ``tokens`` in its radix tree."""
        digs = self._digests(self._key(tokens))
        self._delta.extend(("add", d, replica) for d in digs)
        if digs:
            self.registrations += 1

    def invalidate(self, replica: int, tokens: Sequence,
                   tail_tokens: int) -> None:
        """A leaf covering the last ``tail_tokens`` of path ``tokens``
        left ``replica``'s tree: drop its ownership of the prefixes that
        run covered (ancestor prefixes remain owned — they are still in
        the tree). One linear hash pass; O(changed pages) shard ops."""
        digs = self._digests(self._key(tokens))
        pt = self.page_tokens
        start_page = max(len(digs) * pt - tail_tokens, 0) // pt
        self._delta.extend(("discard", d, replica)
                           for d in digs[start_page:])
        self.invalidations += 1

    def flush(self) -> None:
        """Apply queued hook ops as one delta batch."""
        if self._delta:
            ops, self._delta = self._delta, []
            self.shards.apply_delta(ops)

    def lookup_entry(self, tokens: Sequence
                     ) -> Tuple[int, Optional[Set[int]], Optional[bytes]]:
        """Longest registered page-aligned prefix of ``tokens``:
        ``(matched_tokens, owner_replicas, digest)`` — the digest is the
        directory key for hit recording; ``(0, None, None)`` on miss."""
        self.flush()
        digs = self._digests(self._key(tokens))
        for i in range(len(digs) - 1, -1, -1):
            owners = self.shards.owners(digs[i])
            if owners:
                return (i + 1) * self.page_tokens, owners, digs[i]
        return 0, None, None

    def lookup(self, tokens: Sequence) -> Tuple[int, Optional[Set[int]]]:
        matched, owners, _ = self.lookup_entry(tokens)
        return matched, owners

    def record_hit(self, digest: bytes) -> int:
        """One fleet-wide hit on ``digest``'s entry; returns the count —
        the predictive replicator's threshold signal."""
        return self.shards.hit(digest)

    def owned_by(self, replica: int) -> int:
        self.flush()
        return sum(1 for sh in self.shards.shards
                   for o in sh.owners.values() if replica in o)

    def n_entries(self) -> int:
        self.flush()
        return len(self.shards)


class ClusterFrontend:
    """Fans requests across N :class:`ServeEngine` replicas under one
    fleet memory plane (DESIGN.md §7).

    Invariants the tests rely on:

    - **Directory ownership lifecycle** — the :class:`PrefixDirectory`
      mirrors every replica's radix tree: ownership appears with
      ``register_prefix``/``adopt_prefix`` (incl. the bootstrap of trees
      that served before this frontend attached) and disappears with
      exactly the run an evicted leaf covered.
    - **Migration conservation** — a migration copies (never moves) the
      donor's pages: donor refcounts are untouched, receiver pages are
      tree-owned, and both replicas tear down to zero allocator
      utilization; truncated adoptions stay page-aligned and never leave
      an unresolved pressure event.
    - **Report conservation** — fleet totals (tokens, per-tier bytes,
      pressure resolutions, pooled latency records) equal the sum of the
      per-replica reports.
    - **Clock coherence** — a cluster round ends with every replica at
      the fleet clock (the slowest replica's time), and a migration's
      interconnect wait is charged to the triggering request's TTFT.
    """

    #: bounded speculative-push retries: after this many fabric-hot
    #: defers a push is abandoned (the demand path will pull on miss)
    _PUSH_MAX_DEFERS = 8

    def __init__(self, engines: List[ServeEngine],
                 migrate_prefixes: bool = False,
                 interconnect_gbps: float = 50.0,
                 migrate_load_gap: int = 2,
                 prefix_affinity: bool = True,
                 clock_mode: str = "lockstep",
                 record_trace: bool = False,
                 replicate_threshold: Optional[int] = None,
                 replicate_copies: int = 1,
                 directory_shards: int = 8,
                 fabric_bisection_gbps: Optional[float] = None):
        if not engines:
            raise ValueError("ClusterFrontend needs at least one replica")
        if interconnect_gbps <= 0:
            raise ValueError("interconnect_gbps must be > 0")
        if clock_mode not in ("lockstep", "event"):
            raise ValueError(f"unknown clock_mode {clock_mode!r}")
        self.clock_mode = clock_mode
        self.engines = list(engines)
        self.migrate_prefixes = migrate_prefixes
        # GBYTES/s — deliberately the same (historically misnamed) unit as
        # memclass's read_bw_gbps/write_bw_gbps tier fields
        self.interconnect_gbps = interconnect_gbps
        self.migrate_load_gap = migrate_load_gap
        self.prefix_affinity = prefix_affinity
        self.routes: Dict[str, int] = {}          # session_key -> replica
        self.requests: Dict[int, Tuple[int, int]] = {}  # rid -> (replica, local)
        self._next_rid = 0
        self.steps = 0
        self.radix_routed = 0      # requests placed by prefix affinity
        self.migrations = 0        # cross-replica prefix transfers
        self.migrated_tokens = 0   # tokens newly backed on a receiver
        self.migration_bytes = 0.0  # KV + snapshot bytes over the wire
        self.migration_s = 0.0      # interconnect transfer time charged
        self.migration_queue_wait_s = 0.0  # time spent queued on a busy link
        self.migrations_queued = 0  # transfers that found their link busy
        self._last_migrated = 0    # tokens grafted for the pending submit
        # predictive replication (DESIGN §13): once a directory entry's
        # fleet-wide hit count crosses the threshold, push it to the
        # least-loaded non-owners ahead of the burst (None = reactive)
        self.replicate_threshold = replicate_threshold
        self.replicate_copies = replicate_copies
        self.replications = 0          # speculative pushes delivered
        self.replicated_tokens = 0
        self.replication_bytes = 0.0
        self.replication_s = 0.0
        self.replications_deferred = 0  # pushes that yielded to a hot fabric
        self.pushes_abandoned = 0       # defer budget exhausted / entry gone
        self._push_inflight: Set[Tuple[bytes, int]] = set()
        self._pending_pushes: Dict[int, tuple] = {}
        self._push_seq = 0
        # shared-fabric admission control (DESIGN §13): every transfer
        # holds its donor's up-link, its receiver's down-link, and one
        # bisection core channel — concurrent migrations and replications
        # contend realistically; a transfer finding any resource busy
        # queues, and the triggering request waits out queue + transfer.
        self.fabric = Fabric(len(engines), interconnect_gbps,
                             fabric_bisection_gbps)
        # deferred interconnect charges (replica -> seconds): applied at
        # the next cluster step, *after* the triggering requests are
        # enqueued, so their submitted_at predates the transfer and their
        # TTFT pays for the queue wait + migration time. Deferring a whole
        # burst (rather than flushing per submit) is what lets same-burst
        # migrations to one receiver actually contend for its link.
        self._pending_transfer: Dict[int, float] = {}
        # fleet-level prefix directory: every replica's publishes and
        # evictions flow in through the manager hooks; pre-existing tree
        # content (engines that served before this frontend) bootstraps in
        self.directory = PrefixDirectory(engines[0].ecfg.page_tokens,
                                         n_shards=directory_shards)
        for i, e in enumerate(self.engines):
            e.kv.on_prefix_insert = (
                lambda tokens, _i=i: self.directory.register(_i, tokens))
            e.kv.on_prefix_evict = (
                lambda tokens, tail, _i=i:
                    self.directory.invalidate(_i, tokens, tail))
            for node in e.kv.radix.nodes():
                self.directory.register(i, e.kv.radix.full_key(node))
        # event clock (DESIGN.md §12): typed events on a deterministic
        # queue; replicas advance independently. Unused in lockstep mode.
        self.events = EventQueue()
        self.trace = EventTrace(record=record_trace)
        self._pending_arrivals: Dict[int, tuple] = {}  # rid -> submit args
        self._step_pending: Dict[int, bool] = {}
        self._step_seq: Dict[int, int] = {}
        self._last_delivery_at: Optional[float] = None
        self._route_time = 0.0
        self._migration_seq = 0
        self._decay_next: Dict[int, Optional[float]] = {}

    # ------------------------------------------------------------------
    @property
    def now(self) -> float:
        return max(e.mem.now for e in self.engines)

    @property
    def idle(self) -> bool:
        return all(e.sched.idle for e in self.engines)

    def _load(self, i: int) -> int:
        e = self.engines[i]
        return len(e.sched.queue) + len(e.sched.active)

    def _load_key(self, i: int) -> tuple:
        """Replica load for routing: queue+resident first, then the KV
        tier's *physical* occupancy (allocator utilization: live session
        pages, directory-owned radix-resident prefixes AND metered
        snapshots all occupy it) — so a replica stuffed with pinned hot
        prefixes loses ties to an equally-queued replica with free KV —
        then index for determinism. O(1) per replica: no session or tree
        walk on the routing path."""
        e = self.engines[i]
        return (self._load(i),
                round(e.mem.utilization(e.ecfg.kv_tier), 9), i)

    # -- the directory protocol: route first, migrate on miss ----------
    def _migrate(self, donor: int, target: int, key,
                 speculative: bool = False) -> int:
        """Pull the donor's published prefix (pages + compute snapshot)
        into the target replica as a metered inter-replica transfer.
        ``speculative`` marks a predictive replication push: same wire
        physics and tier metering, separate ledger, and no request is
        gated on its delivery. Returns the tokens now matched on the
        target (0 = nothing moved)."""
        exp = self.engines[donor].export_prefix(key)
        if exp is None:
            return 0
        e = self.engines[target]
        imp = e.import_prefix(exp["tokens"], caches=exp["caches"],
                              hot=exp["hot"], hits=exp["hits"],
                              snap_kind=exp["snap_kind"],
                              snap_tokens=exp["snap_tokens"],
                              page_data=exp.get("page_data"),
                              page_tokens=exp.get("page_tokens"))
        if imp["total_tokens"] == 0:
            return 0
        moved = (imp["new_tokens"] * e.kv.kv_bytes_token
                 + imp["snapshot_bytes"])
        if moved > 0:
            # shared-fabric admission control: the transfer starts when
            # the donor's up-link, the receiver's down-link AND a core
            # channel are all free (queue wait), then holds all three for
            # bytes / bandwidth. Lockstep advances the receiver's clock
            # at the next cluster step (_flush_transfer); event mode
            # schedules a MIGRATION_DELIVERY event at the wire-done time
            # and (for demand pulls) gates the triggering request's
            # admission on it. Either way TTFT pays queue wait + transfer.
            dur = moved / (self.interconnect_gbps * 1e9)
            t_req = (self._route_time if self.clock_mode == "event"
                     else e.mem.now)
            start, done = self.fabric.reserve(donor, target, moved, t_req)
            wait = start - t_req
            if self.clock_mode == "event":
                if not speculative:
                    self._last_delivery_at = done
                self._migration_seq += 1
                self.events.push(Event(done,
                                       EventKind.MIGRATION_DELIVERY, target,
                                       key=self._migration_seq,
                                       info=(imp["new_tokens"],
                                             int(speculative))))
            else:
                self._pending_transfer[target] = max(
                    self._pending_transfer.get(target, 0.0), done - t_req)
            if speculative:
                self.replications += 1
                self.replicated_tokens += imp["new_tokens"]
                self.replication_bytes += moved
                self.replication_s += dur
            else:
                if wait > 0:
                    self.migrations_queued += 1
                    self.migration_queue_wait_s += wait
                self.migrations += 1
                self.migrated_tokens += imp["new_tokens"]
                self.migration_bytes += moved
                self.migration_s += dur
        return imp["total_tokens"]

    def _flush_transfer(self, i: int) -> None:
        t = self._pending_transfer.pop(i, 0.0)
        if t > 0:
            self.engines[i].mem.advance(t)

    def _route_by_prefix(self, prompt_tokens: list,
                         session_key: Optional[str]) -> Optional[int]:
        """Directory consult: the least-loaded owner of the longest
        registered prefix wins while it has headroom; otherwise the
        prefix is migrated to the least-loaded replica and the request
        follows it."""
        if not self.prefix_affinity:
            return None
        key = self.engines[0].radix_key_for(prompt_tokens)
        if key is None:
            return None
        matched, owners, digest = self.directory.lookup_entry(key)
        if not matched or not owners:
            return None
        live = [i for i in owners if i < len(self.engines)]
        if not live:
            return None
        hits = self.directory.record_hit(digest)
        choice = min(live, key=self._load_key)
        if self.migrate_prefixes and len(self.engines) > 1:
            least = min(range(len(self.engines)), key=self._load_key)
            if (least not in live and
                    self._load(choice) - self._load(least)
                    > self.migrate_load_gap):
                got = self._migrate(choice, least, key)
                if got > 0:
                    self._last_migrated = got
                    choice = least
        if (self.replicate_threshold is not None
                and len(self.engines) > 1
                and hits >= self.replicate_threshold):
            self._maybe_replicate(key, digest)
        self.radix_routed += 1
        if session_key is not None:
            self.routes[str(session_key)] = choice
        return choice

    def _maybe_replicate(self, key, digest: bytes) -> None:
        """Predictive replication (DESIGN §13): the entry crossed its
        fleet-wide hit threshold — push it to the least-loaded non-owners
        until ``1 + replicate_copies`` replicas hold it. Event mode
        schedules low-priority REPLICATION_PUSH events (they fire after
        every demand event at the same instant and re-defer while the
        fabric is hot); lockstep pushes inline, skipping when the fabric
        is busy (the next hit retries)."""
        _, owners, _ = self.directory.lookup_entry(key)  # post-migration
        if not owners:
            return
        live = sorted(i for i in owners if i < len(self.engines))
        if not live:
            return
        inflight = sum(1 for d, _t in self._push_inflight if d == digest)
        need = self.replicate_copies + 1 - len(live) - inflight
        if need <= 0:
            return
        targets = sorted(
            (i for i in range(len(self.engines))
             if i not in owners and (digest, i) not in self._push_inflight),
            key=self._load_key)[:need]
        donor = min(live, key=self._load_key)
        for target in targets:
            if self.clock_mode == "event":
                self._push_seq += 1
                self._push_inflight.add((digest, target))
                self._pending_pushes[self._push_seq] = (digest, key, target, 0)
                self.events.push(Event(self._route_time,
                                       EventKind.REPLICATION_PUSH, target,
                                       key=self._push_seq))
            else:
                if self.fabric.hot(donor, target,
                                   self.engines[target].mem.now):
                    self.replications_deferred += 1
                    continue
                self._migrate(donor, target, key, speculative=True)

    def route(self, session_key: Optional[str] = None,
              prompt_tokens: Optional[list] = None) -> int:
        # 1) fleet prefix directory: owner affinity, migrate on overload
        if prompt_tokens is not None:
            i = self._route_by_prefix(prompt_tokens, session_key)
            if i is not None:
                return i
        # 2) sticky session fallback (the user's first follow-up lands
        #    where their prefix will be, before the directory has seen it)
        if session_key is not None:
            key = str(session_key)
            if key not in self.routes:
                h = int(hashlib.sha1(key.encode()).hexdigest(), 16)
                self.routes[key] = h % len(self.engines)
            return self.routes[key]
        # 3) least-loaded (KV-pressure-aware, hot-prefix bytes included)
        return min(range(len(self.engines)), key=self._load_key)

    def submit(self, prompt_tokens: list, max_new_tokens: int,
               session_key: Optional[str] = None,
               at: Optional[float] = None,
               abandon_after_s: Optional[float] = None) -> int:
        """Route and enqueue a request; returns a cluster-wide request id.

        Lockstep mode routes immediately on the shared clock (exactly the
        shared-clock behavior). Event mode records an ARRIVAL event at ``at``
        (default: the fleet clock) — routing happens when the event
        fires, against the replica loads of *that* simulated instant, and
        an optional ``abandon_after_s`` schedules a timeout event that
        drops the request if it is still queued."""
        rid = self._next_rid
        self._next_rid += 1
        if self.clock_mode == "event":
            t = self.now if at is None else at
            self._pending_arrivals[rid] = (
                prompt_tokens, max_new_tokens, session_key)
            self.events.push(Event(max(t, self.events.last_time),
                                   EventKind.ARRIVAL, -1, key=rid))
            if abandon_after_s is not None:
                self.events.push(Event(max(t, self.events.last_time)
                                       + abandon_after_s,
                                       EventKind.ABANDON, -1, key=rid))
            return rid
        self._last_migrated = 0
        replica = self.route(session_key, prompt_tokens)
        local = self.engines[replica].submit(
            prompt_tokens, max_new_tokens,
            migrated_tokens=self._last_migrated)
        # the migration this submit may have triggered is charged at the
        # next cluster step (submitted_at predates the transfer, so TTFT
        # pays the link's queue wait + transfer time); deferring past the
        # whole submit burst is what makes same-burst migrations to one
        # receiver contend for its link (admission control)
        self.requests[rid] = (replica, local)
        return rid

    def output(self, rid: int) -> list:
        replica, local = self.requests[rid]
        return self.engines[replica].outputs[local]

    def replica_of(self, rid: int) -> int:
        return self.requests[rid][0]

    # ------------------------------------------------------------------
    def step(self) -> dict:
        """One cluster round: every busy replica runs an engine step in
        parallel; the fleet clock advances to the slowest replica."""
        for i in list(self._pending_transfer):
            # deliver queued interconnect transfers: each receiver stalls
            # to its link's delivery time (queue wait + transfer included)
            self._flush_transfer(i)
        busy = [e for e in self.engines if not e.sched.idle]
        for e in busy:
            e.step()
        now = self.now
        for e in self.engines:
            if e.mem.now < now:
                e.mem.advance(now - e.mem.now)
        self.steps += 1
        return {"now_s": now, "busy_replicas": len(busy)}

    # -- event clock (DESIGN.md §12) -----------------------------------
    def _ensure_step(self, i: int, t: float) -> None:
        """Schedule a STEP event for replica ``i`` no earlier than its own
        clock — an idle replica's clock *jumps* to the arrival instant at
        the step (replicas advance independently)."""
        if self._step_pending.get(i):
            return
        self._step_pending[i] = True
        self._step_seq[i] = self._step_seq.get(i, 0) + 1
        when = max(self.engines[i].mem.now, t, self.events.last_time)
        self.events.push(Event(when, EventKind.STEP, i,
                               key=self._step_seq[i]))

    def _ev_arrival(self, ev: Event) -> None:
        prompt_tokens, max_new_tokens, session_key = \
            self._pending_arrivals.pop(ev.key)
        self._last_migrated = 0
        self._last_delivery_at = None
        self._route_time = ev.time
        replica = self.route(session_key, prompt_tokens)
        admit_after = (self._last_delivery_at
                       if self._last_delivery_at is not None else ev.time)
        local = self.engines[replica].submit(
            prompt_tokens, max_new_tokens,
            migrated_tokens=self._last_migrated,
            at=ev.time, admit_after=admit_after)
        self.requests[ev.key] = (replica, local)
        self._ensure_step(replica, max(ev.time, admit_after))

    def _schedule_decay(self, i: int) -> None:
        """Wall-clock retention decay (DESIGN.md §12): instead of per-step
        polling, an idle replica gets a RETENTION_DECAY event at the
        earliest leaf deadline — its clock jumps there and the cold sweep
        runs exactly on time. Already-due leaves sweep inline."""
        e = self.engines[i]
        due = e.kv.next_decay_due()
        if due is None:
            return
        if due <= e.mem.now:
            e.kv.maintain()
            due = e.kv.next_decay_due()
            if due is None or due <= e.mem.now:
                return  # nothing further can decay (e.g. spilled leaves)
        cur = self._decay_next.get(i)
        due = max(due + 1e-9, self.events.last_time)  # decay_due is strict >
        if cur is not None and cur <= due:
            return
        self._decay_next[i] = due
        self.events.push(Event(due, EventKind.RETENTION_DECAY, i))

    def _ev_decay(self, ev: Event) -> None:
        self._decay_next[ev.replica] = None
        e = self.engines[ev.replica]
        if not e.sched.idle:
            return  # busy replica: per-step maintain() already polls
        if e.mem.now < ev.time:
            e.mem.advance(ev.time - e.mem.now)
        e.kv.maintain()
        self._schedule_decay(ev.replica)

    def _ev_step(self, ev: Event) -> None:
        i = ev.replica
        self._step_pending[i] = False
        e = self.engines[i]
        if e.sched.idle:
            return
        if e.mem.now < ev.time:
            e.mem.advance(ev.time - e.mem.now)
        before = e.mem.now
        e.step()
        self.steps += 1
        if e.sched.idle:
            self._schedule_decay(i)
            return
        next_t = e.mem.now
        if next_t <= before + 1e-12:
            # the step did no work: everything queued admits in the
            # future (in-flight migration) — sleep to the earliest
            future = [r.admit_after for r in e.sched.queue
                      if r.admit_after > before]
            if not future:
                raise NonQuiescentError(
                    f"replica {i} stalled at t={before}: work queued but "
                    "no step progress and no future admission")
            next_t = min(future)
        self._ensure_step(i, next_t)

    def _ev_delivery(self, ev: Event) -> None:
        # pages were grafted (and metered) at migration time; the event
        # marks when the link actually frees. An otherwise-idle receiver
        # moves its clock to the delivery instant so later steps (and the
        # gated request's admission) start after the wire time.
        e = self.engines[ev.replica]
        if e.mem.now < ev.time:
            e.mem.advance(ev.time - e.mem.now)
        self._ensure_step(ev.replica, ev.time)

    def _ev_abandon(self, ev: Event) -> None:
        entry = self.requests.get(ev.key)
        if entry is None:
            return  # arrival never fired (cancelled before routing)
        replica, local = entry
        self.engines[replica].sched.abandon(local, ev.time)

    def _ev_push(self, ev: Event) -> None:
        """Execute (or re-defer) one speculative replication push. The
        event kind is the lowest priority, so at its timestamp every
        demand-side fabric reservation has already been made: a push that
        finds the path hot yields — retrying at the projected free
        instant, bounded by ``_PUSH_MAX_DEFERS`` — which is exactly how a
        demand migration preempts queued speculative work."""
        digest, key, target, defers = self._pending_pushes.pop(ev.key)
        matched, owners, _ = self.directory.lookup_entry(key)
        live = ([i for i in owners if i < len(self.engines)]
                if matched and owners else [])
        if not live or target in owners:
            # evicted fleet-wide, or the receiver became an owner on its
            # own (demand migration beat the push): nothing to do
            self._push_inflight.discard((digest, target))
            return
        donor = min(live, key=self._load_key)
        if self.fabric.hot(donor, target, ev.time):
            self.replications_deferred += 1
            if defers + 1 >= self._PUSH_MAX_DEFERS:
                self.pushes_abandoned += 1
                self._push_inflight.discard((digest, target))
                return
            free = self.fabric.free_at(donor, target, ev.time)
            self._push_seq += 1
            self._pending_pushes[self._push_seq] = (digest, key, target,
                                                    defers + 1)
            self.events.push(Event(free, EventKind.REPLICATION_PUSH, target,
                                   key=self._push_seq))
            return
        self._route_time = ev.time
        got = self._migrate(donor, target, key, speculative=True)
        self._push_inflight.discard((digest, target))
        if got == 0:
            self.pushes_abandoned += 1

    _EVENT_HANDLERS = {
        EventKind.ARRIVAL: _ev_arrival,
        EventKind.STEP: _ev_step,
        EventKind.MIGRATION_DELIVERY: _ev_delivery,
        EventKind.ABANDON: _ev_abandon,
        EventKind.RETENTION_DECAY: _ev_decay,
        EventKind.REPLICATION_PUSH: _ev_push,
    }

    def run_events(self, max_events: int = 1_000_000,
                   on_stall: str = "raise") -> dict:
        """Drain the event queue (event clock mode): replicas step on
        their own clocks, synchronizing only through the directory, the
        interconnect links and the fleet event queue."""
        for i, e in enumerate(self.engines):
            if e.sched.idle:
                self._schedule_decay(i)  # pre-existing trees decay on time
        processed = 0
        while self.events:
            if processed >= max_events:
                rep = self.report()
                if on_stall == "report":
                    return rep
                raise NonQuiescentError(
                    f"cluster not quiescent after {processed} events: "
                    f"{len(self.events)} pending", rep)
            ev = self.events.pop()
            self.trace.add(ev)
            self._EVENT_HANDLERS[ev.kind](self, ev)
            processed += 1
        return self.report()

    def run_until_idle(self, max_steps: int = 10000,
                       on_stall: str = "raise") -> dict:
        """Run to quiescence. Exhausting the budget with requests still
        queued raises :class:`NonQuiescentError` (default) or returns the
        report flagged ``quiesced=False`` (``on_stall="report"``) rather
        than returning a silently truncated run."""
        if self.clock_mode == "event":
            return self.run_events(max_events=max_steps, on_stall=on_stall)
        start = self.steps
        while not self.idle and self.steps - start < max_steps:
            self.step()
        rep = self.report()
        if not self.idle and on_stall != "report":
            raise NonQuiescentError(
                f"cluster not quiescent after {max_steps} steps: "
                f"{sum(len(e.sched.queue) + len(e.sched.active) for e in self.engines)}"
                " requests pending", rep)
        return rep

    # ------------------------------------------------------------------
    def report(self) -> dict:
        reps = [e.report() for e in self.engines]
        tokens = sum(r["tokens_generated"] for r in reps)
        energy = sum(r["memory"]["total_energy_j"] for r in reps)
        tiers: Dict[str, dict] = {}
        for r in reps:
            for name, t in r["memory"]["tiers"].items():
                agg = tiers.setdefault(name, {"capacity_gb": 0.0,
                                              "read_gb": 0.0, "write_gb": 0.0,
                                              "refresh_gb": 0.0,
                                              "energy_j": 0.0})
                for k in agg:
                    agg[k] += t[k]
        pressure: Dict[str, int] = {}
        for r in reps:
            for k, v in r["pressure"].items():
                pressure[k] = pressure.get(k, 0) + v
        records = [rec for e in self.engines for rec in e.sched.latency]
        return {
            "replicas": len(self.engines),
            "cluster_steps": self.steps,
            "clock_mode": self.clock_mode,
            "sim_time_s": self.now,
            "quiesced": self.idle,
            "pending_requests": sum(len(e.sched.queue) + len(e.sched.active)
                                    for e in self.engines),
            "abandoned": sum(e.sched.stats.abandoned for e in self.engines),
            "trace": self.trace.as_dict(),
            "finished": sum(r["finished"] for r in reps),
            "tokens_generated": tokens,
            "fleet_tokens_per_s": tokens / max(self.now, 1e-9),
            "energy_per_token_j": energy / max(tokens, 1),
            "tiers": tiers,
            "pressure": pressure,
            "dropped_allocs": sum(r["dropped_allocs"] for r in reps),
            "prefix_hits": sum(r["prefix_hits"] for r in reps),
            "prefix_hits_migrated": sum(e.kv.prefix_hits_migrated
                                        for e in self.engines),
            "prefix_tokens_reused": sum(r["prefix_tokens_reused"] for r in reps),
            "prefill_tokens_computed": sum(r["prefill_tokens_computed"]
                                           for r in reps),
            "prefill_tokens_skipped": sum(r["prefill_tokens_skipped"]
                                          for r in reps),
            "snapshot_bytes": sum(r["snapshot_bytes"] for r in reps),
            "radix_routed": self.radix_routed,
            "directory": {
                "entries": self.directory.n_entries(),
                "registrations": self.directory.registrations,
                "invalidations": self.directory.invalidations,
                "shards": self.directory.shards.shard_counters(),
            },
            "interconnect": {
                "gbps": self.interconnect_gbps,
                "migrations": self.migrations,
                "migrated_tokens": self.migrated_tokens,
                "migration_bytes": self.migration_bytes,
                "migration_s": self.migration_s,
                "queued_migrations": self.migrations_queued,
                "queue_wait_s": self.migration_queue_wait_s,
                "replications": self.replications,
                "replicated_tokens": self.replicated_tokens,
                "replication_bytes": self.replication_bytes,
                "replication_s": self.replication_s,
                "replications_deferred": self.replications_deferred,
                "pushes_abandoned": self.pushes_abandoned,
            },
            "fabric": self.fabric.report(),
            "latency": latency_percentiles(records),
            "per_replica": reps,
        }
