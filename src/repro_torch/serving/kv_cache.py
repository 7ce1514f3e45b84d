"""Paged KV-cache manager over the MRM pool.

PagedAttention-style block tables (the paper cites [21]) with pages sized to
MRM blocks: each session owns a list of pages; a page is `page_size` tokens
of per-layer KV (a multi-MB sequential unit — the paper's §2 access-grain
argument). Page *placement and lifetime* go through `repro_torch.core`:

- allocation -> MemorySystem.write_region with a DCM retention programmed
  from the session's expected remaining lifetime;
- every decode step reads all live pages sequentially (instrumented);
- each appended token accumulates into the open page; page-full -> sealed,
  and the open page region is rewritten (append-only write pattern);
- session end -> regions released (soft state dropped, per §4).

Shared prefixes live in a :class:`~repro_torch.serving.radix.RadixKVIndex`
(DESIGN.md §6): a token-level radix tree over page-aligned prefixes.
``match_prefix`` finds the longest page-aligned prefix a new prompt shares
with any published prompt; ``open_session`` attaches those pages
(refcounted, path pinned) so repeated prefixes cost zero KV writes and zero
extra MRM capacity; ``register_prefix`` publishes a finished prompt's
sealed leading pages into the tree.

**Sub-page tails** (DESIGN.md §9): a match may end mid-page. With
``tail_copy`` the up-to-``page_tokens - 1`` shared tokens past the
page-aligned boundary are *copied* out of the holder's page into the
borrower's own fresh open page — metered as a sequential read plus the
ordinary page write, strictly cheaper than recomputing those tokens under
the per-tier latency model (a recompute also streams the weights). The
engine decides when the copy is worthwhile (it needs a compute snapshot
whose history covers the tail); the manager owns the byte movement.

Retention is programmed from *observed reuse* (paper §4), with every
transition routed through one
:class:`~repro_torch.serving.retention_lifecycle.RetentionLifecycle` state
machine (DESIGN.md §9): promotion to ``hot_retention_s`` when a node's
hit count crosses ``hot_threshold`` (plus hot-tier placement when
configured), pressure-driven *demotion* back to session retention before
leaf eviction may reach a hot node, cold decay after ``cold_ttl_s``
(spill or drop), and retention re-programmed on cross-replica arrival.

Capacity pressure (paper §2.2/§4: the *system* manages retention, placement
and eviction of inference soft state): when the tier cannot serve an
allocation — or utilization crosses the high watermark — the manager
resolves it through an explicit policy chain instead of silently counting a
drop:

1. ``evict``     — leaf-LRU-evict radix nodes pinned only by the index
                   (frees capacity immediately);
2. ``spill``     — place the page in a configured colder tier instead;
3. ``recompute`` — drop the page as soft state; a later read re-materializes
                   it (recompute-on-demand), metered as recompute tokens.

Every failed allocation ends in exactly one recorded resolution; silent
``dropped_allocs`` only remain under the legacy ``policy="none"``.

The JAX compute path keeps its own dense ring caches (models/attention.py);
this manager is the memory control plane that decides *where those bytes
live* and meters the device traffic.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.simulator import MemorySystem
from repro_torch.serving.radix import PrefixMatch, RadixKVIndex, RadixNode
from repro_torch.serving.retention_lifecycle import LifecycleStats, RetentionLifecycle

PRESSURE_POLICIES = ("none", "evict-lru", "spill", "recompute")

# kept as an alias: the per-transition counters moved into the unified
# retention lifecycle (DESIGN.md §9) but the report/export surface is
# unchanged
RadixStats = LifecycleStats


@dataclass
class Page:
    page_id: int
    region_id: Optional[int]   # MemorySystem region (None = dropped/expired)
    n_tokens: int
    sealed: bool = False
    refcount: int = 1          # >1 when shared via the radix prefix index
    tier: str = ""             # where the page lives (spill may differ)
    dropped: bool = False      # soft state dropped; recompute on read
    compute_page: Optional[int] = None  # paged-plane pool id (DESIGN.md §10)


@dataclass
class SessionKV:
    session_id: int
    pages: List[Page] = field(default_factory=list)
    tokens: int = 0
    shared_prefix_pages: int = 0
    radix_node: Optional[RadixNode] = None  # pinned path in the prefix tree


@dataclass
class PressureStats:
    """Ledger of capacity-pressure events and their explicit resolutions.
    Invariant: events == evict + spill + recompute + unresolved."""
    events: int = 0
    resolved_evict: int = 0
    resolved_spill: int = 0
    resolved_recompute: int = 0
    unresolved: int = 0
    prefix_evictions: int = 0      # radix leaves evicted (incl. watermark)
    watermark_evictions: int = 0   # subset triggered proactively
    recompute_tokens: int = 0      # tokens re-materialized on later reads

    def as_dict(self) -> dict:
        return {
            "events": self.events,
            "resolved_evict": self.resolved_evict,
            "resolved_spill": self.resolved_spill,
            "resolved_recompute": self.resolved_recompute,
            "unresolved": self.unresolved,
            "prefix_evictions": self.prefix_evictions,
            "watermark_evictions": self.watermark_evictions,
            "recompute_tokens": self.recompute_tokens,
        }


class PagedKVManager:
    """The memory-plane half of KV: page allocation/retention/eviction
    over the MRM pool, with shared prefixes hanging off a
    :class:`RadixKVIndex`.

    Invariants the tests rely on:

    - **Pin-transfer-at-register** — a live session always pins exactly
      one radix path: ``open_session`` pins the matched node,
      ``register_prefix`` moves that pin to the deepest published node,
      ``close_session`` releases it. Consequence: unlocked leaves hold
      pages referenced by nothing but the tree, so leaf-LRU eviction
      frees capacity immediately and pinned paths are never evicted.
    - **Pressure-ledger balance** — every failed allocation is resolved
      exactly once: ``events == resolved_evict + resolved_spill +
      resolved_recompute + unresolved``, and ``unresolved == 0`` for
      every policy except the legacy ``"none"``.
    - **Token/refcount conservation** — a page's refcount equals the
      number of live sessions holding it plus one if the tree holds it;
      regions are released exactly when the refcount reaches zero.
    - **Directory ownership lifecycle** — ``on_prefix_insert`` fires for
      every published/adopted path and ``on_prefix_evict`` fires with the
      exact run an evicted leaf covered (pressure, watermark and cold
      decay alike), so a fleet directory mirrors tree membership.
    - **Tail copies never alias** — a sub-page tail is copied into a page
      the borrower *owns* (refcount 1, unsealed); the holder's page is
      read once (metered) and never shared mid-page, so page refcounts
      stay whole-page by construction.
    """

    def __init__(self, cfg: ModelConfig, mem: MemorySystem, tier: str,
                 page_tokens: int = 128,
                 expected_session_s: float = 600.0,
                 spill_tier: Optional[str] = None,
                 policy: str = "none",
                 high_watermark: Optional[float] = None,
                 hot_threshold: int = 4,
                 hot_retention_s: float = 3600.0,
                 hot_tier: Optional[str] = None,
                 cold_ttl_s: Optional[float] = None,
                 tail_copy: bool = False,
                 demote_on_pressure: bool = False,
                 state_bytes_page: float = 0.0):
        if policy not in PRESSURE_POLICIES:
            raise ValueError(f"policy {policy!r} not in {PRESSURE_POLICIES}")
        if policy == "spill" and spill_tier is None:
            raise ValueError("policy 'spill' requires spill_tier")
        self.cfg = cfg
        self.mem = mem
        self.tier = tier
        self.page_tokens = page_tokens
        self.expected_session_s = expected_session_s
        self.spill_tier = spill_tier
        self.policy = policy
        self.high_watermark = high_watermark
        self.tail_copy = tail_copy
        self.kv_bytes_token = cfg.kv_bytes_per_token()
        # paged point stacks (DESIGN.md §10) pin one recurrent-state
        # snapshot per page alongside the KV token stream, so every page
        # region is sized (and its writes metered) with those bytes. Zero
        # on the ring path — there state lives in the engine's metered
        # SnapshotHandle regions and would be double-counted here.
        self.state_bytes_page = float(state_bytes_page)
        self.page_bytes = (self.kv_bytes_token * page_tokens
                           + self.state_bytes_page)
        # every retention transition — promote, demote, decay, arrival —
        # goes through the one lifecycle state machine (DESIGN.md §9)
        self.lifecycle = RetentionLifecycle(
            mem, tier=tier, kv_bytes_token=self.kv_bytes_token,
            session_retention_s=expected_session_s,
            hot_retention_s=hot_retention_s, hot_threshold=hot_threshold,
            hot_tier=hot_tier, cold_ttl_s=cold_ttl_s, spill_tier=spill_tier,
            demote_on_pressure=demote_on_pressure)
        self.sessions: Dict[int, SessionKV] = {}
        self._next_page = 0
        self.dropped_allocs = 0            # legacy: truly-silent drops only
        self.pressure = PressureStats()
        # the one prefix abstraction every serving layer shares: a radix
        # tree over page-aligned prefixes (replaces the flat whole-prompt
        # sha1 index — partial prefixes now match)
        self.radix = RadixKVIndex(page_tokens)
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.prefix_hits_migrated = 0      # hits landing on a grafted path
        self.tail_hits = 0                 # sessions that copied a tail
        self.tail_tokens_copied = 0        # sub-page tokens copied, total
        self.tail_copy_bytes = 0.0         # bus bytes moved (read + write)
        # fleet-directory hooks (ClusterFrontend wires these): fired with
        # the full position-space token path on publish, and with
        # (full_path, tail_tokens) when a leaf leaves the tree
        self.on_prefix_insert: Optional[Callable[[Sequence], None]] = None
        self.on_prefix_evict: Optional[Callable[[tuple, int], None]] = None
        # paged-compute-plane hooks (ServeEngine wires these when the
        # kernel runs in place on the pages, DESIGN.md §10): alloc fires
        # for every Page this manager creates so the backend can bind a
        # pool page; release fires exactly when the refcount hits zero
        self.on_page_alloc: Optional[Callable[[Page], None]] = None
        self.on_page_release: Optional[Callable[[Page], None]] = None
        self._last_adopt_pages: List[Page] = []  # adopt_prefix's new pages

    # -- prefix tree ---------------------------------------------------
    @property
    def radix_stats(self) -> LifecycleStats:
        """Retention-transition counters (kept under the historical name;
        the transitions themselves live in the lifecycle, DESIGN.md §9)."""
        return self.lifecycle.stats

    def match_prefix(self, tokens: Sequence,
                     max_tokens: Optional[int] = None) -> PrefixMatch:
        """Longest page-aligned prefix of `tokens` present in the tree —
        plus, with ``tail_copy``, the sub-page tail beyond it. Bumps hit
        counts and promotes nodes whose observed reuse crossed the
        lifecycle's ``hot_threshold`` (reuse -> retention programming).
        The match is not yet pinned — pass it to :meth:`open_session` to
        attach it."""
        m = self.radix.match(tokens, self.mem.now, max_tokens=max_tokens,
                             with_tail=self.tail_copy)
        if m.tokens:
            self.lifecycle.observe_reuse(m.node)
        return m

    def tail_available(self, match: PrefixMatch) -> int:
        """Sub-page tail tokens the memory plane can actually serve for
        this match: the holder's page must be resident (not dropped, live
        region — unless the stack has no KV byte stream at all). The
        engine combines this with compute-side validity (a snapshot whose
        history covers the tail) before asking for the copy."""
        if (not self.tail_copy or match is None or match.tail_node is None
                or match.tokens == 0 or not match.tail_node.pages):
            return 0
        page = match.tail_node.pages[0]
        if page.dropped:
            return 0
        if page.region_id is None and self.kv_bytes_token > 0:
            return 0
        return match.tail_tokens

    def match_len(self, tokens: Sequence,
                  max_tokens: Optional[int] = None) -> int:
        """Side-effect-free match length (scheduler / router scoring)."""
        return self.radix.match_len(tokens, max_tokens=max_tokens)

    def open_session(self, session_id: int,
                     match: Optional[PrefixMatch] = None,
                     tail_tokens: int = 0) -> SessionKV:
        """Open a session; when a :class:`PrefixMatch` is supplied its
        pages are attached (refcounted) and the matched path is pinned, so
        the shared tokens cost no new KV writes and can never be evicted
        under this session. ``tail_tokens`` (<= ``match.tail_tokens``,
        engine-vetted via :meth:`tail_available`) additionally copies the
        sub-page tail out of the holder's page into a fresh page the
        session owns (DESIGN.md §9)."""
        s = SessionKV(session_id)
        self.sessions[session_id] = s
        if match is not None and match.tokens:
            for page in match.pages:
                page.refcount += 1
                s.pages.append(page)
                s.tokens += page.n_tokens
            s.shared_prefix_pages = len(match.pages)
            s.radix_node = match.node
            self.radix.lock(match.node)
            self.prefix_hits += 1
            self.prefix_tokens_reused += s.tokens
            node = match.node
            while node is not None:
                if node.migrated:   # the hit landed on cross-replica data
                    self.prefix_hits_migrated += 1
                    break
                node = node.parent
            if tail_tokens:
                self._copy_tail(s, match, tail_tokens)
        return s

    def _copy_tail(self, s: SessionKV, match: PrefixMatch,
                   tail_tokens: int) -> None:
        """Sub-page tail reuse: read ``tail_tokens`` of KV out of the
        holder's page (metered, sequential — the read happens *before*
        any allocation so pressure eviction cannot invalidate it) and
        write them into a fresh open page the borrower owns. Metered as a
        read + write; cheaper than recompute under the per-tier latency
        model because recompute would also stream the weights."""
        nbytes = tail_tokens * self.kv_bytes_token
        page = match.tail_node.pages[0]
        if page.region_id is not None and nbytes > 0:
            self.mem.read_region(page.region_id, nbytes, sequential=True)
        self._new_page(s, tail_tokens)    # the borrower's own open page
        s.tokens += tail_tokens
        self.tail_hits += 1
        self.tail_tokens_copied += tail_tokens
        self.tail_copy_bytes += 2.0 * nbytes
        self.prefix_tokens_reused += tail_tokens

    def register_prefix(self, session_id: int, tokens: Sequence,
                        payload: Any = None) -> int:
        """Publish this session's sealed leading pages into the radix tree
        under the token path (call after the prompt's KV is appended).
        ``tokens[i*page_tokens:(i+1)*page_tokens]`` must be what the i-th
        page covers. The session's pin moves to the deepest node so its
        freshly published prefix cannot be evicted under it. ``payload``
        may be the compute handle itself or a zero-arg factory for one
        (resolved only if the deepest node's payload slot is free — the
        engine's snapshots carry metered regions that must not be written
        for nothing). Returns the number of newly inserted pages."""
        s = self.sessions[session_id]
        run: List[Page] = []
        for p in s.pages:
            if p.sealed and not p.dropped:
                run.append(p)
            else:
                break
        n = min(len(run), len(tokens) // self.page_tokens)
        if n == 0:
            if not callable(payload):
                self._release_payload_obj(payload)
            return 0
        _, inserted, node = self.radix.insert(
            tokens[:n * self.page_tokens], run[:n], self.mem.now)
        if payload is not None and node is not self.radix.root \
                and node.payload is None:
            # a callable payload is a factory: resolved only when the node
            # actually takes it, so a metered snapshot region is never
            # written just to be released (occupied payload slot)
            obj = payload() if callable(payload) else payload
            if obj is not None:
                node.payload = obj
        elif not callable(payload):
            self._release_payload_obj(payload)
        for p in inserted:
            p.refcount += 1  # the tree holds its own reference
        if node is not self.radix.root:
            self.radix.lock(node)
            if s.radix_node is not None:
                self.radix.unlock(s.radix_node)
            s.radix_node = node
            self._notify_insert(tokens[:n * self.page_tokens])
        return len(inserted)

    def adopt_prefix(self, tokens: Sequence, hot: bool = False,
                     hits: int = 0) -> Tuple[int, int, Optional[RadixNode]]:
        """Adopt a foreign page-aligned prefix (cross-replica migration):
        allocate backing regions on *this* replica — metered writes into
        the hot tier with long retention when the donor observed the
        prefix hot (retention re-programmed on arrival), else the KV tier
        at session retention — and graft the path into the radix tree,
        tree-owned (refcount 1). Allocation failures fall back to leaf-LRU
        eviction and then truncate the adoption at a page boundary, so the
        ledger never records an unresolved event for an optional transfer.
        Returns ``(new_tokens, total_tokens, node)``: tokens newly backed
        here, total matched+adopted tokens, and the deepest node."""
        pt = self.page_tokens
        self._last_adopt_pages = []
        n = (len(tokens) // pt) * pt
        if n == 0:
            return 0, 0, None
        # match (not match_len): splits at the boundary so the duplicate
        # path can be *pinned* while we allocate — the eviction fallback
        # below must never free the very prefix the graft extends. No hit
        # bump: the arrival itself is not reuse (the first borrower's
        # open_session is)
        m = self.radix.match(tokens[:n], self.mem.now, bump_hits=False)
        dup = m.tokens
        self.radix.lock(m.node)
        # retention re-programmed on arrival: one decision point for the
        # whole fleet (the lifecycle, DESIGN.md §9)
        tier, life = self.lifecycle.arrival(hot)
        new_pages: List[Page] = []
        try:
            for _start in range(dup, n, pt):
                nbytes = pt * self.kv_bytes_token + self.state_bytes_page
                rid = self.mem.write_region(tier, "prefix:adopt", nbytes,
                                            expected_lifetime_s=life)
                used = tier
                if rid is None and tier != self.tier:
                    rid = self.mem.write_region(self.tier, "prefix:adopt",
                                                nbytes,
                                                expected_lifetime_s=life)
                    used = self.tier
                if rid is None and self.policy in ("evict-lru", "spill"):
                    # only policies that allow eviction may displace local
                    # prefixes for an inbound transfer; 'none'/'recompute'
                    # truncate instead (the transfer is optional). The
                    # arrival retention survives this path too.
                    rid = self._evict_and_retry("prefix:adopt", nbytes,
                                                lifetime_s=life)
                    used = self.tier
                if rid is None:
                    break        # page-aligned partial adoption
                p = Page(self._next_page, rid, pt, sealed=True, refcount=0,
                         tier=used)
                self._next_page += 1
                if self.on_page_alloc is not None:
                    self.on_page_alloc(p)
                new_pages.append(p)
        finally:
            self.radix.unlock(m.node)
        total = dup + len(new_pages) * pt
        if total == 0:
            return 0, 0, None
        pages_full: List[Optional[Page]] = [None] * (dup // pt) + new_pages
        dup2, inserted, node = self.radix.graft(
            tokens[:total], pages_full, self.mem.now, hits=hits, hot=hot)
        assert dup2 == dup, "graft walk disagrees with match_len"
        for p in inserted:
            p.refcount += 1    # the tree holds its own reference
        self._last_adopt_pages = list(inserted)
        self.lifecycle.note_adoption(len(inserted), len(inserted) * pt)
        if node is not self.radix.root:
            self._notify_insert(tokens[:total])
        return len(inserted) * pt, total, (None if node is self.radix.root
                                           else node)

    # -- fleet-directory notification ----------------------------------
    def _notify_insert(self, tokens: Sequence) -> None:
        if self.on_prefix_insert is not None:
            self.on_prefix_insert(tokens)

    @staticmethod
    def _release_payload_obj(payload: Any) -> None:
        """Compute-plane payloads may carry a metered backing region (the
        engine's SnapshotHandle); release it when the payload dies."""
        if payload is not None and hasattr(payload, "release"):
            payload.release()

    def _on_leaf_removed(self, victim: RadixNode) -> None:
        """A leaf left the tree (pressure eviction or cold decay): release
        its metered compute snapshot and invalidate fleet-directory
        ownership of the token run it covered."""
        self._release_payload_obj(victim.payload)
        victim.payload = None
        if self.on_prefix_evict is not None and victim.evicted_path is not None:
            self.on_prefix_evict(victim.evicted_path, victim.n_tokens)

    # -- reuse -> retention programming (via the lifecycle) ------------
    def maintain(self) -> None:
        """Cold-leaf decay (call once per engine step): unlocked leaves
        the lifecycle judges cold are demoted — spilled to the colder
        tier when one is configured, else dropped from the tree (soft
        state; an identical future prompt recomputes)."""
        if self.lifecycle.cold_ttl_s is None:
            return
        now = self.mem.now
        for leaf in self.radix.evictable_leaves():
            if not self.lifecycle.decay_due(leaf, now):
                continue
            if self.spill_tier and self.spill_tier != self.tier:
                self.lifecycle.spill_cold(leaf, now)
            elif self.radix.pop_leaf(leaf) is not None:
                self._on_leaf_removed(leaf)
                for page in leaf.pages:
                    self._unref_page(page)
                self.lifecycle.note_decay()

    def next_decay_due(self) -> Optional[float]:
        """Earliest wall-clock time any evictable leaf becomes decay-due
        (None when decay is off or nothing can decay). The event-driven
        clock (DESIGN.md §12) schedules a RETENTION_DECAY event at this
        instant instead of polling :meth:`maintain` every step — an idle
        replica whose clock jumps between arrivals still decays on time."""
        if self.lifecycle.cold_ttl_s is None:
            return None
        deadlines = [self.lifecycle.decay_deadline(leaf)
                     for leaf in self.radix.evictable_leaves()]
        deadlines = [d for d in deadlines if d is not None]
        return min(deadlines) if deadlines else None

    # -- capacity pressure ---------------------------------------------
    def _unref_page(self, page: Page) -> None:
        page.refcount -= 1
        if page.refcount <= 0:
            if page.region_id is not None:
                self.mem.release_region(page.region_id)
                page.region_id = None
            # fired once, region or not: a dropped page still holds a
            # compute-plane pool page the backend must reclaim
            if self.on_page_release is not None:
                self.on_page_release(page)

    def _evict_one_prefix_leaf(self) -> bool:
        """Leaf-LRU eviction: unlocked leaves hold pages pinned only by
        the tree (live sessions pin their paths), so evicting one frees
        capacity immediately. With ``demote_on_pressure`` the lifecycle
        interposes: cold leaves go first, and a hot leaf is *demoted*
        (retention reprogram metered, hits reset) before eviction may
        reach it — returning True without freeing counts as progress, the
        retry loop comes back and finds the leaf an ordinary candidate."""
        victims = self.radix.evictable_leaves()
        if not victims:
            return False
        if self.lifecycle.demote_on_pressure:
            cold = [v for v in victims if not v.hot]
            if not cold:
                if self.lifecycle.demote(min(victims,
                                             key=self.radix.lru_key)):
                    return True
            else:
                victims = cold   # cold leaves shield hot ones
        victim = self.radix.pop_leaf(min(victims, key=self.radix.lru_key))
        if victim is None:
            return False
        self._on_leaf_removed(victim)
        for page in victim.pages:
            self._unref_page(page)
        self.pressure.prefix_evictions += 1
        return True

    def _alloc(self, owner: str, nbytes: float, tier: str,
               lifetime_s: Optional[float] = None) -> Optional[int]:
        return self.mem.write_region(
            tier, owner, nbytes,
            expected_lifetime_s=(self.expected_session_s if lifetime_s is None
                                 else lifetime_s))

    def _evict_and_retry(self, owner: str, nbytes: float,
                         lifetime_s: Optional[float] = None) -> Optional[int]:
        while self._evict_one_prefix_leaf():
            rid = self._alloc(owner, nbytes, self.tier, lifetime_s=lifetime_s)
            if rid is not None:
                return rid
        return None

    def _resolve_pressure(self, owner: str, nbytes: float):
        """Allocation failed: decide what gives. Returns (region_id, tier,
        dropped) with the resolution recorded — never a silent drop unless
        the legacy policy 'none' is selected."""
        self.pressure.events += 1
        if self.policy == "none":
            self.pressure.unresolved += 1
            self.dropped_allocs += 1
            return None, self.tier, False
        if self.policy in ("evict-lru", "spill"):
            rid = self._evict_and_retry(owner, nbytes)
            if rid is not None:
                self.pressure.resolved_evict += 1
                return rid, self.tier, False
        if self.policy == "spill":
            rid = self._alloc(owner, nbytes, self.spill_tier)
            if rid is not None:
                self.pressure.resolved_spill += 1
                return rid, self.spill_tier, False
        # drop-and-recompute: the page's KV is soft state — admit the page
        # with no backing region; a later read re-materializes it
        self.pressure.resolved_recompute += 1
        return None, self.tier, True

    def _check_watermark(self) -> None:
        if self.high_watermark is None or self.policy == "none":
            return
        while self.mem.utilization(self.tier) > self.high_watermark:
            before = self.pressure.prefix_evictions
            if not self._evict_one_prefix_leaf():
                return
            # a demote-progress round frees nothing and is not an
            # eviction — only count rounds that actually popped a leaf
            if self.pressure.prefix_evictions > before:
                self.pressure.watermark_evictions += 1

    # ------------------------------------------------------------------
    def _new_page(self, s: SessionKV, n_tokens: int) -> Page:
        self._check_watermark()
        owner = f"session:{s.session_id}"
        nbytes = n_tokens * self.kv_bytes_token + self.state_bytes_page
        tier, dropped = self.tier, False
        rid = self._alloc(owner, nbytes, self.tier)
        if rid is None:
            rid, tier, dropped = self._resolve_pressure(owner, nbytes)
        p = Page(self._next_page, rid, n_tokens, tier=tier, dropped=dropped,
                 sealed=n_tokens >= self.page_tokens)
        self._next_page += 1
        if self.on_page_alloc is not None:
            self.on_page_alloc(p)
        s.pages.append(p)
        return p

    def append_tokens(self, session_id: int, n: int) -> None:
        """Append n tokens' KV (prefill: n large; decode: n=1)."""
        s = self.sessions[session_id]
        while n > 0:
            if s.pages and not s.pages[-1].sealed:
                page = s.pages[-1]
                take = min(n, self.page_tokens - page.n_tokens)
                if take > 0:
                    # append-only rewrite of the open page region
                    if page.region_id is not None:
                        self.mem.devices[page.tier].write(
                            take * self.kv_bytes_token,
                            expected_lifetime_s=self.expected_session_s)
                    page.n_tokens += take
                    s.tokens += take
                    n -= take
                if page.n_tokens >= self.page_tokens:
                    page.sealed = True
                continue
            take = min(n, self.page_tokens)
            self._new_page(s, take)
            s.tokens += take
            n -= take

    def _rematerialize(self, s: SessionKV, page: Page) -> None:
        """A dropped page was read: recompute its KV (metered) and try to
        write it back; if the tier is still full it stays dropped and will
        be recomputed again next read. This is *not* a new pressure event —
        it services the recompute resolution already recorded when the page
        was dropped, so only recompute_tokens accrues here."""
        self.pressure.recompute_tokens += page.n_tokens
        owner = f"session:{s.session_id}"
        nbytes = page.n_tokens * self.kv_bytes_token + self.state_bytes_page
        tier = page.tier
        rid = self._alloc(owner, nbytes, tier)
        if rid is None and self.policy in ("evict-lru", "spill"):
            rid = self._evict_and_retry(owner, nbytes)
        if rid is None and self.policy == "spill":
            rid = self._alloc(owner, nbytes, self.spill_tier)
            tier = self.spill_tier
        if rid is not None:
            page.region_id = rid
            page.tier = tier
            page.dropped = False

    def read_all(self, session_id: int) -> float:
        """One decode step reads the whole cache sequentially (paper §2.2).
        Returns bytes read (recomputed pages included once re-materialized)."""
        s = self.sessions[session_id]
        total = 0.0
        for page in s.pages:
            if page.dropped:
                self._rematerialize(s, page)
            if page.region_id is not None:
                self.mem.read_region(page.region_id,
                                     page.n_tokens * self.kv_bytes_token,
                                     sequential=True)
                total += page.n_tokens * self.kv_bytes_token
        return total

    def read_pages(self, session_id: int, page_bytes: Sequence[float]) -> float:
        """Meter the paged kernel's actual per-page read stream
        (DESIGN.md §10): ``page_bytes[i]`` is the byte count the kernel's
        DMA pulled from the session's i-th page this step — computed by
        the engine from the layer stack and each layer's window, so tier
        traffic is charged for exactly what the gather touched (zero for
        pages outside every window) instead of a synthetic whole-cache
        read. Dropped pages the kernel touched are re-materialized first.
        Returns total bytes metered."""
        s = self.sessions[session_id]
        total = 0.0
        for page, nbytes in zip(s.pages, page_bytes):
            if nbytes <= 0:
                continue
            if page.dropped:
                self._rematerialize(s, page)
            if page.region_id is not None:
                self.mem.read_region(page.region_id, nbytes, sequential=True)
                total += nbytes
        return total

    def close_session(self, session_id: int) -> None:
        s = self.sessions.pop(session_id, None)
        if s is None:
            return
        if s.radix_node is not None:
            self.radix.unlock(s.radix_node)
        for page in s.pages:
            self._unref_page(page)

    def evict_prefixes(self, max_n: Optional[int] = None) -> int:
        """Capacity/retention policy hook: leaf-LRU-evict up to ``max_n``
        unlocked radix leaves (all of them when None). Returns the count."""
        n = 0
        while (max_n is None or n < max_n) and self._evict_one_prefix_leaf():
            n += 1
        return n

    # ------------------------------------------------------------------
    def live_pages(self) -> int:
        return sum(len(s.pages) for s in self.sessions.values())

    def live_kv_bytes(self) -> float:
        """Bytes of KV the live sessions pin. (Reporting/diagnostics; the
        cluster router's load tiebreak reads the tier's allocator
        utilization, which counts these pages physically.)"""
        return sum(s.tokens for s in self.sessions.values()) * self.kv_bytes_token

    def radix_kv_bytes(self) -> float:
        """Bytes of KV resident in the radix prefix tree (directory-owned
        hot prefixes included) — a prefix_report figure. The cluster
        router does not walk the tree: its tiebreak reads the tier's
        allocator utilization, which already counts these pages."""
        return sum(p.n_tokens for node in self.radix.nodes()
                   for p in node.pages) * self.kv_bytes_token

    def live_tokens(self) -> int:
        return sum(s.tokens for s in self.sessions.values())

    def pressure_report(self) -> dict:
        rep = self.pressure.as_dict()
        rep["dropped_allocs"] = self.dropped_allocs
        return rep

    def prefix_report(self) -> dict:
        rep = {
            "hits": self.prefix_hits,
            "hits_migrated": self.prefix_hits_migrated,
            "tokens_reused": self.prefix_tokens_reused,
            "tail_hits": self.tail_hits,
            "tail_tokens_copied": self.tail_tokens_copied,
            "tail_copy_bytes": self.tail_copy_bytes,
            "radix_nodes": self.radix.n_nodes(),
            "radix_tokens": self.radix.total_tokens(),
            "radix_pages": self.radix.total_pages(),
            "radix_kv_bytes": self.radix_kv_bytes(),
            "evictions": self.pressure.prefix_evictions,
        }
        rep.update(self.lifecycle.stats.as_dict())
        return rep
