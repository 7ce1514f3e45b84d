"""One retention state machine for every KV-prefix lifecycle transition.

The paper's §4 argument is that the *system* — not the device — should
program retention from what it observes about the data. Before this
module, the transitions were scattered: promotion lived in
``PagedKVManager._maybe_promote``, cold decay in ``maintain``, and the
cross-replica arrival programming inline in ``adopt_prefix`` — so DCM
reprogram traffic was metered in three places and the rules could not be
tested in isolation. Every retention transition now routes through
:class:`RetentionLifecycle` (DESIGN.md §9), shared by ``kv_cache.py``,
``radix.py`` callers, ``engine.py`` and the migration arrival path in
``cluster.py``.

State machine (per radix node; ``node.hot`` is the state bit)::

            observe_reuse (hits >= hot_threshold)
    SHORT ------------------------------------------> HOT
      ^                                                |
      |   demote (eviction pressure, unlocked only)    |
      +------------------------------------------------+
      |
      | decay_due (idle > cold_ttl_s)      spill/evict
      +----------------------------------> gone (soft state; recompute)

- **SHORT** — pages programmed at the session's expected lifetime.
- **HOT** — observed reuse crossed ``hot_threshold``: pages re-programmed
  to ``hot_retention_s`` (a DCM retention change is a block rewrite,
  metered as refresh traffic) and, when a hot tier is configured,
  migrated there.
- **demote** — new with this module: under sustained eviction pressure a
  hot node is demoted back to short retention *before* leaf eviction
  reaches it — the reprogram is metered, the hits reset (the node must
  re-earn promotion), and only then does it become an ordinary eviction
  candidate. Pinned (locked) nodes are never demoted: a live session's
  path is not reprogrammable out from under it.
- **decay** — unlocked leaves idle past ``cold_ttl_s`` are spilled to the
  colder tier when one is configured, else dropped (an identical future
  prompt recomputes).
- **arrival** — a cross-replica migration re-programs retention on the
  receiving replica: donor-hot prefixes land in the hot tier at
  ``hot_retention_s``, cold ones at session retention.

The lifecycle owns page *retention and placement*; tree structure
(insert/evict/pin) stays with ``RadixKVIndex`` and page/refcount
lifetime with ``PagedKVManager``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core.simulator import MemorySystem


@dataclass
class LifecycleStats:
    """Ledger of every retention transition (one metering point)."""
    retention_promotions: int = 0  # nodes SHORT -> HOT
    promoted_pages: int = 0        # pages re-programmed in place
    migrated_pages: int = 0        # pages moved into the hot tier
    retention_demotions: int = 0   # nodes HOT -> SHORT under pressure
    demoted_pages: int = 0         # pages re-programmed back down
    cold_decays: int = 0           # cold leaves dropped after cold_ttl_s
    cold_spilled_pages: int = 0    # cold pages demoted to the spill tier
    adopted_pages: int = 0         # pages grafted from another replica
    adopted_tokens: int = 0        # tokens those pages cover
    arrivals_hot: int = 0          # migrations programmed hot on arrival
    arrivals_short: int = 0        # migrations programmed at session life
    scrubbed_pages: int = 0        # scrub-on-read corrections (DESIGN.md §11)

    def as_dict(self) -> dict:
        return {
            "retention_promotions": self.retention_promotions,
            "promoted_pages": self.promoted_pages,
            "migrated_pages": self.migrated_pages,
            "retention_demotions": self.retention_demotions,
            "demoted_pages": self.demoted_pages,
            "cold_decays": self.cold_decays,
            "cold_spilled_pages": self.cold_spilled_pages,
            "adopted_pages": self.adopted_pages,
            "adopted_tokens": self.adopted_tokens,
            "arrivals_hot": self.arrivals_hot,
            "arrivals_short": self.arrivals_short,
            "scrubbed_pages": self.scrubbed_pages,
        }


class RetentionLifecycle:
    """Promote / demote / decay / arrival programming for prefix KV.

    Invariants the tests rely on:

    - **Single metering point** — every DCM retention reprogram (promote,
      demote, arrival) goes through this class, so refresh-traffic
      accounting cannot diverge between call sites.
    - **Pinned paths are never demoted** — :meth:`demote` refuses nodes
      with ``lock_ref > 0``; a live session's retention cannot be
      shortened out from under it.
    - **Demote precedes eviction** — with ``demote_on_pressure``, the
      manager's eviction loop offers every hot leaf to :meth:`demote`
      before it may be popped; a hot node therefore always passes
      through SHORT (reprogram metered) before leaving the tree under
      pressure.
    - **Hits reset on demotion** — a demoted node must re-cross
      ``hot_threshold`` to be promoted again (no promote/demote
      flapping from a single stale hit count).
    """

    def __init__(self, mem: MemorySystem, *, tier: str,
                 kv_bytes_token: float,
                 session_retention_s: float,
                 hot_retention_s: float,
                 hot_threshold: int,
                 hot_tier: Optional[str] = None,
                 cold_ttl_s: Optional[float] = None,
                 spill_tier: Optional[str] = None,
                 demote_on_pressure: bool = False):
        self.mem = mem
        self.tier = tier
        self.kv_bytes_token = kv_bytes_token
        self.session_retention_s = session_retention_s
        self.hot_retention_s = hot_retention_s
        self.hot_threshold = hot_threshold
        self.hot_tier = hot_tier
        self.cold_ttl_s = cold_ttl_s
        self.spill_tier = spill_tier
        self.demote_on_pressure = demote_on_pressure
        self.stats = LifecycleStats()

    # -- the one metered reprogram primitive ---------------------------
    def _reprogram(self, page, retention_s: float) -> bool:
        """Re-program a page region's DCM retention in place. A retention
        change is a block rewrite — metered as reprogram/refresh traffic,
        not steady writes (paper §4)."""
        if page.region_id is None:
            return False
        r = self.mem.tracker.get(page.region_id)
        if r is None:
            return False
        nbytes = page.n_tokens * self.kv_bytes_token
        op = self.mem.devices[page.tier].write(
            nbytes, expected_lifetime_s=retention_s, refresh=True)
        self.mem.tracker.rearm(r, self.mem.now, retention_s=op.retention_s)
        return True

    # -- scrub-on-read (reliability plane, DESIGN.md §11) ---------------
    def scrub(self, page) -> bool:
        """Correct a page whose age-driven raw error count crossed the
        scrub threshold. Invariant (scrub-charged-as-refresh): the
        corrective rewrite is metered exactly like a scheduled refresh —
        refresh bytes + check bits + in-place wear — and the retention
        clock re-arms, so scrub and refresh traffic share one budget and
        a scrubbed page skips its next refresh deadline. This is the
        *only* entry point for scrub metering in the serving layer, same
        single-metering-point rule as :meth:`_reprogram`."""
        if page.region_id is None:
            return False
        if self.mem.scrub_region(page.region_id):
            self.stats.scrubbed_pages += 1
            return True
        return False

    # -- SHORT -> HOT ---------------------------------------------------
    def observe_reuse(self, node) -> None:
        """Walk the matched path; promote nodes whose observed hit count
        crossed ``hot_threshold`` (reuse -> retention programming)."""
        while node is not None and node.parent is not None:
            if not node.hot and node.hits >= self.hot_threshold:
                self.promote(node)
            node = node.parent

    def promote(self, node) -> None:
        """SHORT -> HOT: long-retention DCM programming for every page,
        and placement in the hot tier when one is configured."""
        node.hot = True
        self.stats.retention_promotions += 1
        for page in node.pages:
            self._promote_page(page)

    def _promote_page(self, page) -> None:
        if page.region_id is None:
            return
        nbytes = page.n_tokens * self.kv_bytes_token
        if self.hot_tier and page.tier != self.hot_tier:
            rid = self.mem.write_region(self.hot_tier, "prefix:hot", nbytes,
                                        expected_lifetime_s=self.hot_retention_s)
            if rid is not None:
                self.mem.read_region(page.region_id, nbytes)  # migration read
                self.mem.release_region(page.region_id)
                page.region_id = rid
                page.tier = self.hot_tier
                self.stats.migrated_pages += 1
                return
        if self._reprogram(page, self.hot_retention_s):
            self.stats.promoted_pages += 1

    # -- HOT -> SHORT (pressure) ----------------------------------------
    def demote(self, node) -> bool:
        """HOT -> SHORT under eviction pressure: re-program the node's
        pages back to session retention (metered) and reset its hit count
        so promotion must be re-earned. Refuses pinned (locked) nodes and
        nodes that are not hot; pages stay in their current tier —
        migrating them back to the base tier would consume exactly the
        capacity the pressure is trying to free (they follow on natural
        churn). Returns True when the node was demoted."""
        if not self.demote_on_pressure or not node.hot or node.lock_ref > 0:
            return False
        node.hot = False
        node.hits = 0
        self.stats.retention_demotions += 1
        for page in node.pages:
            if self._reprogram(page, self.session_retention_s):
                self.stats.demoted_pages += 1
        return True

    # -- SHORT -> gone (cold decay) -------------------------------------
    def decay_due(self, node, now: float) -> bool:
        """An unlocked leaf idle past ``cold_ttl_s`` should decay."""
        if self.cold_ttl_s is None:
            return False
        return now - node.last_access > self.cold_ttl_s

    def decay_deadline(self, node) -> Optional[float]:
        """Wall-clock instant this node becomes decay-due — the
        event-driven clock schedules a RETENTION_DECAY event here instead
        of polling :meth:`decay_due` every step (DESIGN.md §12)."""
        if self.cold_ttl_s is None:
            return None
        return node.last_access + self.cold_ttl_s

    def spill_cold(self, node, now: float) -> int:
        """Cold demotion to the spill tier: move every page that is not
        already there (migration read + colder write, session retention).
        Returns pages moved; stamps the node so it does not re-trigger
        next step."""
        moved = 0
        for page in node.pages:
            if page.region_id is None or page.tier == self.spill_tier:
                continue
            nbytes = page.n_tokens * self.kv_bytes_token
            rid = self.mem.write_region(
                self.spill_tier, "prefix:cold", nbytes,
                expected_lifetime_s=self.session_retention_s)
            if rid is None:
                continue
            self.mem.read_region(page.region_id, nbytes)  # migration read
            self.mem.release_region(page.region_id)
            page.region_id = rid
            page.tier = self.spill_tier
            moved += 1
        if moved:
            self.stats.cold_spilled_pages += moved
            node.last_access = now
        return moved

    def note_decay(self) -> None:
        self.stats.cold_decays += 1

    # -- cross-replica arrival ------------------------------------------
    def arrival(self, hot: bool) -> Tuple[str, float]:
        """Retention re-programmed on migration arrival (DESIGN.md §7):
        donor-hot prefixes land in the hot tier at ``hot_retention_s``,
        cold ones in the base tier at session retention. Returns
        ``(tier, retention_s)`` for the receiver's page allocations."""
        if hot:
            self.stats.arrivals_hot += 1
            return (self.hot_tier or self.tier), self.hot_retention_s
        self.stats.arrivals_short += 1
        return self.tier, self.session_retention_s

    def note_adoption(self, pages: int, tokens: int) -> None:
        self.stats.adopted_pages += pages
        self.stats.adopted_tokens += tokens
