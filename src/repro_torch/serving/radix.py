"""Token-level radix tree over page-aligned KV prefixes.

The paper's core claim is that inference soft state is write-once/read-many
and the *system* should manage its retention and placement (§2.2, §4);
shared prompt prefixes are the purest instance.  This module is the one
prefix abstraction every serving layer shares (DESIGN.md §6): the
`PagedKVManager` hangs its shared pages off the tree, the engine hangs its
compute-plane cache snapshots off it (the `payload` slot), the scheduler
scores admissions by `match_len`, and the cluster frontend routes by it.

Shape (after the sglang RadixCache design, adapted to page granularity):

- every node owns a run of whole pages — its `key` is the token sequence
  those pages cover, `len(key) % page_tokens == 0` always;
- children are keyed by their first page (a `page_tokens`-tuple), so a
  walk takes one dict lookup per page and splits always land on page
  boundaries (the match granularity the memory plane needs);
- `lock_ref` pins a node and all its ancestors while a live session holds
  its pages — pinned nodes are never evicted;
- eviction is leaf-LRU: only unlocked leaves are candidates, the
  least-recently-accessed goes first, and freeing a leaf may expose its
  parent as the next candidate;
- `hits` counts how often a node's tokens were reused — the observed-reuse
  signal the manager's retention programming (DCM §4) keys off;
- `payload` is an opaque compute-plane handle (the engine stores the donor
  slot's ring-cache snapshot here so a hit can skip prefill compute).

The tree never touches the memory simulator: page lifetime side effects
(refcounts, region release) belong to the caller.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple


def _page_key(tokens, start: int, page_tokens: int) -> tuple:
    """Hashable identity of one page's tokens (multi-codebook tokens are
    per-position sequences; flatten each to a tuple)."""
    page = tokens[start:start + page_tokens]
    return tuple(t if isinstance(t, (int,)) and not isinstance(t, bool)
                 else (int(t) if not hasattr(t, "__len__")
                       else tuple(int(x) for x in t))
                 for t in page)


def _tok_key(t):
    """One token's hashable identity (same normalization as _page_key)."""
    if isinstance(t, int) and not isinstance(t, bool):
        return t
    if hasattr(t, "__len__"):
        return tuple(int(x) for x in t)
    return int(t)


class RadixNode:
    __slots__ = ("key", "pages", "children", "parent", "lock_ref",
                 "last_access", "hits", "payload", "hot", "migrated",
                 "evicted_path")

    def __init__(self, key: tuple, pages: List[Any],
                 parent: Optional["RadixNode"], now: float):
        self.key = key                      # page-aligned token run
        self.pages = pages                  # one Page per page_tokens run
        self.children: Dict[tuple, "RadixNode"] = {}
        self.parent = parent
        self.lock_ref = 0                   # live sessions pinning this path
        self.last_access = now
        self.hits = 0                       # reuse count (retention signal)
        self.payload: Any = None            # opaque compute-plane handle
        self.hot = False                    # promoted to long retention
        self.migrated = False               # grafted from another replica
        self.evicted_path: Optional[tuple] = None  # full key at eviction

    @property
    def n_tokens(self) -> int:
        return len(self.key)

    def is_leaf(self) -> bool:
        return not self.children


@dataclass
class PrefixMatch:
    """Result of a longest-prefix walk. ``tokens`` is page-aligned by
    construction; a sub-page **tail** (vLLM-style, DESIGN.md §9) may
    extend it: ``tail_tokens`` more tokens of the prompt agree with the
    first page of ``tail_node`` (a child of ``node``), always strictly
    less than one page — a fully-matching page would have been consumed
    by the walk itself."""
    tokens: int = 0                      # matched token count (page-aligned)
    pages: List[Any] = field(default_factory=list)
    node: Optional[RadixNode] = None     # deepest matched node (lock target)
    payload: Any = None                  # nearest compute handle covering it
    tail_tokens: int = 0                 # sub-page tail beyond the boundary
    tail_node: Optional[RadixNode] = None  # child holding the tail's page


class RadixKVIndex:
    """Radix tree of page-aligned prefixes with leaf-LRU eviction.

    Invariants the tests rely on (property-tested in tests/test_radix.py):
    every node's key length is a whole number of pages and equals
    ``page_tokens * len(node.pages)``; a child's first page is its key in
    the parent's ``children`` dict (walks are one lookup per page); locked
    paths (``lock_ref > 0``) are never evicted; ``pop_leaf`` only detaches
    unlocked leaves and stamps ``evicted_path`` with the exact run the
    leaf covered, so callers can invalidate fleet-directory ownership."""

    def __init__(self, page_tokens: int):
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        self.page_tokens = page_tokens
        self.root = RadixNode((), [], None, 0.0)
        self.root.lock_ref = 1   # the root itself is never an eviction victim

    # -- walking --------------------------------------------------------
    def _pages_in_common(self, key: tuple, tokens, start: int) -> int:
        """Whole pages of `key` matching `tokens[start:]` (page units)."""
        pt = self.page_tokens
        n_key_pages = len(key) // pt
        avail_pages = (len(tokens) - start) // pt
        j = 0
        while j < min(n_key_pages, avail_pages):
            if _page_key(key, j * pt, pt) != _page_key(tokens, start + j * pt, pt):
                break
            j += 1
        return j

    def _split(self, node: RadixNode, n_pages: int, now: float) -> RadixNode:
        """Split `node` so its first `n_pages` pages become a new parent;
        the remainder stays on `node` (payload/hits travel with the deep
        half — they describe the full original run)."""
        pt = self.page_tokens
        head = RadixNode(node.key[:n_pages * pt], node.pages[:n_pages],
                         node.parent, now)
        head.lock_ref = node.lock_ref       # pins cover the whole path
        head.hits = node.hits
        head.hot = node.hot
        head.migrated = node.migrated       # provenance covers the whole run
        head.last_access = node.last_access
        parent = node.parent
        del parent.children[_page_key(node.key, 0, pt)]
        parent.children[_page_key(head.key, 0, pt)] = head
        node.key = node.key[n_pages * pt:]
        node.pages = node.pages[n_pages:]
        node.parent = head
        head.children[_page_key(node.key, 0, pt)] = node
        return head

    def match(self, tokens: Sequence, now: float,
              max_tokens: Optional[int] = None,
              bump_hits: bool = True,
              bump_lru: bool = True,
              with_tail: bool = False) -> PrefixMatch:
        """Longest page-aligned prefix of `tokens` present in the tree.
        Splits nodes at the match boundary (so the result's deepest node
        covers exactly the matched run) and bumps LRU stamps and hit
        counts on the matched path. A migration probe passes both bumps
        False: reading a prefix out to move its traffic AWAY is not local
        reuse — it must feed neither the retention signal nor the LRU
        order (or the donor would evict a genuinely-hot local prefix
        first).

        With ``with_tail`` the match also reports the sub-page tail: the
        longest run of tokens past the page-aligned boundary agreeing
        with the first page of one of ``node``'s children (DESIGN.md §9).
        The tail is informational — the caller decides whether to copy
        it — so tail discovery bumps no hit counts or LRU stamps."""
        pt = self.page_tokens
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        page_limit = (limit // pt) * pt
        m = PrefixMatch(node=self.root)
        node = self.root
        while m.tokens < page_limit:
            child = node.children.get(_page_key(tokens, m.tokens, pt))
            if child is None:
                break
            j = self._pages_in_common(child.key, tokens, m.tokens)
            j = min(j, (page_limit - m.tokens) // pt)
            if j == 0:
                break
            if j * pt < len(child.key):
                child = self._split(child, j, now)
            node = child
            m.tokens += j * pt
            m.pages.extend(node.pages)
            m.node = node
        for n in self._path(m.node):
            if bump_lru:
                n.last_access = now
            if m.tokens and bump_hits:
                n.hits += 1
        m.payload = self._nearest_payload(m.node)
        if with_tail and limit > m.tokens:
            m.tail_tokens, m.tail_node = self._tail_of(m.node, tokens,
                                                       m.tokens, limit)
        return m

    def _tail_of(self, node: RadixNode, tokens, start: int,
                 limit: int) -> Tuple[int, Optional[RadixNode]]:
        """Longest sub-page run of ``tokens[start:limit]`` agreeing with
        the first page of one of ``node``'s children. Strictly less than
        one page by construction: a whole matching page would have been
        consumed by the page-aligned walk (or clipped by ``limit``)."""
        best, best_node = 0, None
        for child in node.children.values():
            n = 0
            cap = min(limit - start, len(child.key))
            while n < cap and _tok_key(child.key[n]) == _tok_key(tokens[start + n]):
                n += 1
            if n > best:
                best, best_node = n, child
        return best, best_node

    def match_len(self, tokens: Sequence,
                  max_tokens: Optional[int] = None) -> int:
        """Read-only longest-prefix length in tokens: no splits, no LRU or
        hit-count side effects (scheduler scoring / cluster routing)."""
        pt = self.page_tokens
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        limit = (limit // pt) * pt
        node, matched = self.root, 0
        while matched < limit:
            child = node.children.get(_page_key(tokens, matched, pt))
            if child is None:
                break
            j = self._pages_in_common(child.key, tokens, matched)
            j = min(j, (limit - matched) // pt)
            if j == 0:
                break
            matched += j * pt
            if j * pt < len(child.key):
                break
            node = child
        return matched

    def _nearest_payload(self, node: RadixNode) -> Any:
        """A compute handle valid for a match ending at `node`: any payload
        at or below it (every descendant's prompt starts with this path)."""
        stack = [node]
        while stack:
            n = stack.pop()
            if n.payload is not None:
                return n.payload
            stack.extend(n.children.values())
        return None

    def subtree_payload(self, node: Optional[RadixNode]) -> Any:
        """Public form of the nearest-payload walk rooted at ``node``.
        The engine's sub-page tail reuse needs a payload whose token
        history agrees *through the tail* — any payload in the tail
        child's subtree qualifies, because every prompt below it starts
        with that child's first page (DESIGN.md §9)."""
        return None if node is None else self._nearest_payload(node)

    def payload_candidates(self, node: RadixNode) -> Iterator[Tuple[Any, int]]:
        """Yield ``(payload, holder_root_path_tokens)`` for every payload
        on ``node``'s root path and in its subtree. The holder's root-path
        length is the run the tree vouches for — callers filter on it (the
        engine's per-family snapshot resolution, DESIGN.md §8) so the
        tree-structure knowledge stays in this module."""
        depth = 0
        n = node
        while n is not None:
            depth += n.n_tokens
            n = n.parent
        d, n = depth, node
        while n is not None:                # the path itself, deepest first
            if n.payload is not None:
                yield n.payload, d
            d -= n.n_tokens
            n = n.parent
        stack = [(node, depth)]             # the subtree below
        while stack:
            n, d = stack.pop()
            if n is not node and n.payload is not None:
                yield n.payload, d
            stack.extend((c, d + c.n_tokens) for c in n.children.values())

    @staticmethod
    def _path(node: RadixNode) -> List[RadixNode]:
        out = []
        while node is not None:
            out.append(node)
            node = node.parent
        return out

    def full_key(self, node: RadixNode) -> tuple:
        """Root-to-node token path: the fleet-directory-visible identity
        of the prefix this node completes."""
        parts = []
        while node is not None and node.parent is not None:
            parts.append(node.key)
            node = node.parent
        out: tuple = ()
        for k in reversed(parts):
            out += k
        return out

    # -- insertion ------------------------------------------------------
    def insert(self, tokens: Sequence, pages: List[Any], now: float,
               payload: Any = None) -> Tuple[int, List[Any], RadixNode]:
        """Insert the page-aligned prefix `tokens` (``pages[i]`` covers
        tokens ``[i*pt, (i+1)*pt)``). Existing nodes keep their pages —
        duplicates from a concurrent cold start are NOT swapped in.
        Returns ``(dup_tokens, inserted_pages, deepest_node)``: the caller
        owns the refcount bump for `inserted_pages` (the tree's own
        reference), keeps full ownership of the duplicate pages, and may
        move its session lock to `deepest_node`."""
        pt = self.page_tokens
        n = (min(len(tokens), len(pages) * pt) // pt) * pt
        node, done = self.root, 0
        while done < n:
            child = node.children.get(_page_key(tokens, done, pt))
            if child is None:
                break
            j = self._pages_in_common(child.key, tokens, done)
            j = min(j, (n - done) // pt)
            if j == 0:
                break
            if j * pt < len(child.key):
                child = self._split(child, j, now)
            node = child
            node.last_access = now
            done += j * pt
        dup = done
        inserted: List[Any] = []
        if done < n:
            new = RadixNode(tuple(_flat(tokens[done:n])), pages[done // pt:n // pt],
                            node, now)
            node.children[_page_key(tokens, done, pt)] = new
            inserted = list(new.pages)
            node = new
        if payload is not None and node is not self.root and node.payload is None:
            node.payload = payload
        return dup, inserted, node

    def graft(self, tokens: Sequence, pages: List[Any], now: float,
              payload: Any = None, hits: int = 0,
              hot: bool = False) -> Tuple[int, List[Any], RadixNode]:
        """Graft an externally-built path (cross-replica migration): insert
        it and stamp the reuse state it arrived with — the donor's observed
        hit count and hot flag travel with the data, so a migrated-hot
        prefix keeps its retention signal on the receiving replica."""
        dup, inserted, node = self.insert(tokens, pages, now, payload=payload)
        if inserted and node is not self.root:
            node.hits = max(node.hits, hits)
            node.hot = node.hot or hot
            node.migrated = True
        return dup, inserted, node

    # -- pinning --------------------------------------------------------
    def lock(self, node: Optional[RadixNode]) -> None:
        for n in self._path(node):
            n.lock_ref += 1

    def unlock(self, node: Optional[RadixNode]) -> None:
        for n in self._path(node):
            n.lock_ref -= 1
            assert n.lock_ref >= 0 or n is self.root, "unbalanced unlock"

    # -- eviction -------------------------------------------------------
    def evictable_leaves(self) -> List[RadixNode]:
        return [n for n in self.nodes() if n.is_leaf() and n.lock_ref == 0]

    @staticmethod
    def lru_key(node: RadixNode) -> tuple:
        """The one eviction ordering (LRU, key tiebreak for determinism)
        every caller shares — the pressure path must agree with
        :meth:`pop_lru_leaf` or victim selection silently drifts."""
        return (node.last_access, node.key)

    def pop_lru_leaf(self) -> Optional[RadixNode]:
        """Remove and return the least-recently-accessed unlocked leaf
        (its pages' lifetime side effects are the caller's job)."""
        victims = self.evictable_leaves()
        if not victims:
            return None
        return self.pop_leaf(min(victims, key=self.lru_key))

    def pop_leaf(self, node: RadixNode) -> Optional[RadixNode]:
        """Remove a specific unlocked leaf (cold-decay path). The node's
        full root-to-leaf key is captured in ``evicted_path`` before the
        detach, so callers can invalidate fleet-directory ownership."""
        if not node.is_leaf() or node.lock_ref != 0 or node.parent is None:
            return None
        node.evicted_path = self.full_key(node)
        del node.parent.children[_page_key(node.key, 0, self.page_tokens)]
        node.parent = None
        return node

    # -- introspection (tests, reports) ---------------------------------
    def nodes(self) -> Iterator[RadixNode]:
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                yield n
            stack.extend(n.children.values())

    def n_nodes(self) -> int:
        return sum(1 for _ in self.nodes())

    def total_tokens(self) -> int:
        return sum(n.n_tokens for n in self.nodes())

    def total_pages(self) -> int:
        return sum(len(n.pages) for n in self.nodes())


def _flat(tokens) -> list:
    return [t if isinstance(t, int) and not isinstance(t, bool)
            else (int(t) if not hasattr(t, "__len__")
                  else tuple(int(x) for x in t))
            for t in tokens]
