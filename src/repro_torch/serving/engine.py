"""Serving engine: continuous batching over fixed decode slots, with every
byte routed through the MRM memory control plane — the port of
``repro.serving.engine`` on the paged compute plane (DESIGN.md §10) and on
per-slot ring caches.

The engine is an orchestrator over two subsystems that talk through an
explicit :class:`StepPlan` / :class:`StepReport` interface:

- :class:`ComputeBackend` — the PyTorch compute path: one pooled page
  array per cache family on the device, chunked prefill (``paged_prefill``
  / ``paged_extend``) and one batched decode step per engine step with
  per-slot positions. Attention reads the pool through the Hopper ragged
  paged-attention kernel on CUDA; SSM layers keep point-state pages (conv
  left-context + SSD state at page boundaries) and run every prefill and
  extend chunk through the Hopper SSD chunk-scan kernel. With
  ``paged_kernel=False`` (the ring path, the JAX package's default) it
  owns per-slot ring caches instead, for every stack: an attention first
  chunk attends through the flash forward and fills a fresh ring, a later
  chunk or a decode round writes its rows at ``pos % C`` and reads the
  whole ring through the paged kernel's explicit-position mode; MLA layers
  read their latent rings through the latent kernel's position mode in
  every mode; SSM layers scan every chunk from the ring's carried state.
  A prefix hit seeds the slot from a donor's metered ring snapshot
  (``seed_copy_bytes``), which the paged plane's page splice replaces:
  positional for attention and MLA, a point snapshot (the state at one
  exact page boundary, captured mid-prefill) for SSM and hybrid stacks.
- :class:`MemoryPlane`  — the MRM control plane: weights live in a region
  of the chosen tier; KV pages go through :class:`PagedKVManager` (DCM
  retention = expected session lifetime, capacity pressure resolved by an
  explicit eviction/spill/recompute policy).

Prefix reuse is real in both planes (DESIGN.md §6): a radix hit attaches
the matched pages in the memory plane and splices the same compute pages
into the borrower's page table (zero copy bytes); extend resumes from the
boundary. Prompts always run unpadded (DESIGN.md §5).

Cross-replica migration (``export_prefix``/``import_prefix``, driven by
``repro_torch.serving.cluster``) ships host torch tensors, which the
receiver copies onto its own device: it never holds a view of the donor's
tensors, which are written in place. Paged payloads keep the JAX
package's layout (``(repeats, P, ps, 2*Hkv, D)`` per leaf), so pages cross
between a JAX replica and a torch replica as arrays of the same shape
(float32 for bf16 pools: numpy has no bfloat16). Ring snapshots cross only
between torch replicas: the port's MLA ring is ``{"ckr", "pos"}`` where
the JAX package's is ``c``/``kr``/``pos``, and ``_snapshot_compatible``
turns away any tree that is not this backend's. Fault injection
(``inject_rber``, DESIGN.md §11) draws each visit's flips on the host and
XORs only the flipped words into the compute page where it lives.

The launch overrides (``kernel_block_q/kv``, ``kernel_buffers``) pin the
paged kernels' plan for the engine's page geometry in
``kernels/paged_attention/tune.py``'s cache, as the reference pins its
TPU tiles; on the CPU the plain version ignores them. Hybrid stacks (hymba)
serve on one page table that holds KV pages and state pages together.
Multi-codebook stacks (musicgen) carry a token as a K-tuple: prompts are
(L, K), ``last_tokens`` (B, 1, K), greedy sampling is per codebook, the
report counts one token per position and the eos check is off. Vision
stacks (internvl2) put zero patch embeddings in front of every prompt's
first chunk, so ``prefix_len`` counts them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.simulator import MemorySystem
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.param import (torch_dtype, tree_leaves, tree_map,
                                      tree_same_structure)
from repro_torch.runtime.tracing import NOOP, TRACER
from repro_torch.serving.kv_cache import PagedKVManager
from repro_torch.serving.radix import PrefixMatch
from repro_torch.serving.scheduler import ContinuousBatchScheduler, Request


@dataclass
class EngineConfig:
    max_slots: int = 4
    max_cache_len: int = 256
    max_prefills_per_step: int = 2
    weight_tier: str = "mrm"
    kv_tier: str = "mrm"
    page_tokens: int = 64
    expected_session_s: float = 600.0
    eos_token: int = 1
    greedy: bool = True
    # radix prefix reuse [53]: match page-aligned prompt prefixes, share
    # their KV pages, and skip their prefill compute
    prefix_caching: bool = True
    # sub-page tail reuse (DESIGN.md §9): a match ending mid-page copies
    # the shared tail into the borrower's page and extend resumes from
    # the exact token boundary
    tail_copy: bool = True
    # chunked prefill: feed prompts in `chunk_tokens` pieces interleaved
    # with decode rounds (None = one maximal chunk per prompt, clamped to
    # the smallest per-layer ring — the same code path)
    chunk_tokens: Optional[int] = None
    # capacity-pressure policy for the KV tier (see PagedKVManager):
    # "evict-lru" | "spill" | "recompute" | "none" (legacy silent drops)
    kv_pressure_policy: str = "evict-lru"
    kv_spill_tier: Optional[str] = None
    kv_high_watermark: Optional[float] = 0.92
    # reuse -> retention programming (paper §4)
    radix_hot_threshold: int = 4
    radix_hot_retention_s: float = 3600.0
    radix_hot_tier: Optional[str] = None
    radix_cold_ttl_s: Optional[float] = None
    # pressure-driven demotion (DESIGN.md §9)
    demote_on_pressure: bool = False
    # regression guard: verify after every decode round that no compute
    # page of a session the round did not decode was written
    audit_decode_masking: bool = False
    # paged compute plane (DESIGN.md §10): run extend and decode in place on
    # the pages PagedKVManager owns. False is the ring path (per-slot ring
    # caches), the default as in the JAX package
    paged_kernel: bool = False
    # paged-attention launch plan overrides: rows a CTA, page slots a
    # split, cp.async stages (None = the tuned or default plan of this
    # geometry on this card; kernels/paged_attention/tune.py). The plain
    # version on the CPU ignores them
    kernel_block_q: Optional[int] = None
    kernel_block_kv: Optional[int] = None
    kernel_buffers: Optional[int] = None
    # reliability plane (DESIGN.md §11): age-driven bit flips into the
    # paged compute pages before each decode round (None = off)
    inject_rber: Optional[float] = None
    inject_seed: int = 0
    # abandonment (DESIGN.md §12): queued requests older than this are
    # dropped before admission (None = off)
    abandon_after_s: Optional[float] = None


# ---------------------------------------------------------------------------
# StepPlan / StepReport: the contract between scheduler, compute and memory
# ---------------------------------------------------------------------------


@dataclass
class PrefillChunk:
    """One piece of a prompt scheduled for this step."""
    slot: int
    request_id: int
    tokens: np.ndarray
    offset: int    # absolute start position
    first: bool    # the prompt's first chunk (runs paged_prefill)
    last: bool     # completes the prompt (samples the first output token)


@dataclass
class StepPlan:
    """What this engine step will do: the scheduler builds it, the
    ComputeBackend executes it, the MemoryPlane meters it."""
    prefill: List[PrefillChunk] = field(default_factory=list)
    decode: List[int] = field(default_factory=list)  # slots


@dataclass
class StepReport:
    """What an engine step did, with the per-tier byte/latency breakdown."""
    step_s: float = 0.0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    finished: int = 0
    bytes_by_tier: Dict[str, dict] = field(default_factory=dict)

    @property
    def bytes(self) -> float:
        return sum(t["read_bytes"] + t["write_bytes"]
                   for t in self.bytes_by_tier.values())


@dataclass
class SnapshotHandle:
    """A donor slot's ring-cache snapshot with its metered backing region
    in the KV tier, released when its radix node leaves the tree (the
    manager calls ``release()``). ``kind``/``tokens`` are its validity
    (DESIGN.md §8): a ``"positional"`` snapshot (attention KV, MLA
    latents) covers every page-aligned boundary up to ``tokens`` positions,
    stale entries past a borrower's boundary staying position-masked; a
    ``"point"`` snapshot (SSM state, the hybrid union) is valid only at
    exactly ``tokens`` positions (the meta/frontend prefix included)."""
    caches: object
    nbytes: float
    mem: MemorySystem
    region_id: Optional[int]
    kind: str = "positional"
    tokens: int = 0

    def release(self) -> None:
        if self.region_id is not None:
            self.mem.release_region(self.region_id)
            self.region_id = None

    @property
    def live(self) -> bool:
        return self.region_id is not None


@dataclass
class _SlotPrefill:
    """Continuation state of a (possibly radix-shortened) chunked prefill:
    how far into the prompt the slot's pages already reach — a prefix hit
    starts `done` at the seeded boundary (which, with sub-page tail reuse,
    need not be page-aligned) instead of 0.

    On the ring path a point stack (SSM, hybrid) also carries up to two
    page-aligned capture points (prompt-index space): ``snap_match_at``,
    the boundary of this request's own match, whose state is hung on the
    matched radix node as the prefill crosses it, and ``snap_end_at``, the
    prompt's last page boundary, whose state (``point_caches``) publishes
    with the prompt. Chunks end on the page grid, so both are chunk ends."""
    req: Request
    tokens: np.ndarray            # prompt tokens (always unpadded)
    chunk: int
    key: Optional[np.ndarray]     # radix key
    match: Optional[PrefixMatch]
    done: int = 0   # tokens of `tokens` already in the slot's pages
    grid: Optional[int] = None    # point stacks: page-aligned chunking
    snap_match_at: Optional[int] = None   # point capture: match boundary
    snap_end_at: Optional[int] = None     # point capture: last page boundary
    point_caches: object = None           # the end-boundary capture

    def next_chunk(self, slot: int, prefix_len: int) -> PrefillChunk:
        end = min(self.done + self.chunk, len(self.tokens))
        if self.grid:
            # point-state stacks chunk on the position-space page grid:
            # every chunk reads one state page and writes one, and warm,
            # cold and migrated runs cut prompts identically (a seeded
            # resumption stays bit-equal to a cold run, DESIGN.md §8)
            nxt = ((prefix_len + self.done) // self.grid + 1) * self.grid \
                - prefix_len
            end = min(end, max(nxt, self.done + 1))
        return PrefillChunk(slot, self.req.request_id,
                            self.tokens[self.done:end],
                            offset=prefix_len + self.done,
                            first=self.done == 0,
                            last=end == len(self.tokens))


# ---------------------------------------------------------------------------
# ComputeBackend: the PyTorch half
# ---------------------------------------------------------------------------


class ComputeBackend:
    """Real-model compute over fixed decode slots: chunked prefill and
    batched decode. On the paged plane it computes in place on one pooled
    page array per cache family (owned here, indexed by PagedKVManager
    pages via Page.compute_page; page 0 is the reserved null page); on the
    ring path it owns per-slot ring caches. Knows nothing about tiers or
    retention."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 device: torch.device):
        self.cfg = cfg
        self.ecfg = ecfg
        self.params = params
        self.device = device
        self.paged = bool(ecfg.paged_kernel)
        B = ecfg.max_slots
        self.positions = np.full((B,), -1, np.int64)  # last written position
        self.last_tokens = np.zeros((B, 1) if cfg.n_codebooks == 1
                                    else (B, 1, cfg.n_codebooks), np.int32)
        self.seed_copy_bytes = 0.0  # ring-path donor seeding copy traffic
        self.model_calls = 0        # prefill chunks + decode rounds run
        self.page_tokens = ecfg.page_tokens
        self.caches = self.paged_caches = None
        if self.paged:
            n0 = max(16, 1 + B * -(-ecfg.max_cache_len // ecfg.page_tokens))
            self.paged_caches = tfm.init_paged_caches(
                cfg, n0, ecfg.page_tokens, torch_dtype(cfg.dtype), device)
            self._free = list(range(n0 - 1, 0, -1))  # pop() -> lowest id
        else:
            self.caches = tfm.init_caches(cfg, B, ecfg.max_cache_len,
                                          torch_dtype(cfg.dtype), device)

    # -- paged compute-page pool (DESIGN.md §10) -----------------------
    @staticmethod
    def table_width(n_pages: int) -> int:
        """Power-of-2 page-table width bucket: a borrower's table may be
        wider than the donor's, which the kernel's fixed page order makes
        harmless (trailing nulls are bit-neutral)."""
        return max(1, 1 << (max(1, n_pages) - 1).bit_length())

    def _grow_pool(self) -> None:
        """Double the page pool: zeros appended on the page axis of every
        cache-family leaf (a new contiguous tensor per leaf, so every
        layer's ``pool[i]`` stays a contiguous view for the kernel)."""
        old = tree_leaves(self.paged_caches)[0].shape[1]
        self.paged_caches = tree_map(
            lambda a: torch.cat([a, torch.zeros_like(a)], dim=1),
            self.paged_caches)
        self._free.extend(range(2 * old - 1, old - 1, -1))

    def alloc_page(self) -> int:
        if not self._free:
            self._grow_pool()
        return self._free.pop()

    def free_page(self, pid: int) -> None:
        """Return a compute page to the pool. No zeroing needed: a reused
        page's stale rows sit above the new owner's written length, where
        slot-derived key positions exceed every query position (masked)."""
        self._free.append(pid)

    def copy_page_rows(self, src: int, dst: int, n: int) -> None:
        """Copy rows [0, n) of compute page `src` into `dst` across every
        cache family, in place — the sub-page tail seeding primitive
        (DESIGN.md §9): the only bytes a prefix hit ever copies."""
        for a in tree_leaves(self.paged_caches):
            a[:, dst, :n] = a[:, src, :n]

    def export_pages(self, ids: List[int]):
        """Host-side copy of the listed compute pages (page axis first in
        each leaf slice) — the migration payload. Host torch tensors, not
        numpy: numpy has no bfloat16."""
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        return tree_map(lambda a: a[:, idx].cpu(), self.paged_caches)

    def import_pages(self, ids: List[int], data) -> None:
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        for a, d in zip(tree_leaves(self.paged_caches), tree_leaves(data)):
            a[:, idx] = d.to(device=a.device, dtype=a.dtype)

    def pages_compatible(self, data) -> bool:
        """Foreign page data is adoptable only when its tree structure and
        per-page leaf shapes/dtypes match this pool exactly."""
        if not tree_same_structure(data, self.paged_caches):
            return False
        return all(
            isinstance(d, torch.Tensor)
            and d.shape[0] == a.shape[0] and d.shape[2:] == a.shape[2:]
            and d.dtype == a.dtype
            for d, a in zip(tree_leaves(data), tree_leaves(self.paged_caches)))

    # -- ring slot plumbing ----------------------------------------------
    def _insert_slot(self, slot: int, new_caches) -> None:
        """Copy a B=1 ring-cache tree into decode slot ``slot``."""
        for dst, src in zip(tree_leaves(self.caches), tree_leaves(new_caches)):
            dst[:, slot] = src[:, 0]

    def _extract_slot(self, slot: int):
        """Decode slot ``slot`` as a B=1 ring-cache tree of views: a chunk
        extended on it writes the slot in place."""
        return tree_map(lambda a: a[:, slot:slot + 1], self.caches)

    def snapshot_slot(self, slot: int):
        """A B=1 copy of a slot's rings: a donor handle that later writes
        to the slot leave as it is."""
        return tree_map(lambda a: a[:, slot:slot + 1].clone(), self.caches)

    def seed_slot(self, slot: int, snapshot) -> None:
        """Seed a slot's rings from a donor snapshot (prefix hit). Donor
        entries past the matched prefix are harmless: masking is by
        position, so they stay masked until this request overwrites them.
        This is the ring path's per-hit copy, a whole per-slot cache tree
        (``seed_copy_bytes``), which the paged plane's page splice
        replaces."""
        self.seed_copy_bytes += float(sum(a.numel() * a.element_size()
                                          for a in tree_leaves(snapshot)))
        self._insert_slot(slot, snapshot)

    def prefix_len(self) -> int:
        return self.cfg.n_meta_tokens + (self.cfg.n_frontend_tokens
                                         if self.cfg.frontend == "vision" else 0)

    def sample(self, logits):
        """Greedy: (B, V) logits -> (B,) tokens, or (B, K, V) -> (B, K), one
        per codebook."""
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _tensor(self, a, dtype=torch.int32):
        a = np.asarray(a)
        if TRACER.on:
            TRACER.count("backend.h2d_copies")
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # -- StepPlan execution --------------------------------------------
    def run_prefill_chunk(self, ck: PrefillChunk,
                          page_table: np.ndarray) -> Optional[np.ndarray]:
        """Execute one prefill chunk: on the paged plane in place on the
        pool pages listed in ``page_table`` (the request's session pages);
        on the ring path a first chunk into a fresh ring copied into the
        slot, a later one in place on the slot's rings. Returns the sampled
        next token when the chunk completes the prompt, else None."""
        with (TRACER.span("backend.prefill_chunk", ck.request_id,
                          tokens=len(ck.tokens), offset=ck.offset)
              if TRACER.on else NOOP):
            return self._prefill_chunk(ck, page_table)

    def _prefill_chunk(self, ck: PrefillChunk, page_table) -> Optional[np.ndarray]:
        with TRACER.span("backend.inputs") if TRACER.on else NOOP:
            toks = self._tensor(np.asarray(ck.tokens, np.int32))[None]
            table = self._tensor(page_table)[None] if self.paged else None
        batch = {"tokens": toks}
        if ck.first and self.cfg.frontend == "vision":
            # the vision frontend is a stub: zero patch embeddings, as the
            # reference engine feeds them
            batch["image_embeds"] = torch.zeros(
                (1, self.cfg.n_frontend_tokens, self.cfg.d_model),
                dtype=torch_dtype(self.cfg.dtype), device=self.device)
        with TRACER.span("model.forward") if TRACER.on else NOOP:
            if not self.paged:
                if ck.first:
                    logits, caches1 = tfm.prefill(
                        self.cfg, self.params, batch,
                        max_cache_len=self.ecfg.max_cache_len,
                        page_tokens=self.page_tokens)
                    self._insert_slot(ck.slot, caches1)
                else:
                    logits, _ = tfm.extend(self.cfg, self.params,
                                           self._extract_slot(ck.slot), toks,
                                           ck.offset, page_tokens=self.page_tokens)
            elif ck.first:
                logits, self.paged_caches = tfm.paged_prefill(
                    self.cfg, self.params, batch, self.paged_caches, table,
                    page_tokens=self.page_tokens)
            else:
                logits, self.paged_caches = tfm.paged_extend(
                    self.cfg, self.params, self.paged_caches, toks, ck.offset,
                    table, page_tokens=self.page_tokens)
        self.model_calls += 1
        if not ck.last:
            return None
        with TRACER.span("backend.sample_sync") if TRACER.on else NOOP:
            tok = self.sample(logits).cpu().numpy()
        self.last_tokens[ck.slot] = tok
        self.positions[ck.slot] = ck.offset + len(ck.tokens) - 1
        return tok

    def run_decode(self, slots: List[int],
                   page_tables: Optional[np.ndarray] = None,
                   audit_pages: Optional[List[int]] = None) -> np.ndarray:
        """One batched decode round over `slots`: on the paged plane
        ``page_tables`` is the (B, W) compute-page table (inactive rows
        all-null, and masked out of the KV write) and ``audit_pages`` lists
        compute pages the round must not write (other sessions' pages); on
        the ring path the other slots' rings are masked out of the write,
        and are the ones audited, every cache family of them (attention
        KV, MLA latents, conv and SSD state). Returns the sampled tokens for
        all B rows ((B,), or (B, K) for K codebooks)."""
        with TRACER.span("backend.decode", rows=len(slots)) if TRACER.on else NOOP:
            return self._decode(slots, page_tables, audit_pages)

    def _decode(self, slots, page_tables, audit_pages) -> np.ndarray:
        B = self.ecfg.max_slots
        act = np.zeros((B,), bool)
        act[slots] = True
        caches = self.paged_caches if self.paged else self.caches
        watched = audit_pages if self.paged else [s for s in range(B) if not act[s]]
        before = None
        if self.ecfg.audit_decode_masking and watched:
            idx = torch.as_tensor(watched, dtype=torch.long, device=self.device)
            # the decode below writes the caches in place: take the copy now
            before = [leaf[:, idx].clone() for leaf in tree_leaves(caches)]
        with TRACER.span("backend.inputs") if TRACER.on else NOOP:
            pos = self._tensor(np.maximum(self.positions + 1, 0))
            tokens, active = self._tensor(self.last_tokens), self._tensor(act, torch.bool)
            tables = self._tensor(page_tables) if self.paged else None
        with TRACER.span("model.forward") if TRACER.on else NOOP:
            if self.paged:
                logits, _ = tfm.paged_decode(
                    self.cfg, self.params, caches, tokens, pos, tables,
                    active=active, page_tokens=self.page_tokens)
            else:
                logits, _ = tfm.decode(self.cfg, self.params, caches, tokens, pos,
                                       active=active, page_tokens=self.page_tokens)
        self.model_calls += 1
        if before is not None:
            # clobbering guard: a paged round writes exactly one row of each
            # active session's open page, a ring round one ring slot of each
            # active slot — shared (sealed) pages, other sessions' pages and
            # the other slots' rings must come back bit-identical
            for b, leaf in zip(before, tree_leaves(caches)):
                if not torch.equal(b.view(torch.uint8),
                                   leaf[:, idx].view(torch.uint8)):
                    raise AssertionError(
                        "decode wrote another session's compute page "
                        "(paged masking regression)" if self.paged else
                        "decode wrote an inactive slot's cache (active-slot "
                        "masking regression)")
        with TRACER.span("backend.sample_sync") if TRACER.on else NOOP:
            next_np = self.sample(logits).cpu().numpy()
        for slot in slots:
            self.positions[slot] += 1
            self.last_tokens[slot] = next_np[slot]
        return next_np

    def free_slot(self, slot: int) -> None:
        self.positions[slot] = -1


# ---------------------------------------------------------------------------
# MemoryPlane: the MRM control-plane half
# ---------------------------------------------------------------------------


def choose_hot_tier(mem: MemorySystem, cfg: ModelConfig,
                    ecfg: EngineConfig) -> Optional[str]:
    """Pick the tier hot (frequently reused) prefix KV should live in, via
    the paper-§4 placement solver: a read-heavy, rarely-rewritten,
    long-lived data class over the engine's actual tiers. Returns a tier
    *name*, or None when the solve is infeasible. solve_placement speaks
    technology names, so each tier's tech is aliased to its tier name —
    two tiers sharing one technology stay distinguishable."""
    import dataclasses

    from repro_torch.core.memclass import YEAR
    from repro_torch.core.tiering import DataClassProfile, Tier, solve_placement

    tiers = [Tier(tech=dataclasses.replace(d.tech, name=name),
                  capacity_bytes=d.capacity)
             for name, d in mem.devices.items()]
    size = 0.25 * mem.devices[ecfg.kv_tier].capacity
    hot = DataClassProfile(
        name="kv_prefix_hot", size_bytes=size,
        read_bw_bytes_s=size,                        # reread ~once per second
        write_bw_bytes_s=size / ecfg.radix_hot_retention_s,  # rewritten per retention
        lifetime_s=ecfg.radix_hot_retention_s, soft_state=True)
    res = solve_placement([hot], tiers, device_life_s=5 * YEAR)
    if not res.feasible:
        return None
    name = res.assignment["kv_prefix_hot"]
    return name if name in mem.devices else None


class MemoryPlane:
    """Weight regions + paged KV + per-tier step metering. All placement,
    retention and pressure decisions live here; the accounting scale
    (``acct_cfg``) is decoupled from the compute scale."""

    def __init__(self, acct_cfg: ModelConfig, mem: MemorySystem,
                 ecfg: EngineConfig):
        self.cfg = acct_cfg
        self.mem = mem
        self.ecfg = ecfg
        hot_tier = ecfg.radix_hot_tier
        if hot_tier == "auto":
            hot_tier = choose_hot_tier(mem, acct_cfg, ecfg)
        elif hot_tier is not None and hot_tier not in mem.devices:
            raise ValueError(f"radix_hot_tier {hot_tier!r} is not a tier "
                             f"({sorted(mem.devices)})")
        self.hot_tier = hot_tier
        # point-state pages ride on KV pages on the paged plane only
        state_bp = (float(acct_cfg.state_bytes_per_page())
                    if ecfg.paged_kernel else 0.0)
        self.kv = PagedKVManager(acct_cfg, mem, ecfg.kv_tier,
                                 ecfg.page_tokens, ecfg.expected_session_s,
                                 spill_tier=ecfg.kv_spill_tier,
                                 policy=ecfg.kv_pressure_policy,
                                 high_watermark=ecfg.kv_high_watermark,
                                 hot_threshold=ecfg.radix_hot_threshold,
                                 hot_retention_s=ecfg.radix_hot_retention_s,
                                 hot_tier=hot_tier,
                                 cold_ttl_s=ecfg.radix_cold_ttl_s,
                                 tail_copy=ecfg.tail_copy,
                                 demote_on_pressure=ecfg.demote_on_pressure,
                                 state_bytes_page=state_bp)
        counts = acct_cfg.param_counts()
        self.weight_bytes = counts["total"] * 2  # bf16
        self.active_weight_bytes = counts["active"] * 2
        # deploy weights into the weight tier (written once — §2 of paper)
        self.weight_region = self._deploy()
        self._snap = None

    def _deploy(self) -> Optional[int]:
        return self.mem.write_region(
            self.ecfg.weight_tier, "weights", self.weight_bytes,
            expected_lifetime_s=self.mem.devices[
                self.ecfg.weight_tier].tech.retention_s)

    def redeploy_weights(self) -> None:
        """Model update (paper §2/§3: bulk weight overwrite): release the
        old weight region and write the new one."""
        self.mem.release_region(self.weight_region)
        self.weight_region = self._deploy()

    # -- per-step metering ---------------------------------------------
    def begin_step(self) -> None:
        with TRACER.span("memplane.begin_step") if TRACER.on else NOOP:
            self._snap = self.mem.snapshot()

    def weight_pass(self) -> None:
        """One model pass streams the active weights from the weight tier."""
        with TRACER.span("memplane.weight_pass") if TRACER.on else NOOP:
            self.mem.read_region(self.weight_region, self.active_weight_bytes)

    def finish_step(self):
        """Per-tier step latency: each tier's traffic at its own read/write
        bandwidth, tiers in parallel -> the slowest bounds the step."""
        with TRACER.span("memplane.finish_step") if TRACER.on else NOOP:
            return self.mem.step_latency_since(self._snap)

    def report(self) -> dict:
        return self.mem.report()


# ---------------------------------------------------------------------------
# ServeEngine: the orchestrator
# ---------------------------------------------------------------------------


class ServeEngine:
    """One replica's orchestrator: plans each step (prefill chunks + one
    decode round), executes it against the :class:`ComputeBackend` and
    :class:`MemoryPlane`, and advances the simulated clock by the modelled
    per-tier step latency.

    Invariants the tests rely on:

    - **Hit/cold equivalence** — a prefix hit (pages spliced into the
      borrower's table + extend from the boundary) decodes the same tokens
      as a cold start; at least one prompt token always computes.
    - **Zero copy** — on the paged plane a page-aligned hit copies nothing
      (``seed_copy_bytes == 0``, no snapshots); only a sub-page tail copies
      page rows. On the ring path a hit seeds the slot from a donor's
      metered ring snapshot (``SnapshotHandle``), released when its radix
      node leaves the tree.
    """

    def __init__(self, cfg: ModelConfig, params, mem: MemorySystem,
                 ecfg: EngineConfig, account_cfg: Optional[ModelConfig] = None,
                 device=None):
        """``account_cfg`` decouples the memory-accounting scale from the
        compute scale: CPU tests run a reduced model for real token
        generation while the control plane meters the *deployment-size*
        config's weight/KV byte streams. ``device`` defaults to ``cuda``
        (raises without a card); ``params`` must live on it."""
        self.device = resolve_device(device)
        self.paged = bool(ecfg.paged_kernel)
        if not self.paged:
            from repro_torch.kernels.decode_attention import ring_page_size
            from repro_torch.models.attention import cache_len_for
            for spec in cfg.layer_specs():   # every positional ring is whole pages
                if spec.kind != "ssm":
                    ring_page_size(cache_len_for(spec.window, ecfg.max_cache_len),
                                   ecfg.page_tokens)
        if ecfg.kernel_block_q or ecfg.kernel_block_kv or ecfg.kernel_buffers:
            # pin the paged kernels' launch plan for this page geometry:
            # every ragged_paged_attention launch consults the tune cache
            from repro_torch.kernels.paged_attention.tune import (KernelConfig,
                                                                  best_config,
                                                                  set_config)
            base = best_config(ecfg.page_tokens, cfg.resolved_head_dim)
            set_config(ecfg.page_tokens, cfg.resolved_head_dim,
                       KernelConfig(
                           block_q=ecfg.kernel_block_q or base.block_q,
                           block_kv=ecfg.kernel_block_kv or base.block_kv,
                           num_buffers=ecfg.kernel_buffers or base.num_buffers))
        for leaf in tree_leaves(params):
            if leaf.device != self.device:
                raise ValueError(f"params are on {leaf.device}, the engine "
                                 f"on {self.device}")
        self.cfg = cfg
        self.acct_cfg = account_cfg or cfg
        self.params = params
        self.mem = mem
        self.ecfg = ecfg
        # how this stack's prefixes may be reused (DESIGN.md §8)
        self.snapshot_kind = tfm.snapshot_kind(cfg)
        self.sched = ContinuousBatchScheduler(ecfg.max_slots,
                                              ecfg.max_prefills_per_step)
        self.backend = ComputeBackend(cfg, params, ecfg, self.device)
        self.memplane = MemoryPlane(self.acct_cfg, mem, ecfg)
        self.kernel_read_bytes = 0.0   # paged: metered kernel page gathers
        if self.paged:
            # every memory-plane page owns one compute page for its life —
            # a radix hit shares the Page object, hence the compute page:
            # zero copy bytes
            self.memplane.kv.on_page_alloc = self._on_page_alloc
            self.memplane.kv.on_page_release = self._on_page_release
        # per-layer (kv_bytes_per_token, window, state_bytes) at the
        # accounting scale: the analytic model of the kernel's per-page
        # read stream — positional layers gather token rows, point layers
        # additionally pull one state-page snapshot per step
        self._acct_layers = []
        state_lb = float(self.acct_cfg.ssm_state_bytes_layer())
        for spec in self.acct_cfg.layer_specs():
            if spec.kind == "mla":
                lb, sb = (self.acct_cfg.kv_lora_rank
                          + self.acct_cfg.qk_rope_dim) * 2, 0.0
            elif spec.kind == "attn":
                lb, sb = (2 * self.acct_cfg.n_kv_heads
                          * self.acct_cfg.resolved_head_dim * 2), 0.0
            elif spec.kind == "hybrid":
                lb = (2 * self.acct_cfg.n_kv_heads
                      * self.acct_cfg.resolved_head_dim * 2)
                sb = state_lb
            else:                      # ssm: no KV token stream
                lb, sb = 0.0, state_lb
            self._acct_layers.append((float(lb), spec.window, sb))
        # fault injection (DESIGN.md §11): age-driven flips over the paged
        # compute plane, sampled against each page's tracked region
        self.faults = None
        if ecfg.inject_rber:
            from repro_torch.core.faults import FaultInjector
            self.faults = FaultInjector(mem, ecfg.inject_rber,
                                        seed=ecfg.inject_seed)
        self.outputs: Dict[int, list] = {}
        self._inflight: Dict[int, _SlotPrefill] = {}  # slot -> chunk state
        self._prep_cache: Dict[int, tuple] = {}  # rid -> (tokens, chunk, key)
        self.tokens_generated = 0
        self.steps = 0
        self.prefill_chunks_run = 0
        self.prefill_tokens_computed = 0   # tokens that ran through the model
        self.prefill_tokens_skipped = 0    # tokens a radix hit skipped
        self.prefix_compute_hits = 0       # admissions seeded from a prefix
        self.snapshots_published = 0       # ring: metered donor snapshots
        self._snap_spec = None             # cached foreign-snapshot template

    # -- legacy surface (kept stable for callers/tests) ----------------
    @property
    def kv(self) -> PagedKVManager:
        return self.memplane.kv

    @property
    def weight_bytes(self) -> float:
        return self.memplane.weight_bytes

    @property
    def active_weight_bytes(self) -> float:
        return self.memplane.active_weight_bytes

    @property
    def weight_region(self):
        return self.memplane.weight_region

    @property
    def positions(self):
        return self.backend.positions

    @property
    def last_tokens(self):
        return self.backend.last_tokens

    def redeploy_weights(self) -> None:
        self.memplane.redeploy_weights()

    # ------------------------------------------------------------------
    def submit(self, prompt_tokens: list, max_new_tokens: int,
               migrated_tokens: int = 0, at: Optional[float] = None,
               admit_after: Optional[float] = None) -> int:
        """``migrated_tokens`` marks how many leading tokens a cross-replica
        migration just grafted into this replica's tree for this request;
        ``at`` stamps an explicit arrival time; ``admit_after`` defers
        admission. Any prompt length is admissible: there is one unpadded
        chunked path (DESIGN.md §5)."""
        rid = len(self.outputs)
        self.outputs[rid] = []
        submitted = self.mem.now if at is None else at
        self.sched.submit(Request(rid, prompt_tokens, max_new_tokens,
                                  submitted,
                                  migrated_tokens=migrated_tokens,
                                  admit_after=(submitted if admit_after is None
                                               else admit_after)))
        return rid

    # ------------------------------------------------------------------
    def _min_ring_len(self) -> int:
        """Smallest per-layer cache ring (windowed layers have rings of
        cache_len_for(window, max_cache_len) < max_cache_len) — the chunk
        bound the JAX engine applies on every path, kept so both engines
        cut prompts identically."""
        from repro_torch.models.attention import cache_len_for
        return min(cache_len_for(spec.window, self.ecfg.max_cache_len)
                   for spec in self.cfg.layer_specs())

    def _chunk_plan(self, toks: np.ndarray) -> tuple:
        """(tokens, chunk) for a prompt — never padded (DESIGN.md §5).
        ``chunk_tokens=None`` means one maximal chunk on the same path.
        Either way the chunk is clamped to the smallest per-layer ring, and
        once the prompt overflows the ring it is halved."""
        ecfg = self.ecfg
        L = toks.shape[0]
        min_ring = self._min_ring_len()
        chunk = L if ecfg.chunk_tokens is None else ecfg.chunk_tokens
        chunk = min(chunk, min_ring)
        if L + self.backend.prefix_len() > min_ring:
            chunk = min(chunk, max(16, min_ring // 2))
        return toks, max(1, min(chunk, L))

    def _radix_key(self, toks: np.ndarray) -> np.ndarray:
        """Radix tokens in *position space*: the meta/frontend prefix is a
        run of sentinel tokens shared by every request on this engine."""
        plen = self.backend.prefix_len()
        if plen == 0:
            return toks
        sent = np.full((plen,) + toks.shape[1:], -1, toks.dtype)
        return np.concatenate([sent, toks], axis=0)

    def _prep(self, req: Request) -> tuple:
        """(tokens, chunk, radix_key) for a request, memoized while it sits
        in the queue."""
        ent = self._prep_cache.get(req.request_id)
        if ent is None:
            toks = np.asarray(req.prompt_tokens, np.int32)
            toks, chunk = self._chunk_plan(toks)
            key = self._radix_key(toks) if self.ecfg.prefix_caching else None
            ent = (toks, chunk, key)
            self._prep_cache[req.request_id] = ent
        return ent

    def radix_key_for(self, prompt_tokens: list) -> Optional[np.ndarray]:
        """Position-space radix key for a raw prompt (None with prefix
        caching off)."""
        if not self.ecfg.prefix_caching:
            return None
        return self._radix_key(np.asarray(prompt_tokens, np.int32))

    def prefix_match_len(self, prompt_tokens: list) -> int:
        """Longest radix-matchable prefix (in position-space tokens) this
        engine holds for `prompt_tokens` — side-effect-free."""
        key = self.radix_key_for(prompt_tokens)
        return 0 if key is None else self.kv.match_len(key)

    def _point_snapshot_for(self, node, max_tokens: int
                            ) -> Optional[SnapshotHandle]:
        """Deepest live point snapshot usable at a match ending at ``node``
        with ``max_tokens`` matched positions: one on the node's ancestor
        path or in its subtree whose boundary is covered both by the
        borrower's match and by its holder's own root path."""
        best = None
        for h, depth in self.kv.radix.payload_candidates(node):
            if (isinstance(h, SnapshotHandle) and h.live and h.kind == "point"
                    and h.tokens <= min(max_tokens, depth)
                    and (best is None or h.tokens > best.tokens)):
                best = h
        return best

    def _compute_reuse(self, match: PrefixMatch, toks: np.ndarray) -> tuple:
        """(tokens of the prompt the compute plane may skip, the ring
        snapshot to seed from, sub-page tail tokens used). At least one
        token always runs — the last position's logits seed the first
        sampled token.

        Paged plane: the matched pages ARE the compute state; the hit is a
        page-table splice, and only a sub-page tail copies (page rows,
        DESIGN.md §9). Point stacks have no mid-page state, so tails stay
        off and resumption is clamped down to the last page boundary (the
        state page there holds the exact boundary state).

        Ring path, positional stacks: seed from a donor snapshot whose
        token history covers the resumption point — with a sub-page tail a
        payload in the tail child's subtree (every prompt below it shares
        the tail run), else the nearest payload at or below the match;
        stale entries past the boundary stay masked. Point stacks seed only
        from a point snapshot captured at a page boundary the match covers
        (the deepest), and never use a tail."""
        plen = self.backend.prefix_len()
        L = toks.shape[0]
        if match.tokens == 0:
            return 0, None, 0
        if self.paged:
            tail = (self.kv.tail_available(match)
                    if self.ecfg.tail_copy and self.snapshot_kind == "positional"
                    else 0)
            reuse = max(0, min(match.tokens + tail - plen, L - 1))
            tail = max(0, min(tail, reuse - (match.tokens - plen)))
            if self.snapshot_kind == "point":
                pt = self.ecfg.page_tokens
                reuse = max(0, ((plen + reuse) // pt) * pt - plen)
            return (reuse, None, tail) if reuse else (0, None, 0)
        if self.snapshot_kind == "point":
            snap = self._point_snapshot_for(match.node,
                                            min(match.tokens, plen + L - 1))
            if snap is None or snap.tokens <= plen:
                return 0, None, 0
            return snap.tokens - plen, snap, 0
        payload, tail = None, 0
        avail = self.kv.tail_available(match)
        if self.ecfg.tail_copy and avail:
            p = self.kv.radix.subtree_payload(match.tail_node)
            if (isinstance(p, SnapshotHandle) and p.live
                    and p.tokens >= match.tokens + avail):
                payload, tail = p, avail
        if payload is None:
            payload = match.payload
        if payload is None:
            return 0, None, 0
        reuse = max(0, min(match.tokens + tail - plen, L - 1))
        # the one-token-always-computes clamp may land the resumption point
        # back inside the tail; only the tokens actually skipped past the
        # page boundary are worth copying in the memory plane
        tail = max(0, min(tail, reuse - (match.tokens - plen)))
        return (reuse, payload, tail) if reuse else (0, None, 0)

    def _plan_point_captures(self, st: _SlotPrefill, reuse: int) -> None:
        """Where a point stack on the ring path captures its state
        (page-aligned absolute boundaries, DESIGN.md §8): at this request's
        own match boundary — so the next borrower skips what this one had
        to recompute — and at the prompt's last page boundary. Boundaries
        the seeded prefix covers, or that an attention ring could not
        replay from, are skipped."""
        plen = self.backend.prefix_len()
        pt = self.ecfg.page_tokens
        end_b = ((plen + len(st.tokens)) // pt) * pt
        match_b = st.match.tokens if st.match is not None else 0
        if (match_b > plen and match_b - plen > reuse
                and match_b - plen <= len(st.tokens) - 1
                and self._point_boundary_ok(match_b)):
            st.snap_match_at = match_b - plen
        # skipped only when the match capture covers that exact boundary
        if (end_b > plen and end_b - plen > reuse
                and (end_b - plen) != st.snap_match_at
                and self._point_boundary_ok(end_b)):
            st.snap_end_at = end_b - plen

    def _point_boundary_ok(self, boundary: int) -> bool:
        """A point capture at absolute position ``boundary`` is replayable
        iff every attention ring still holds what a resumed borrower
        attends: a ring of a full window always does; a global or
        window-truncated ring must hold all of [0, boundary)."""
        from repro_torch.models.attention import cache_len_for
        for spec in self.cfg.layer_specs():
            if spec.kind == "ssm":
                continue
            ring = cache_len_for(spec.window, self.ecfg.max_cache_len)
            if spec.window is not None and spec.window <= ring:
                continue
            if boundary > ring:
                return False
        return True

    def _admit(self, slot: int, req: Request) -> _SlotPrefill:
        ecfg = self.ecfg
        toks, chunk, key = self._prep(req)
        self._prep_cache.pop(req.request_id, None)
        match = None
        reuse, snap, tail = 0, None, 0
        if ecfg.prefix_caching:
            match = self.kv.match_prefix(key)
            reuse, snap, tail = self._compute_reuse(match, toks)
        grid = ecfg.page_tokens if self.snapshot_kind == "point" else None
        st = _SlotPrefill(req=req, tokens=toks, chunk=chunk,
                          key=key, match=match, done=reuse, grid=grid)
        if key is not None and self.snapshot_kind == "point" and not self.paged:
            # the paged plane keeps point state in its state pages at every
            # page boundary; the ring path captures it where planned
            self._plan_point_captures(st, reuse)
        if reuse:
            # the hit is real in the compute plane: the ring path seeds the
            # slot from the donor snapshot (a whole cache-tree copy); the
            # paged plane splices the matched pages into the table below
            if snap is not None:
                self.backend.seed_slot(slot, snap.caches)
            self.prefix_compute_hits += 1
            self.prefill_tokens_skipped += reuse
            req.prompt_pos = min(reuse, req.prompt_len)
        # open (and pin) the KV session at admission so matched radix
        # nodes cannot be evicted between planning and execution; the
        # compute-vetted tail is copied into the session's own page there
        self.kv.open_session(req.request_id, match=match, tail_tokens=tail)
        if self.paged and tail:
            # the memory plane just copied the tail into the session's own
            # open page; mirror it on the compute plane — the ONLY copy a
            # paged hit performs, and only for mid-page resumption
            src = match.tail_node.pages[0].compute_page
            dst = self.kv.sessions[req.request_id].pages[-1].compute_page
            if src is not None and dst is not None:
                self.backend.copy_page_rows(src, dst, tail)
        self._inflight[slot] = st
        self.sched.mark_prefilling(slot)
        return st

    def _plan_step(self) -> StepPlan:
        """Scheduler half of the step: in-flight chunked prefills continue
        first, then new admissions fill the remaining prefill budget —
        preferring queued requests that share a hot prefix."""
        plan = StepPlan()
        if self.ecfg.abandon_after_s is not None:
            self.sched.abandon_timed_out(self.mem.now,
                                         self.ecfg.abandon_after_s)
        prefix_len = self.backend.prefix_len()
        budget = self.ecfg.max_prefills_per_step
        for slot in sorted(self._inflight):
            if budget <= 0:
                break
            plan.prefill.append(self._inflight[slot].next_chunk(slot, prefix_len))
            budget -= 1
        if budget > 0:
            match_len = (self._sched_match_len if self.ecfg.prefix_caching
                         else None)
            for slot, req in self.sched.admissions(limit=budget,
                                                   match_len=match_len,
                                                   now=self.mem.now):
                st = self._admit(slot, req)
                plan.prefill.append(st.next_chunk(slot, prefix_len))
                budget -= 1
        plan.decode = self.sched.decode_slots()
        return plan

    def _sched_match_len(self, req: Request) -> int:
        _, _, key = self._prep(req)
        return self.kv.match_len(key)

    # -- ring snapshots (the ring path's compute-plane reuse) ------------
    def _publish_snapshot(self, caches, kind: str,
                          tokens: int) -> Optional[SnapshotHandle]:
        """Carve a donor ring snapshot out of the KV tier budget (a metered
        write of its actual bytes). Without headroom nothing is published:
        the prefix still shares pages, it just cannot donate compute."""
        nbytes = float(sum(a.numel() * a.element_size()
                           for a in tree_leaves(caches)))
        rid = self.mem.write_region(self.ecfg.kv_tier, "kv:snapshot", nbytes,
                                    expected_lifetime_s=self.ecfg.expected_session_s)
        if rid is None:
            return None
        self.snapshots_published += 1
        return SnapshotHandle(caches, nbytes, self.mem, rid, kind=kind,
                              tokens=tokens)

    def _donation_fn(self, st: _SlotPrefill, slot: int):
        """The payload factory a finished prompt registers with its prefix
        (the manager resolves it only if the deepest node's payload slot is
        free, so a snapshot region is never written for nothing). On the
        ring path a positional stack donates the slot's final rings, valid
        for any shorter page-aligned borrower by position masking — unless
        the prompt wrapped the smallest ring (the early positions a shorter
        borrower needs are gone; pages still publish for memory-plane
        reuse); a point stack donates the state captured at the prompt's
        last page boundary, when its prefill passed one. The paged plane
        donates nothing: its pages are the state."""
        plen = self.backend.prefix_len()
        if self.paged:
            return None
        if self.snapshot_kind == "point":
            if st.point_caches is None or st.snap_end_at is None:
                return None
            caches, tokens = st.point_caches, plen + st.snap_end_at
            return lambda: self._publish_snapshot(caches, "point", tokens)
        if plen + len(st.tokens) > self._min_ring_len():
            return None
        return lambda: self._publish_snapshot(self.backend.snapshot_slot(slot),
                                              "positional", plen + len(st.tokens))

    def _attach_match_snapshot(self, st: _SlotPrefill, slot: int) -> None:
        """Observed-share capture (point stacks): this request matched a
        prefix in the memory plane but found no point snapshot at its
        boundary, so it recomputed the shared run; now that its prefill
        stands exactly there, hang the state on the matched node (pinned by
        this session), so the next borrower skips it."""
        node = st.match.node if st.match is not None else None
        if node is None or node.parent is None or node.payload is not None:
            return
        handle = self._publish_snapshot(self.backend.snapshot_slot(slot), "point",
                                        self.backend.prefix_len() + st.done)
        if handle is not None:
            node.payload = handle

    def live_snapshot_bytes(self) -> float:
        """Bytes of metered donor snapshots resident in the KV tier."""
        return sum(n.payload.nbytes for n in self.kv.radix.nodes()
                   if isinstance(n.payload, SnapshotHandle) and n.payload.live)

    # -- cross-replica migration ----------------------------------------
    def _snapshot_compatible(self, caches) -> bool:
        """A foreign ring snapshot is seedable only when its tree matches
        this backend's per-slot cache template exactly (identical
        replicas): the same containers, and each leaf a tensor of the
        slot's shape (slot axis 1) and dtype. The template is taken once
        from the resident rings."""
        if self._snap_spec is None:
            self._snap_spec = [((a.shape[0], 1) + tuple(a.shape[2:]), a.dtype)
                               for a in tree_leaves(self.backend.caches)]
        if not tree_same_structure(caches, self.backend.caches):
            return False
        return all(isinstance(a, torch.Tensor) and tuple(a.shape) == shape
                   and a.dtype == dtype
                   for a, (shape, dtype) in zip(tree_leaves(caches), self._snap_spec))

    def export_prefix(self, key_tokens) -> Optional[dict]:
        """Donor half of a cross-replica prefix migration: match the
        longest published prefix of ``key_tokens`` (position-space), read
        its pages and covering snapshot out of this replica's tiers
        (metered reads — the transfer is not free for the donor), and
        return the page metadata with the compute state for the receiver:
        the matched compute pages on the paged plane, the covering ring
        snapshot on the ring path, each as host tensors."""
        if not self.ecfg.prefix_caching:
            return None
        # non-bumping walk: a migration probe is not local reuse — it must
        # not feed the donor's hit counts / hot promotion / LRU order
        m = self.kv.radix.match(key_tokens, self.mem.now,
                                bump_hits=False, bump_lru=False)
        if m.tokens == 0:
            return None
        kv_bytes = 0.0
        for p in m.pages:
            # paged point stacks: the page's region also carries its
            # recurrent-state snapshot, which the transfer ships too
            nb = p.n_tokens * self.kv.kv_bytes_token + self.kv.state_bytes_page
            if p.region_id is not None and nb > 0:
                self.mem.read_region(p.region_id, nb, sequential=True)
            kv_bytes += nb
        # per-kind snapshot resolution (DESIGN.md §8): positional — the
        # nearest payload below the match covers it via position masking;
        # point — the deepest snapshot at a boundary the match covers
        if self.snapshot_kind == "point":
            handle = self._point_snapshot_for(m.node, m.tokens)
        else:
            handle = (m.payload if isinstance(m.payload, SnapshotHandle)
                      and m.payload.live else None)
        caches, snap_bytes, skind, stok = None, 0.0, "positional", 0
        if handle is not None:
            self.mem.read_region(handle.region_id, handle.nbytes)
            caches = tree_map(lambda a: a.detach().to("cpu", copy=True),
                              handle.caches)
            snap_bytes, skind, stok = handle.nbytes, handle.kind, handle.tokens
        out = {"tokens": np.asarray(key_tokens)[:m.tokens],
               "n_tokens": m.tokens, "kv_bytes": kv_bytes,
               "caches": caches, "snapshot_bytes": snap_bytes,
               "snap_kind": skind, "snap_tokens": stok,
               "hot": m.node.hot, "hits": m.node.hits}
        if self.paged:
            # paged plane: the pages themselves are the compute state — ship
            # the matched compute pages (the metering above charged them)
            ids = [p.compute_page for p in m.pages]
            if all(i is not None for i in ids):
                out["page_data"] = self.backend.export_pages(ids)
                out["page_tokens"] = self.kv.page_tokens
        return out

    def import_prefix(self, tokens, caches=None, hot: bool = False,
                      hits: int = 0, snap_kind: str = "positional",
                      snap_tokens: int = 0, page_data=None,
                      page_tokens: Optional[int] = None) -> dict:
        """Receiver half: adopt the pages (metered writes into this
        replica's tiers; a donor-hot prefix lands in the hot tier with long
        retention) and take the donor's compute state onto this device.

        Paged receivers write ``page_data`` straight into the pool pages
        the adoption allocated — a later local hit on the grafted prefix is
        then a zero-copy page-table splice. Ring receivers re-publish the
        ``caches`` snapshot under a locally metered handle; a *point*
        snapshot only when the adoption kept every token up to its
        boundary (DESIGN.md §8). Data that does not match this replica's
        page geometry or cache families is rejected *before* adoption."""
        if self.paged:
            if (page_data is None or page_tokens != self.kv.page_tokens
                    or not self.backend.pages_compatible(page_data)):
                return {"new_tokens": 0, "total_tokens": 0,
                        "snapshot_bytes": 0.0}
            new_tokens, total, node = self.kv.adopt_prefix(tokens, hot=hot,
                                                           hits=hits)
            inserted = self.kv._last_adopt_pages
            if inserted:
                # the graft kept pages [dup, total) — slice the donor data
                # to the pages actually inserted and write them in place
                pt = self.kv.page_tokens
                dup_pages = (total - new_tokens) // pt
                ids = [p.compute_page for p in inserted]
                data = tree_map(lambda a: a[:, dup_pages:dup_pages + len(ids)],
                                page_data)
                self.backend.import_pages(ids, data)
            return {"new_tokens": new_tokens, "total_tokens": total,
                    "snapshot_bytes": 0.0}
        new_tokens, total, node = self.kv.adopt_prefix(tokens, hot=hot,
                                                       hits=hits)
        snap_bytes = 0.0
        if (node is not None and node.payload is None and caches is not None
                and tfm.supports_extend(self.cfg)
                and (snap_kind != "point" or 0 < snap_tokens <= total)
                and self._snapshot_compatible(caches)):
            handle = self._publish_snapshot(
                tree_map(lambda a: a.to(self.device, copy=True), caches),
                snap_kind, snap_tokens)
            if handle is not None:
                node.payload = handle
                snap_bytes = handle.nbytes
        return {"new_tokens": new_tokens, "total_tokens": total,
                "snapshot_bytes": snap_bytes}

    # -- paged compute plane (DESIGN.md §10) ---------------------------
    def _on_page_alloc(self, page) -> None:
        page.compute_page = self.backend.alloc_page()

    def _on_page_release(self, page) -> None:
        if page.compute_page is not None:
            self.backend.free_page(page.compute_page)
            page.compute_page = None

    def _session_table(self, rid: int) -> np.ndarray:
        """The request's compute-page table, padded with null page 0 to the
        power-of-2 width bucket. Table slot j covers absolute positions
        [j*page_tokens, (j+1)*page_tokens) — shared radix pages appear at
        the same slots for every borrower (zero-copy hit)."""
        pages = self.kv.sessions[rid].pages
        W = self.backend.table_width(len(pages))
        tbl = np.zeros((W,), np.int32)
        for j, p in enumerate(pages):
            tbl[j] = p.compute_page if p.compute_page is not None else 0
        return tbl

    def _decode_tables(self, slots: List[int]) -> tuple:
        """(B, W) compute-page tables for a decode round (inactive rows
        all-null) plus the audit list: compute pages resident in sessions
        that are NOT decoding this round and not shared with one that is."""
        B = self.ecfg.max_slots
        rows, own = {}, set()
        for slot in slots:
            rid = self.sched.active[slot].request_id
            rows[slot] = self._session_table(rid)
            own.update(int(p) for p in rows[slot])
        W = max(r.shape[0] for r in rows.values()) if rows else 1
        tables = np.zeros((B, W), np.int32)
        for slot, r in rows.items():
            tables[slot, :r.shape[0]] = r
        audit = None
        if self.ecfg.audit_decode_masking:
            audit = sorted({
                int(p.compute_page) for s in self.kv.sessions.values()
                for p in s.pages
                if p.compute_page is not None and p.compute_page not in own})
        return tables, audit

    def _meter_paged_reads(self, rid: int, q0: int, q1: int) -> None:
        """Meter the paged kernel's page-gather read stream for one step of
        request ``rid`` whose queries occupy absolute positions [q0, q1):
        a global layer streams every page up to the last query's page; a
        windowed layer skips pages wholly below every query's window; a
        point layer pulls exactly one recurrent-state snapshot. Bytes are
        charged at the accounting scale per layer, against each page's
        actual tier."""
        with TRACER.span("memplane.meter_reads", rid) if TRACER.on else NOOP:
            pages = self.kv.sessions[rid].pages
            pt = self.kv.page_tokens
            hi = -(-q1 // pt)  # pages the kernel gathers: [lo_layer, hi)
            rs = q0 // pt - 1 if q0 % pt == 0 else q0 // pt  # state-read slot
            page_bytes = [0.0] * len(pages)
            for lb, w, sb in self._acct_layers:
                if lb:
                    lo = 0 if w is None else max(0, q0 - w + 1) // pt
                    for j in range(lo, min(hi, len(pages))):
                        page_bytes[j] += pt * lb
                if sb and 0 <= rs < len(pages):
                    page_bytes[rs] += sb
            self.kernel_read_bytes += self.kv.read_pages(rid, page_bytes)

    def _inject_faults(self, slots: List[int]) -> None:
        """Reliability-plane injection point (DESIGN.md §11): before the
        decode kernel gathers its pages, visit every page of every decoding
        session and let the fault injector act on its tracked region's age.
        Near-deadline pages under an active ECC profile scrub-on-read
        (corrected + re-armed, metered through the lifecycle); otherwise
        sampled flips land in the compute page in place — drawn on the
        host from the page's geometry alone, XORed into only the flipped
        words on the device — so corruption propagates through the real
        decode math."""
        if self.faults is None or not self.paged:
            return
        from repro_torch.core.faults import dtype_name, xor_words_
        protected = getattr(self.mem, "ecc_profile", "off") != "off"
        for slot in slots:
            rid = self.sched.active[slot].request_id
            sess = self.kv.sessions.get(rid)
            if sess is None:
                continue
            for page in sess.pages:
                if page.region_id is None or page.compute_page is None:
                    continue
                r = self.mem.region(page.region_id)
                if r is None:
                    continue
                self.faults.stats.pages_visited += 1
                # scrub-on-read is retention servicing: with --no-refresh
                # (service_refresh=False) the controller neither refreshes
                # nor scrubs, so over-aged corruption lands un-corrected
                if (protected and self.mem.service_refresh
                        and self.faults.wants_scrub(r)):
                    if self.kv.lifecycle.scrub(page):
                        self.faults.note_scrub()
                        continue
                # one page of a leaf is pool[:, pid], (repeats, ...): its
                # flat words are those of the JAX package's exported page
                for a in tree_leaves(self.backend.paged_caches):
                    page_words = a[:, int(page.compute_page)]
                    flips, _ = self.faults.sample(page_words.numel(),
                                                  a.element_size(), dtype_name(a),
                                                  r, protected)
                    if flips is not None:
                        xor_words_(page_words, flips)

    def _account_chunk_kv(self, ck: PrefillChunk) -> None:
        """This chunk's tokens enter the paged KV — unless a shared prefix
        already holds them (prefix reuse is counted once at open)."""
        target = ck.offset + len(ck.tokens)  # kv tokens incl. meta/frontend
        cur = self.kv.sessions[ck.request_id].tokens
        if target > cur:
            self.kv.append_tokens(ck.request_id, target - cur)

    # ------------------------------------------------------------------
    def step(self) -> dict:
        """One engine step: prefill chunks + one decode round, metered."""
        with TRACER.span("engine.step") if TRACER.on else NOOP:
            with TRACER.span("engine.plan") if TRACER.on else NOOP:
                plan = self._plan_step()
            if TRACER.on:
                TRACER.annotate(chunks=len(plan.prefill), rows=len(plan.decode))
            self.memplane.begin_step()
            rpt = StepReport()
            first_token_reqs: List[Request] = []

            # --- prefill phase (whole prompts or chunks) --------------
            for ck in plan.prefill:
                with (TRACER.span("engine.prefill", ck.request_id,
                                  tokens=len(ck.tokens), offset=ck.offset)
                      if TRACER.on else NOOP):
                    self._step_prefill(ck, rpt, first_token_reqs)

            # --- decode round -----------------------------------------
            if plan.decode:
                with (TRACER.span("engine.decode", rows=len(plan.decode))
                      if TRACER.on else NOOP):
                    self._step_decode(plan.decode, rpt)

            # --- advance simulated time by the modelled step latency --
            step_s, per_tier = self.memplane.finish_step()
            self.mem.advance(step_s)
            # the first token is out when the step that computed it completes
            for req in first_token_reqs:
                req.first_token_at = self.mem.now
            with TRACER.span("kv.maintain") if TRACER.on else NOOP:
                self.kv.maintain()   # cold-leaf decay runs on the advanced clock
            self.steps += 1
            rpt.step_s = step_s
            rpt.bytes_by_tier = per_tier
            return {"step_s": step_s, "bytes": rpt.bytes,
                    "bytes_by_tier": rpt.bytes_by_tier,
                    "prefill_tokens": rpt.prefill_tokens,
                    "decode_tokens": rpt.decode_tokens,
                    "finished": rpt.finished,
                    "active": len(self.sched.active),
                    "queued": len(self.sched.queue)}

    def _step_prefill(self, ck: PrefillChunk, rpt: StepReport,
                      first_token_reqs: List[Request]) -> None:
        """One prefill chunk of a step: its KV pages, the model call, the
        metering, and the request's progress."""
        st = self._inflight[ck.slot]
        if self.paged:
            # pages must exist BEFORE compute: the kernel writes this
            # chunk's KV into the session's own pages in place
            with TRACER.span("kv.append_tokens", ck.request_id) if TRACER.on else NOOP:
                self._account_chunk_kv(ck)
            with (TRACER.span("engine.session_table", ck.request_id)
                  if TRACER.on else NOOP):
                table = self._session_table(ck.request_id)
            tok = self.backend.run_prefill_chunk(ck, page_table=table)
            self.memplane.weight_pass()
            # meter the kernel's actual page-gather stream: queries at
            # [q0, q1) — the first chunk's oldest query is position 0
            q0 = 0 if ck.first else ck.offset
            self._meter_paged_reads(ck.request_id, q0,
                                    ck.offset + len(ck.tokens))
        else:
            tok = self.backend.run_prefill_chunk(ck, page_table=None)
            self.memplane.weight_pass()
            with TRACER.span("kv.append_tokens", ck.request_id) if TRACER.on else NOOP:
                self._account_chunk_kv(ck)
        self.prefill_chunks_run += 1
        self.sched.stats.prefill_chunks += 1
        st.done += len(ck.tokens)
        st.req.prompt_pos = min(st.done, st.req.prompt_len)
        # point stacks: the state is capturable only at the boundary
        # itself (chunks end on the page grid, so they land there)
        if st.snap_match_at is not None and st.done == st.snap_match_at:
            self._attach_match_snapshot(st, ck.slot)
            st.snap_match_at = None
        if (st.snap_end_at is not None and st.done == st.snap_end_at
                and st.point_caches is None):
            st.point_caches = self.backend.snapshot_slot(ck.slot)
        rpt.prefill_tokens += len(ck.tokens)
        self.prefill_tokens_computed += len(ck.tokens)
        if ck.last:
            req = st.req
            req.prefilled_at = self.mem.now
            first_token_reqs.append(req)
            self.outputs[req.request_id].append(int(np.asarray(tok).flat[0]))
            req.generated += 1
            self.tokens_generated += 1
            if st.key is not None:
                self.kv.register_prefix(req.request_id, st.key,
                                        payload=self._donation_fn(st, ck.slot))
            self.sched.mark_decoding(ck.slot)
            del self._inflight[ck.slot]

    def _step_decode(self, slots: List[int], rpt: StepReport) -> None:
        """The decode round of a step over ``slots``: each session's new
        row, the model call, the tokens out, the metering, the finished
        requests."""
        if self.paged:
            # the new token's page must exist before the kernel writes
            # its KV row in place
            with TRACER.span("kv.append_tokens", rows=len(slots)) if TRACER.on else NOOP:
                for slot in slots:
                    self.kv.append_tokens(self.sched.active[slot].request_id, 1)
            with TRACER.span("engine.inject_faults") if TRACER.on else NOOP:
                self._inject_faults(slots)
            with TRACER.span("engine.decode_tables") if TRACER.on else NOOP:
                tables, audit = self._decode_tables(slots)
            next_np = self.backend.run_decode(slots, page_tables=tables,
                                              audit_pages=audit)
        else:
            next_np = self.backend.run_decode(slots)
        self.memplane.weight_pass()
        finished: List[int] = []
        with TRACER.span("engine.emit", rows=len(slots)) if TRACER.on else NOOP:
            for slot in slots:
                req = self.sched.active[slot]
                tok = next_np[slot]
                self.outputs[req.request_id].append(int(np.asarray(tok).flat[0]))
                req.generated += 1
                self.tokens_generated += 1
                rpt.decode_tokens += 1
                self.sched.stats.decode_tokens += 1
                if self.paged:
                    # one query at the just-written position: the kernel
                    # gathered the session's pages
                    p = int(self.backend.positions[slot])
                    self._meter_paged_reads(req.request_id, p, p + 1)
                else:
                    self.kv.read_all(req.request_id)
                    self.kv.append_tokens(req.request_id, 1)
                done = (req.generated >= req.max_new_tokens or
                        (self.cfg.n_codebooks == 1 and
                         int(np.asarray(tok).flat[0]) == self.ecfg.eos_token))
                if done:
                    finished.append(slot)
        with TRACER.span("engine.finish", rows=len(finished)) if TRACER.on else NOOP:
            for slot in finished:
                req = self.sched.finish(slot, self.mem.now)
                self.kv.close_session(req.request_id)
                self.backend.free_slot(slot)
                rpt.finished += 1

    # ------------------------------------------------------------------
    def run_until_idle(self, max_steps: int = 10000,
                       on_stall: str = "raise") -> dict:
        """Step until the scheduler drains. Exhausting ``max_steps`` with
        work still queued/resident raises
        :class:`~repro_torch.serving.events.NonQuiescentError`, or — with
        ``on_stall="report"`` — returns the report with ``quiesced=False``."""
        from repro_torch.serving.events import NonQuiescentError
        start = self.steps
        while not self.sched.idle and self.steps - start < max_steps:
            self.step()
        rep = self.report()
        if not self.sched.idle and on_stall != "report":
            raise NonQuiescentError(
                f"engine not quiescent after {max_steps} steps: "
                f"{len(self.sched.queue)} queued, "
                f"{len(self.sched.active)} resident", rep)
        return rep

    def report(self) -> dict:
        rep = self.memplane.report()
        total_energy = rep["total_energy_j"]
        # steady-state read:write ratio: exclude the one-time model-deploy
        # write
        reads = sum(d.stats.read_bytes for d in self.mem.devices.values())
        writes = sum(d.stats.write_bytes for d in self.mem.devices.values())
        steady_writes = max(writes - self.weight_bytes, 1e-9)
        snapshot_bytes = self.live_snapshot_bytes()
        prefix = self.kv.prefix_report()
        prefix["compute_hits"] = self.prefix_compute_hits
        prefix["tokens_skipped_compute"] = self.prefill_tokens_skipped
        prefix["snapshot_kind"] = self.snapshot_kind
        prefix["hot_tier"] = self.memplane.hot_tier
        prefix["snapshots_published"] = self.snapshots_published
        prefix["snapshot_bytes"] = snapshot_bytes
        return {
            "steps": self.steps,
            "kernel_read_bytes": self.kernel_read_bytes,
            "seed_copy_bytes": self.backend.seed_copy_bytes,
            "tokens_generated": self.tokens_generated,
            "finished": self.sched.stats.finished,
            "abandoned": self.sched.stats.abandoned,
            "quiesced": self.sched.idle,
            "pending_requests": len(self.sched.queue) + len(self.sched.active),
            "sim_time_s": self.mem.now,
            "tokens_per_s": self.tokens_generated / max(self.mem.now, 1e-9),
            "energy_per_token_j": total_energy / max(self.tokens_generated, 1),
            "steady_rw_ratio": reads / steady_writes,
            "memory": rep,
            "kv_live_pages": self.kv.live_pages(),
            "snapshot_bytes": snapshot_bytes,
            "dropped_allocs": self.kv.dropped_allocs,
            "pressure": self.kv.pressure_report(),
            "prefill_chunks": self.prefill_chunks_run,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefill_tokens_skipped": self.prefill_tokens_skipped,
            "prefix_hits": self.kv.prefix_hits,
            "prefix_tokens_reused": self.kv.prefix_tokens_reused,
            "prefix": prefix,
            "latency": latency_percentiles(self.sched.latency),
            "reliability": self._reliability_report(),
        }

    def _reliability_report(self) -> dict:
        """The reliability plane's ledger (DESIGN.md §11): ECC profile,
        per-tier check-bit / scrub traffic, and — when injection is on —
        the fault injector's flip/correction/uncorrectable counters."""
        out = {
            "ecc_profile": getattr(self.mem, "ecc_profile", "off"),
            "tiers": {
                n: {"ecc_read_bytes": d.stats.ecc_read_bytes,
                    "ecc_write_bytes": d.stats.ecc_write_bytes,
                    "scrub_read_bytes": d.stats.scrub_read_bytes,
                    "n_scrubs": d.stats.n_scrubs,
                    "scrub_rewrites": d.wear.scrub_rewrites}
                for n, d in self.mem.devices.items()},
        }
        if self.faults is not None:
            out["injection"] = self.faults.stats.as_dict()
            out["inject_rber"] = self.faults.rber
        return out


def latency_percentiles(records: List[dict]) -> dict:
    """TTFT/ITL percentiles over finished-request latency records."""
    out = {"n": len(records)}
    ttft = [r["ttft"] for r in records if r["ttft"] is not None]
    itl = [r["itl"] for r in records if r["itl"] is not None]
    for name, xs in (("ttft", ttft), ("itl", itl)):
        for p in (50, 95, 99):
            out[f"{name}_p{p}"] = (float(np.percentile(xs, p)) if xs else None)
    return out
