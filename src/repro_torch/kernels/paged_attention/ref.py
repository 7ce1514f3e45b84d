"""Plain PyTorch version of ragged paged attention, plus the paged-plane
layout helpers the models share — the port of ``repro.kernels.
paged_attention.ref``. The CPU path and the oracle the Hopper kernel is
held against.

Layout contract (DESIGN.md §10): the unit of KV storage is a *page* of
``page_size`` consecutive token positions with K and V fused
head-interleaved —

    kv_pages: (n_pages, page_size, 2 * n_kv_heads, head_dim)

where head ``h``'s key rows sit at index ``2*h`` and its value rows at
``2*h + 1``. A sequence is a row of a ``page_table`` (int32 page ids):
table slot ``j`` covers absolute positions ``[j*page_size,
(j+1)*page_size)``, so key positions are derived from the slot index. Null
table entries (page id 0, the reserved all-zeros page) are masked wherever
they sit.

The attention core scans the table one page at a time with an online
softmax whose accumulator is *exactly* invariant to trailing padding
pages (a fully-masked page contributes p == 0 and a rescale factor of 1),
so outputs are bit-identical across page-table widths.

An optional ``kv_pos_pages`` (n_pages, page_size) int32 plane overrides
the slot-derived positions (-1 = empty row), with explicit query
positions beside it; page 0 is then a page like any other. This is how a
ring cache reads through the same kernel (``repro_torch.kernels.
decode_attention``).

``v_from_k=True`` reads a single-plane pool ``(n_pages, page_size, 1, D)``
in which a row's value is its key: one KV head, the MLA ring's stored
``[c, kr]`` row. Against the two-plane latent pages (K' = [c, kr], V' =
[c, 0]) the output's first ``D - dr`` lanes are the same bits (each
output lane sums over its own value column alone); the last ``dr`` carry
P·kr where the two-plane read gives 0, and every caller drops them.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Layout helpers (the write half of the paged compute plane)
# ---------------------------------------------------------------------------


def interleave_kv(k, v):
    """(B, S, Hkv, D) k/v -> fused head-interleaved (B, S, 2*Hkv, D):
    head h's key at index 2h, its value at 2h+1."""
    B, S, Hkv, D = k.shape
    return torch.stack([k, v], dim=3).reshape(B, S, 2 * Hkv, D)


def split_kv(kv):
    """Inverse of :func:`interleave_kv`: (..., 2*Hkv, D) -> (k, v)."""
    return kv[..., 0::2, :], kv[..., 1::2, :]


def write_tokens_to_pages(kv_pages, kv_new, positions, page_table,
                          active=None):
    """Scatter fused-KV rows into the paged plane, IN PLACE.

    kv_pages: (P, ps, 2*Hkv, D) pool; kv_new: (B, S, 2*Hkv, D);
    positions: (B, S) absolute token positions; page_table: (B, W) int32.
    Rows whose position falls past the table width, or whose ``active``
    flag is False, are written nowhere — a mid-prefill slot's pages are
    never clobbered by a batched decode write. JAX drops them through an
    out-of-bounds scatter index (``mode="drop"``); torch has no such mode,
    so they are masked out before the write. A row is never written to
    the null page 0 nor past the pool. Returns ``kv_pages``."""
    P, ps = kv_pages.shape[0], kv_pages.shape[1]
    positions = positions.to(torch.int64)
    W = page_table.shape[1]
    slot = torch.div(positions, ps, rounding_mode="floor")  # (B, S) table slots
    row = positions - slot * ps
    ok = (positions >= 0) & (slot < W)
    if active is not None:
        ok &= active.to(torch.bool).reshape(-1, 1)
    pid = torch.gather(page_table.to(torch.int64), 1, slot.clamp(0, W - 1))
    ok &= (pid > 0) & (pid < P)
    sel = ok.nonzero(as_tuple=True)   # one host sync for the three gathers
    kv_pages[pid[sel], row[sel]] = kv_new[sel].to(kv_pages.dtype)
    return kv_pages


# ---------------------------------------------------------------------------
# The attention core: rows form
# ---------------------------------------------------------------------------


def paged_attention_rows(q, kv_pages, page_table, q_pos, *, scale: float,
                         cap: Optional[float] = None,
                         window: Optional[int] = None,
                         kv_pos_pages=None, v_from_k: bool = False):
    """Row-flattened paged attention.

    q: (R, Hq, D) query rows; kv_pages: (P, ps, 2*Hkv, D), or with
    ``v_from_k`` (P, ps, 1, D) read as key and value at once; page_table:
    (R, W) int32 per-row tables; q_pos: (R,) absolute query positions.
    Key positions derive from the table slot, or with ``kv_pos_pages``
    (P, ps) come from that plane (-1: an empty row). Returns (R, Hq, D) in
    the pool dtype.

    The page loop keeps a per-row online softmax in fp32; masked pages
    (padding, future positions, outside the window, null page 0 of a
    slot-derived table, empty rows) contribute exactly zero and leave the
    accumulator bit-identical."""
    R, Hq, D = q.shape
    ps, H2 = kv_pages.shape[1], kv_pages.shape[2]
    Hkv = H2 if v_from_k else H2 // 2
    G = Hq // Hkv
    W = page_table.shape[1]
    dev = q.device
    qf = q.float().reshape(R, Hkv, G, D)
    qpos = q_pos.to(torch.int64)
    page_table = page_table.to(torch.int64)

    m = torch.full((R, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((R, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((R, Hkv, G, D), dtype=torch.float32, device=dev)
    offs = torch.arange(ps, dtype=torch.int64, device=dev)
    for j in range(W):
        pid = page_table[:, j]                           # (R,)
        kv = kv_pages[pid]                               # (R, ps, 2Hkv, D)
        k = kv[:, :, 0::2, :].float()                    # (R, ps, Hkv, D)
        v = k if v_from_k else kv[:, :, 1::2, :].float()
        if kv_pos_pages is not None:
            kpos = kv_pos_pages[pid].to(torch.int64)     # (R, ps)
        else:
            kpos = (j * ps + offs)[None].expand(R, ps)
        s = torch.einsum("rhgd,rphd->rhgp", qf, k) * scale
        if cap is not None:
            s = torch.tanh(s / cap) * cap
        valid = (kpos >= 0) & (kpos <= qpos[:, None])
        if window is not None:
            valid &= kpos > (qpos[:, None] - window)
        if kv_pos_pages is None:
            # page 0 is the null page: a null slot *inside* the causal
            # range (sparse tables) holds no keys and must mask
            valid &= (pid != 0)[:, None]
        vmask = valid[:, None, None, :]                  # (R, 1, 1, ps)
        s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # explicit zeroing (not just exp of NEG_INF): when every page so
        # far was masked, m_new == NEG_INF and exp(s - m_new) would be 1
        p = torch.where(vmask, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("rhgp,rphd->rhgd", p, v)
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / l_safe[..., None]
    return out.reshape(R, Hq, D).to(kv_pages.dtype)


# ---------------------------------------------------------------------------
# Ragged form (the kernel's plain version)
# ---------------------------------------------------------------------------


def ragged_paged_attention_ref(q, kv_pages, page_table, cu_q_lens, kv_lens,
                               *, scale: float, cap: Optional[float] = None,
                               window: Optional[int] = None,
                               q_pos=None, kv_pos_pages=None,
                               v_from_k: bool = False):
    """Plain version of the ragged kernel.

    q: (T, Hq, D) queries of all sequences concatenated; cu_q_lens:
    (S+1,) int32 cumulative query lengths (T == cu_q_lens[-1]);
    ``page_table`` is (S, W), ``kv_lens`` (S,). Query i of sequence s sits
    at absolute position ``kv_lens[s] - q_len_s + i`` unless an explicit
    ``q_pos`` (T,) is given, with the key positions ``kv_pos_pages`` (P,
    ps) beside it; ``v_from_k`` reads a single-plane pool (one KV head
    whose value is its key). Decode is every q_len == 1."""
    T = q.shape[0]
    dev = q.device
    cu = cu_q_lens.to(torch.int64)
    kv_lens = kv_lens.to(torch.int64)
    t = torch.arange(T, dtype=torch.int64, device=dev)
    seg = torch.searchsorted(cu[1:], t, right=True)      # (T,) sequence ids
    if q_pos is None:
        q_lens = cu[1:] - cu[:-1]
        q_pos = kv_lens[seg] - q_lens[seg] + t - cu[seg]
    tbl = page_table[seg]                                # (T, W)
    return paged_attention_rows(q, kv_pages, tbl, q_pos, scale=scale,
                                cap=cap, window=window,
                                kv_pos_pages=kv_pos_pages, v_from_k=v_from_k)
