"""Ring-cache attention as a view onto the paged kernel — the port of
``repro.kernels.decode_attention``.

A ring cache holds K and V fused and head-interleaved, (B, C, 2*Hkv, D)
(head h's key at 2h, its value at 2h+1: the page layout), so B rings of C
slots are B contiguous runs of ``C / ps`` pages with no copy; the
stored-position plane (``cache_pos``, -1 for an empty row) supplies the
masking. ``decode_attention`` (one query per sequence) and
``extend_attention`` (S queries per sequence) reshape the rings into pages
and make one call of ``ragged_paged_attention`` in its explicit-position
mode: on CUDA the Hopper kernel, on the CPU its plain version. There is no
other ring read path in the port.

An MLA ring stores its latent row [c, kr] once, (B, C, 1, r + dr): a ring
of one row a token (a fused K/V ring has an even number) is read with
``v_from_k``, one plane whose value is its key (the kernel's single-plane
latent read); the context is the output's first r lanes.

The JAX package keeps K and V apart, (B, C, Hkv, D) each, stacks them per
call and pages a ring at ``min(512, C)`` tokens, or as one page when 512
does not divide C. The port takes the caller's page size (the engine's
``page_tokens``, so a ring and the paged plane walk the same pages in the
same order) and refuses a ring that it does not divide.
"""
from __future__ import annotations

from typing import Optional

import math

import torch

from repro_torch.kernels.paged_attention import ragged_paged_attention
from repro_torch.runtime import sharding as shd


def ring_page_size(C: int, page_size: int) -> int:
    """``page_size``, checked to divide a ring of C slots."""
    if not page_size or page_size < 0 or C % page_size:
        raise ValueError(f"page size {page_size} does not divide the ring "
                         f"length {C}")
    return page_size


def ring_pages(kv_cache, cache_pos, page_size: int):
    """(kv_pages (B*C/ps, ps, H2, D), kv_pos (B*C/ps, ps) int32, page
    table (B, C/ps) int32): sequence b owns pages [b*C/ps, (b+1)*C/ps) in
    ring order. Views of a contiguous ring (H2 = 2*Hkv, or 1 for a latent
    ring)."""
    B, C, H2, D = kv_cache.shape
    n_per = C // ring_page_size(C, page_size)
    kv_pages = kv_cache.reshape(B * n_per, page_size, H2, D)
    kv_pos = cache_pos.to(torch.int32).reshape(B * n_per, page_size)
    table = torch.arange(B * n_per, dtype=torch.int32,
                         device=kv_cache.device).reshape(B, n_per)
    return kv_pages, kv_pos, table


def _attend(q, kv_cache, cache_pos, q_pos, *, scale, cap, window, page_size):
    """q: (B, S, H, D) at absolute positions q_pos (B*S,) int32."""
    if shd.is_dtensor(kv_cache):
        return _attend_sharded(q, kv_cache, cache_pos, q_pos, scale=scale,
                               cap=cap, window=window, page_size=page_size)
    B, S, H, D = q.shape
    C = kv_cache.shape[1]
    kv_pages, kv_pos, table = ring_pages(kv_cache, cache_pos, page_size)
    dev = q.device
    cu = torch.arange(0, (B + 1) * S, S, dtype=torch.int32, device=dev)
    kv_lens = torch.full((B,), C, dtype=torch.int32, device=dev)
    out = ragged_paged_attention(
        q.reshape(B * S, H, D).contiguous(), kv_pages, table, cu, kv_lens,
        scale=scale, cap=cap, window=window, max_q_len=S, q_pos=q_pos,
        kv_pos_pages=kv_pos, v_from_k=kv_cache.shape[2] == 1)
    return out.reshape(B, S, H, D)


def _attend_sharded(q, kv_cache, cache_pos, q_pos, *, scale, cap, window,
                    page_size):
    """The ring view on DTensors. Each mesh dim splits the ring's batch
    (q follows), its heads (q's heads follow) or its slots (flash-decoding:
    q is replicated there, each device attends its slots and the partial
    (out, m, l) are merged over that mesh dim: an all-reduce of (B*S, H,
    D + 2) fp32, which is what the merge moves)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    mesh = kv_cache.device_mesh
    qp, pp, split = [], [], []
    for i, p in enumerate(shd.replicated(kv_cache)):
        if p.is_replicate() or p.is_shard(0):
            qp.append(p), pp.append(p)
        elif p.is_shard(2):
            qp.append(p), pp.append(Replicate())
        elif p.is_shard(1):
            qp.append(Replicate()), pp.append(p), split.append(i)
        else:
            raise NotImplementedError(f"the ring view takes a ring split on batch, "
                                      f"slots or heads, not {p} on mesh dim {i}")
    B, S, H, D = q.shape
    ql = shd.local_of(shd._as_dtensor(q, mesh), qp)
    kvl = kv_cache.to_local()
    posl = shd.local_of(shd._as_dtensor(cache_pos, mesh), pp)
    qpl = q_pos.to_local() if shd.is_dtensor(q_pos) else q_pos
    qpl = qpl[:ql.shape[0] * S].contiguous()
    out = _attend(ql, kvl, posl, qpl, scale=scale, cap=cap, window=window,
                  page_size=math.gcd(page_size, kvl.shape[1]))
    for i in split:
        stats = torch.empty(out.shape[:-1] + (D + 2,), dtype=torch.float32,
                            device=out.device)
        funcol.wait_tensor(funcol.all_reduce(stats, "sum", mesh.get_group(i)))
    return shd.global_of(out, mesh, qp, (B, S, H, D))


def decode_attention(q, kv_cache, cache_pos, cur_pos, *, scale: float,
                     page_size: int, cap: Optional[float] = None,
                     window: Optional[int] = None):
    """q: (B, 1, H, D); kv_cache: (B, C, 2*Hkv, D), or a latent ring (B, C,
    1, D) read as key and value; cache_pos: (B, C) int32; cur_pos: an int,
    a 0-d tensor or (B,). -> (B, 1, H, D)."""
    B = q.shape[0]
    cur = torch.as_tensor(cur_pos, device=q.device).to(torch.int32).reshape(-1)
    q_pos = cur.expand(B).contiguous()
    return _attend(q, kv_cache, cache_pos, q_pos, scale=scale, cap=cap,
                   window=window, page_size=page_size)


def extend_attention(q, kv_cache, cache_pos, qpos, *, scale: float,
                     page_size: int, cap: Optional[float] = None,
                     window: Optional[int] = None):
    """q: (B, S, H, D) queries at absolute positions qpos (S,) of every
    sequence; kv_cache: (B, C, 2*Hkv, D) (or a latent ring, (B, C, 1, D))
    already holding the chunk's own keys; cache_pos: (B, C) int32. -> (B,
    S, H, D)."""
    B, S = q.shape[:2]
    pos = torch.as_tensor(qpos, device=q.device).to(torch.int32).reshape(1, S)
    q_pos = pos.expand(B, S).reshape(B * S).contiguous()
    return _attend(q, kv_cache, cache_pos, q_pos, scale=scale, cap=cap,
                   window=window, page_size=page_size)
