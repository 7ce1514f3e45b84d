"""Self-attention: the paged compute plane (DESIGN.md §10), the ring-cache
path and the training path.

The port of ``repro.models.attention`` carries the parameter definitions,
``chunked_attention`` with its flash backward, the ring-cache functions,
and every mode of ``attention_sublayer``: QKV projection, qk-norm, RoPE,
then

- ``train``: ``chunked_attention`` over the whole unpadded sequence — on
  CUDA one ``FlashAttention`` call (the Hopper forward kernel, and the
  dK/dV and dQ kernels in the backward), on the CPU the plain versions
  chunked as the JAX package chunks;
- ``extend``/``decode`` on KV pages: the in-place KV write into the page
  pool and ragged paged attention (where the JAX package attends through
  the rows form ``paged_attention_rows``, the port calls the ragged form,
  which launches the Hopper kernel on CUDA tensors);
- on a ring cache ``{"kv": (B, C, 2*Hkv, D), "pos": (B, C)}`` (K and V
  fused as in a page, where the JAX package keeps ``k`` and ``v`` apart):
  ``prefill`` attends the first chunk through ``chunked_attention`` (the
  flash forward) and fills the fresh ring; ``extend`` and ``decode`` write
  the new rows at slot ``pos % C`` and attend the whole ring through the
  paged kernel's explicit-position mode (``kernels/decode_attention``),
  where the JAX package attends with jnp einsums;

and the output projection. The ring functions write the cache IN PLACE
and return it (JAX returns a new one).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  extend_attention)
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.paged_attention import (interleave_kv,
                                                 ragged_paged_attention,
                                                 write_tokens_to_pages)
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.param import ParamDef

# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig) -> dict:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, hk, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, hk, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), ("head_dim",), init="zeros")
        defs["k_norm"] = ParamDef((hd,), ("head_dim",), init="zeros")
    return defs


def _q_scale(cfg: ModelConfig) -> float:
    return cfg.q_scale if cfg.q_scale is not None else cfg.resolved_head_dim ** -0.5


def cache_len_for(window: Optional[int], max_len: int) -> int:
    return min(max_len, window) if window is not None else max_len


def _project(x, w):
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd)."""
    B, S, d = x.shape
    return (x.reshape(B * S, d) @ w.reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])


# ---------------------------------------------------------------------------
# Chunked flash attention (training)
# ---------------------------------------------------------------------------


def chunked_attention(q, k, v, *, window: Optional[int] = None,
                      cap: Optional[float] = None, scale: float,
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, H, Dv) in v's
    dtype. Causal self-attention over an unpadded sequence (query i at
    position i), differentiable with the flash backward. ``q_chunk`` and
    ``kv_chunk`` chunk the CPU path as ``repro.models.attention`` chunks;
    the kernels tile on their own."""
    return FlashAttention.apply(q, k, v, scale, cap, window, q_chunk, kv_chunk)


# ---------------------------------------------------------------------------
# Ring caches (decode and extend attention over them: kernels/decode_attention)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               device=None) -> dict:
    """An empty ring: ``{"kv": (B, C, 2*Hkv, D)`` (K and V fused and
    head-interleaved, the page layout, where the JAX package keeps ``k`` and
    ``v`` apart), ``"pos": (B, C)`` int32, -1 marking an empty slot``}``."""
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {"kv": torch.zeros((batch, cache_len, 2 * hk, hd), dtype=dtype,
                              device=device),
            "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                              device=device)}


def fill_cache_from_prefill(cache: dict, k, v) -> dict:
    """Write a maximal first chunk's keys/values (B, S, Hkv, D) — token i at
    position i — into a (possibly smaller, windowed) ring at slot
    ``pos % C``, keeping the last C tokens. In place; returns ``cache``."""
    S, C = k.shape[1], cache["kv"].shape[1]
    take = min(S, C)
    pos = torch.arange(S - take, S, device=k.device)
    slots = pos % C
    cache["kv"][:, slots] = interleave_kv(k[:, S - take:], v[:, S - take:]).to(
        cache["kv"].dtype)
    cache["pos"][:, slots] = pos.to(torch.int32)[None]
    return cache


def write_rows_to_ring(ring, ring_pos, rows, positions) -> None:
    """Write a chunk's fused rows (B, S, H2, D) at absolute positions
    ``positions`` (S,) of every sequence into the ring (B, C, H2, D) at slot
    ``pos % C``, and the positions into ``ring_pos`` (B, C) (a chunk longer
    than the ring would collide with itself). In place."""
    C = ring.shape[1]
    positions = torch.as_tensor(positions, device=rows.device).to(torch.int64)
    slots = positions % C
    ring[:, slots] = rows.to(ring.dtype)
    ring_pos[:, slots] = positions.to(torch.int32)[None]


def append_row_to_ring(ring, ring_pos, row, pos, active=None) -> None:
    """Append one fused row (B, H2, D) at absolute position(s) ``pos`` (a
    scalar or (B,)): row b's slot ``pos[b] % C``. ``active`` ((B,) bool)
    keeps the rows where it is False as they were — a masked write (the
    old row read back where inactive), so no host sync. In place."""
    C, B = ring.shape[1], ring_pos.shape[0]
    dev = ring.device
    pos = torch.as_tensor(pos, device=dev).to(torch.int64).reshape(-1).expand(B)
    slot = pos % C
    idx = torch.arange(B, device=dev)
    new = row.to(ring.dtype)
    p_new = pos.to(torch.int32)
    if active is not None:
        act = active.to(device=dev, dtype=torch.bool)
        new = torch.where(act[:, None, None], new, ring[idx, slot])
        p_new = torch.where(act, p_new, ring_pos[idx, slot])
    ring[idx, slot] = new
    ring_pos[idx, slot] = p_new


def write_chunk_to_cache(cache: dict, k, v, positions) -> dict:
    """Write a chunk's keys/values (B, S, Hkv, D) at absolute positions
    ``positions`` (S,) into the ring (slot = pos % C). In place; returns
    ``cache``."""
    write_rows_to_ring(cache["kv"], cache["pos"], interleave_kv(k, v), positions)
    return cache


def append_to_cache(cache: dict, k1, v1, pos, active=None) -> dict:
    """Append one token (B, 1, Hkv, D) at absolute position(s) ``pos`` (a
    scalar or (B,)); rows where ``active`` is False keep theirs
    (``append_row_to_ring``). In place; returns ``cache``."""
    append_row_to_ring(cache["kv"], cache["pos"], interleave_kv(k1, v1)[:, 0], pos,
                       active=active)
    return cache


# ---------------------------------------------------------------------------
# Full attention sublayer (projections + rope + attention + out-proj)
# ---------------------------------------------------------------------------


def paged_rows(mode: str, B: int, S: int, positions, cur_pos, decode_active,
               device):
    """The ragged layout of a paged step: (positions (B, S) the rows write
    at, the rows allowed to write (None: all), cu_q_lens (B+1,), kv_lens
    (B,)). Extend: every row is one sequence whose S queries sit at
    ``positions``; decode: B sequences of one query at ``cur_pos``."""
    if mode == "decode":
        cur = cur_pos.to(torch.int32).reshape(-1)
        return (cur.reshape(-1, 1), decode_active,
                torch.arange(B + 1, dtype=torch.int32, device=device), cur + 1)
    if mode == "extend":
        pos = positions.to(torch.int32).reshape(S)
        return (pos.reshape(1, S).expand(B, S), None,
                torch.arange(0, (B + 1) * S, S, dtype=torch.int32, device=device),
                (pos[-1:] + 1).expand(B).contiguous())
    raise ValueError(f"no paged mode {mode!r}")


def attention_sublayer(
    cfg: ModelConfig,
    p: dict,
    x,
    *,
    positions,
    window: Optional[int],
    cache: Optional[dict] = None,
    mode: str = "extend",  # train | prefill | extend | decode
    cur_pos=None,
    decode_active=None,   # (B,) bool: rows whose pages the decode may write
    page_table=None,      # (B, W) int32: paged compute plane (DESIGN.md §10)
    page_tokens: Optional[int] = None,   # ring modes: the ring's page size
) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (attn_out (B, S, d), the cache or None).

    Train: causal attention over the whole sequence at ``positions``
    0..S-1, no cache. On pages, ``cache["kv_pages"]`` (P, ps, 2*Hkv, D) is
    written IN PLACE (JAX returns a new pool; here the returned dict holds
    the same tensor). Extend: every row of the batch is one sequence whose
    S queries sit at ``positions`` (offset .. offset+S-1). Decode: B
    sequences of one query at ``cur_pos`` (B,); inactive rows carry
    all-null tables, attend to nothing (output 0, discarded by the caller)
    and write nothing. On a ring cache (no ``page_table``) the same modes
    plus ``prefill`` (the first chunk, positions 0..S-1, into a fresh
    ring); the ring is written IN PLACE, inactive decode rows keep theirs,
    and the kernel reads it as pages of ``page_tokens`` slots."""
    if mode != "train" and cache is None:
        raise ValueError(f"mode {mode!r} needs a cache")
    B, S, d = x.shape
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    Hq, hd = q.shape[2], q.shape[3]
    scale, cap = _q_scale(cfg), cfg.attn_softcap
    if mode in ("train", "prefill"):
        # train and a ring's first chunk share the full-sequence flash path
        # (inputs are never padded, so causal masking is exact); serving
        # records no graph
        with torch.set_grad_enabled(mode == "train" and torch.is_grad_enabled()):
            out = chunked_attention(q, k, v, window=window, cap=cap, scale=scale,
                                    q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        if mode == "prefill":
            fill_cache_from_prefill(cache, k, v)
        out = out.reshape(B * S, Hq * v.shape[3]) @ p["wo"].reshape(-1, d)
        return out.reshape(B, S, d), cache
    if "kv_pages" not in cache:
        if page_table is not None:
            raise ValueError("a ring cache takes no page table")
        if mode == "decode":
            append_to_cache(cache, k, v, cur_pos, active=decode_active)
            out = decode_attention(q, cache["kv"], cache["pos"], cur_pos,
                                   window=window, cap=cap, scale=scale,
                                   page_size=page_tokens)
        elif mode == "extend":
            # as in the JAX package, the chunk is written before it attends:
            # on a windowed ring of ``window`` slots a chunk that wraps it
            # overwrites keys its own early queries' windows still cover
            # (ROADMAP §C.7)
            write_chunk_to_cache(cache, k, v, positions)
            out = extend_attention(q, cache["kv"], cache["pos"], positions,
                                   window=window, cap=cap, scale=scale,
                                   page_size=page_tokens)
        else:
            raise ValueError(f"no ring mode {mode!r}")
        out = out.to(q.dtype).reshape(B * S, Hq * hd) @ p["wo"].reshape(Hq * hd, d)
        return out.reshape(B, S, d), cache
    if page_table is None:
        raise ValueError("a page pool needs a page table")

    kv_pages = cache["kv_pages"]
    pos2d, act, cu, kv_lens = paged_rows(mode, B, S, positions, cur_pos,
                                         decode_active, x.device)
    write_tokens_to_pages(kv_pages, interleave_kv(k, v), pos2d, page_table,
                          active=act)
    out = ragged_paged_attention(
        q.reshape(B * S, Hq, hd), kv_pages, page_table.to(torch.int32).contiguous(),
        cu, kv_lens, scale=scale, cap=cap, window=window, max_q_len=S)
    out = out.to(q.dtype).reshape(B * S, Hq * hd) @ p["wo"].reshape(Hq * hd, d)
    return out.reshape(B, S, d), {"kv_pages": kv_pages}
