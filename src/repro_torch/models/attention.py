"""Self-attention: the paged compute plane (DESIGN.md §10) and the
training path.

The port of ``repro.models.attention`` carries the parameter definitions,
``chunked_attention`` with its flash backward, and two modes of
``attention_sublayer``: QKV projection, qk-norm, RoPE, then either

- ``train``: ``chunked_attention`` over the whole unpadded sequence — on
  CUDA one ``FlashAttention`` call (the Hopper forward kernel, and the
  dK/dV and dQ kernels in the backward), on the CPU the plain versions
  chunked as the JAX package chunks; or
- ``extend``/``decode`` on KV pages: the in-place KV write into the page
  pool and ragged paged attention (where the JAX package attends through
  the rows form ``paged_attention_rows``, the port calls the ragged form,
  which launches the Hopper kernel on CUDA tensors);

and the output projection. The ring-cache modes (``prefill`` and the ring
``extend``/``decode``) are not ported yet (ROADMAP A.6).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
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
    raise NotImplementedError(f"mode {mode!r} is not ported yet (ROADMAP A.6)")


def attention_sublayer(
    cfg: ModelConfig,
    p: dict,
    x,
    *,
    positions,
    window: Optional[int],
    cache: Optional[dict] = None,
    mode: str = "extend",  # train | extend | decode
    cur_pos=None,
    decode_active=None,   # (B,) bool: rows whose pages the decode may write
    page_table=None,      # (B, W) int32: paged compute plane (DESIGN.md §10)
) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (attn_out (B, S, d), {"kv_pages": pool} or None).

    Train: causal attention over the whole sequence at ``positions``
    0..S-1, no cache. ``cache["kv_pages"]`` (P, ps, 2*Hkv, D) is written IN PLACE (JAX
    returns a new pool; here the returned dict holds the same tensor).
    Extend: every row of the batch is one sequence whose S queries sit at
    ``positions`` (offset .. offset+S-1). Decode: B sequences of one query
    at ``cur_pos`` (B,); inactive rows carry all-null tables, attend to
    nothing (output 0, discarded by the caller) and write nothing."""
    if mode != "train" and (cache is None or "kv_pages" not in cache
                            or page_table is None):
        raise NotImplementedError("the ring-cache attention path is not "
                                  "ported yet (ROADMAP A.6)")
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
    if mode == "train":
        out = chunked_attention(q, k, v, window=window, cap=cfg.attn_softcap,
                                scale=_q_scale(cfg), q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk)
        out = out.reshape(B * S, Hq * v.shape[3]) @ p["wo"].reshape(-1, d)
        return out.reshape(B, S, d), None

    kv_pages = cache["kv_pages"]
    pos2d, act, cu, kv_lens = paged_rows(mode, B, S, positions, cur_pos,
                                         decode_active, x.device)
    write_tokens_to_pages(kv_pages, interleave_kv(k, v), pos2d, page_table,
                          active=act)
    out = ragged_paged_attention(
        q.reshape(B * S, Hq, hd), kv_pages, page_table.to(torch.int32).contiguous(),
        cu, kv_lens, scale=_q_scale(cfg), cap=cfg.attn_softcap, window=window,
        max_q_len=S)
    out = out.to(q.dtype).reshape(B * S, Hq * hd) @ p["wo"].reshape(Hq * hd, d)
    return out.reshape(B, S, d), {"kv_pages": kv_pages}
