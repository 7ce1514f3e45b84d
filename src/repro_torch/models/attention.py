"""Self-attention on the paged compute plane (DESIGN.md §10).

The port of ``repro.models.attention`` carries the parameter definitions
and the paged branch of ``attention_sublayer``: QKV projection, qk-norm,
RoPE, the in-place KV write into the page pool, ragged paged attention and
the output projection. Where the JAX package attends through the rows form
``paged_attention_rows``, the port calls the ragged form, which launches
the Hopper kernel on CUDA tensors. The ring-cache path (chunked flash
prefill, ring decode) is not ported yet (ROADMAP A.10).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
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
# Full attention sublayer (projections + rope + attention + out-proj)
# ---------------------------------------------------------------------------


def attention_sublayer(
    cfg: ModelConfig,
    p: dict,
    x,
    *,
    positions,
    window: Optional[int],
    cache: Optional[dict] = None,
    mode: str = "extend",  # extend | decode
    cur_pos=None,
    decode_active=None,   # (B,) bool: rows whose pages the decode may write
    page_table=None,      # (B, W) int32: paged compute plane (DESIGN.md §10)
) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (attn_out (B, S, d), {"kv_pages": pool}).

    ``cache["kv_pages"]`` (P, ps, 2*Hkv, D) is written IN PLACE (JAX
    returns a new pool; here the returned dict holds the same tensor).
    Extend: every row of the batch is one sequence whose S queries sit at
    ``positions`` (offset .. offset+S-1). Decode: B sequences of one query
    at ``cur_pos`` (B,); inactive rows carry all-null tables, attend to
    nothing (output 0, discarded by the caller) and write nothing."""
    if cache is None or "kv_pages" not in cache or page_table is None:
        raise NotImplementedError("the ring-cache attention path is not "
                                  "ported yet (ROADMAP A.10)")
    B, S, d = x.shape
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    dev = x.device
    kv_pages = cache["kv_pages"]
    if mode == "decode":
        cur = cur_pos.to(torch.int32).reshape(-1)
        pos2d = cur.reshape(-1, 1)
        act = decode_active
        cu = torch.arange(B + 1, dtype=torch.int32, device=dev)
        kv_lens = cur + 1
    elif mode == "extend":
        pos = positions.to(torch.int32).reshape(S)
        pos2d = pos.reshape(1, S).expand(B, S)
        act = None
        cu = torch.arange(0, (B + 1) * S, S, dtype=torch.int32, device=dev)
        kv_lens = (pos[-1:] + 1).expand(B).contiguous()
    else:
        raise NotImplementedError(f"mode {mode!r} is not ported yet (ROADMAP A.10)")
    write_tokens_to_pages(kv_pages, interleave_kv(k, v), pos2d, page_table,
                          active=act)
    Hq, hd = q.shape[2], q.shape[3]
    out = ragged_paged_attention(
        q.reshape(B * S, Hq, hd), kv_pages, page_table.to(torch.int32).contiguous(),
        cu, kv_lens, scale=_q_scale(cfg), cap=cfg.attn_softcap, window=window,
        max_q_len=S)
    out = out.to(q.dtype).reshape(B * S, Hq * hd) @ p["wo"].reshape(Hq * hd, d)
    return out.reshape(B, S, d), {"kv_pages": kv_pages}
