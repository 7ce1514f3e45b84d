"""Multi-head Latent Attention (DeepSeek-V2) on the paged compute plane
(DESIGN.md §10) — the port of ``repro.models.mla``.

KV is cached compressed: the latent c (kv_lora_rank) and one shared rope
key kr (qk_rope_dim) per token. The paged branch is always absorbed. A
page row stores one fused latent head of width r + dr:

    K' = [c, kr]        V' = [c, 0]

written by ``write_tokens_to_pages`` into ``(P, ps, 2, r + dr)`` pages.
The query q' = [qn W_UK, qr] makes q'·K' = (qn W_UK)·c + qr·kr, the
absorbed score, so every query head attends the one latent KV head (a
group of n_heads) through ragged paged attention — the Hopper kernel on
CUDA tensors, at scale (dn + dr)^-1/2. The first r output columns carry
the latent context, which W_UV expands per head before ``wo``.

``extend`` and ``decode`` are the modes, as ``attention_sublayer`` names
them. The ring-cache modes raise (ROADMAP A.6); training raises until the
flash kernels take Dk != Dv (ROADMAP A.4, A.11).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import (ragged_paged_attention,
                                                 write_tokens_to_pages)
from repro_torch.models.attention import _project, paged_rows
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.param import ParamDef


def mla_defs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    defs = {
        "w_dkv": ParamDef((d, r + dr), ("embed", "lora")),
        "kv_norm": ParamDef((r,), ("lora",), init="zeros"),
        "w_uk": ParamDef((r, h, dn), ("lora", "heads", "head_dim")),
        "w_uv": ParamDef((r, h, dv), ("lora", "heads", "head_dim")),
        "wo": ParamDef((h, dv, d), ("heads", "head_dim", "embed")),
    }
    if cfg.q_lora_rank:
        defs["w_dq"] = ParamDef((d, cfg.q_lora_rank), ("embed", "lora"))
        defs["q_norm"] = ParamDef((cfg.q_lora_rank,), ("lora",), init="zeros")
        defs["w_uq"] = ParamDef((cfg.q_lora_rank, h, dn + dr), ("lora", "heads", "head_dim"))
    else:
        defs["wq"] = ParamDef((d, h, dn + dr), ("embed", "heads", "head_dim"))
    return defs


def _project_q(cfg: ModelConfig, p: dict, x, positions):
    """x (B, S, d) -> (qn (B, S, H, dn), qr (B, S, H, dr) rotated)."""
    dn = cfg.qk_nope_dim
    if cfg.q_lora_rank:
        q = _project(rmsnorm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps), p["w_uq"])
    else:
        q = _project(x, p["wq"])
    qn, qr = q[..., :dn], q[..., dn:]
    return qn, apply_rope(qr, positions, cfg.rope_theta)


def _compress_kv(cfg: ModelConfig, p: dict, x, positions):
    """x (B, S, d) -> (c (B, S, r) normed, kr (B, S, dr) rotated)."""
    r = cfg.kv_lora_rank
    ckv = x @ p["w_dkv"]                                     # (B, S, r + dr)
    c = rmsnorm(ckv[..., :r], p["kv_norm"], cfg.norm_eps)
    kr = apply_rope(ckv[:, :, None, r:], positions, cfg.rope_theta)[:, :, 0, :]
    return c, kr


def mla_sublayer(
    cfg: ModelConfig,
    p: dict,
    x,
    *,
    positions,
    cache: Optional[dict] = None,
    mode: str = "extend",  # extend | decode
    cur_pos=None,
    decode_active=None,   # (B,) bool: rows whose pages the decode may write
    page_table=None,      # (B, W) int32
) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (out (B, S, d), {"kv_pages": pool}), the pool
    ``(P, ps, 2, r + dr)`` written IN PLACE. Extend: every row of the batch
    is one sequence whose S queries sit at ``positions``; decode: B
    sequences of one query at ``cur_pos`` (B,), inactive rows writing
    nothing."""
    if mode == "train":
        raise NotImplementedError(
            f"{cfg.name}: MLA training needs Dk != Dv in the flash kernels "
            "(ROADMAP A.4, A.11), not ported yet")
    if cache is None or "kv_pages" not in cache or page_table is None:
        raise NotImplementedError("the ring-cache MLA path is not ported yet "
                                  "(ROADMAP A.6)")
    B, S, d = x.shape
    r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim
    scale = (dn + dr) ** -0.5
    qn, qr = _project_q(cfg, p, x, positions)
    c, kr = _compress_kv(cfg, p, x, positions)

    kv_pages = cache["kv_pages"]
    pos2d, act, cu, kv_lens = paged_rows(mode, B, S, positions, cur_pos,
                                         decode_active, x.device)
    k_f = torch.cat([c, kr], dim=-1)                         # (B, S, r + dr)
    v_f = torch.cat([c, torch.zeros_like(kr)], dim=-1)
    write_tokens_to_pages(kv_pages, torch.stack([k_f, v_f], dim=2), pos2d,
                          page_table, active=act)
    qc = torch.einsum("bshk,rhk->bshr", qn, p["w_uk"])
    q_f = torch.cat([qc, qr], dim=-1)                        # (B, S, H, r + dr)
    H = q_f.shape[2]
    o = ragged_paged_attention(
        q_f.reshape(B * S, H, r + dr).contiguous(), kv_pages,
        page_table.to(torch.int32).contiguous(), cu, kv_lens, scale=scale,
        max_q_len=S)
    out = torch.einsum("nhr,rhk->nhk", o[..., :r].to(x.dtype), p["w_uv"])
    out = out.reshape(B * S, -1) @ p["wo"].reshape(-1, d)
    return out.reshape(B, S, d), {"kv_pages": kv_pages}
