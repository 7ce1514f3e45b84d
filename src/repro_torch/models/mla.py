"""Multi-head Latent Attention (DeepSeek-V2) on the paged compute plane
(DESIGN.md §10) and on ring caches — the port of ``repro.models.mla``.

KV is cached compressed: the latent c (kv_lora_rank) and one shared rope
key kr (qk_rope_dim) per token. Every mode the port serves is absorbed;
training is not. A page row stores one fused latent head of width r + dr:

    K' = [c, kr]        V' = [c, 0]

written by ``write_tokens_to_pages`` into ``(P, ps, 2, r + dr)`` pages.
The query q' = [qn W_UK, qr] makes q'·K' = (qn W_UK)·c + qr·kr, the
absorbed score, so every query head attends the one latent KV head (a
group of n_heads) through ragged paged attention — the Hopper kernel on
CUDA tensors, at scale (dn + dr)^-1/2. The first r output columns carry
the latent context, which W_UV expands per head before ``wo``.

A ring cache (``mla_cache_init``) stores the same row once, ``{"ckr": (B,
C, 1, r + dr), "pos": (B, C) int32}`` (-1: an empty slot) — the bytes of
the JAX package's ``c`` + ``kr`` + ``pos``, so snapshots and seed copies
meter the same. ``prefill`` (a first chunk, which must fit the ring),
``extend`` and ``decode`` write the new rows at slot ``pos % C`` and
attend the whole ring through the kernel's explicit-position mode with
``v_from_k`` (``kernels/decode_attention``): V' = K' = [c, kr], whose
first r output lanes are the latent context.

Departure from the JAX package, numerical only: it attends a ring absorbed
only under ``cfg.mla_absorb`` (else it expands the latents to per-head K
and V every step) and its ring ``prefill`` through expanded
``chunked_attention`` (Dk 192 != Dv 128); the port is absorbed in every
mode, whatever ``cfg.mla_absorb`` says — the same function, summed in
another order (fp32 agreement ~1e-6), and one attention path, the latent
kernel, on both engines.

``prefill``, ``extend`` and ``decode`` are the serving modes, as
``attention_sublayer`` names them. ``train`` computes as the JAX package
does, un-absorbed: the latents are expanded per head through W_UK and
W_UV, k = [k_nope, kr broadcast over the heads] and q = [qn, qr] (Dk = dn
+ dr) attend v (Dv) through ``chunked_attention`` at scale (dn +
dr)^-1/2 — on CUDA the flash kernels' Dk != Dv mode (deepseek-v2-lite: Dk
192, Dv 128, 16 query heads on 16 KV heads) — then ``wo``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  extend_attention)
from repro_torch.kernels.paged_attention import (ragged_paged_attention,
                                                 write_tokens_to_pages)
from repro_torch.models.attention import (_project, append_row_to_ring,
                                          chunked_attention, paged_rows,
                                          write_rows_to_ring)
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.param import ParamDef
from repro_torch.runtime.sharding import constrain_active


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


def _train_attention(cfg: ModelConfig, p: dict, qn, qr, c, kr, scale):
    """The un-absorbed training path: the latents c (B, S, r) expanded per
    head (the JAX package's ``_expand``), k = [c W_UK, kr] and v = c W_UV,
    causal flash attention of q = [qn, qr] -> (B, S, H, dv)."""
    kn = torch.einsum("bsr,rhk->bshk", c, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c, p["w_uv"])
    k = torch.cat([kn, kr[:, :, None, :].expand(*kn.shape[:3], kr.shape[-1])], dim=-1)
    q = torch.cat([qn, qr], dim=-1)
    return chunked_attention(q, k, v.contiguous(), scale=scale,
                             q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)


def mla_cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                   device=None) -> dict:
    """An empty latent ring: ``{"ckr": (B, C, 1, r + dr)`` ([c, kr] stored
    once, where the JAX package keeps ``c`` and ``kr`` apart), ``"pos": (B,
    C)`` int32, -1 marking an empty slot``}``."""
    width = cfg.kv_lora_rank + cfg.qk_rope_dim
    return {"ckr": torch.zeros((batch, cache_len, 1, width), dtype=dtype,
                               device=device),
            "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                              device=device)}


def _constrain_ring(ring: dict) -> None:
    """Latents shard over (batch, ring slots), in place in ``ring``."""
    for k, v in ring.items():
        ring[k] = constrain_active(v, ("act_batch", "act_kv_seq", None, None)[:v.dim()])


def _ring_attention(mode, q_f, ring, row, *, positions, cur_pos,
                    decode_active, scale, page_tokens):
    """Write the new latent rows (B, S, 1, r + dr) into the ring, in place,
    and attend the whole ring with q' (B, S, H, r + dr) in position mode,
    value = key: -> (B, S, H, r + dr)."""
    S, C = q_f.shape[1], ring["ckr"].shape[1]
    if mode == "decode":
        append_row_to_ring(ring["ckr"], ring["pos"], row[:, 0], cur_pos,
                           active=decode_active)
        _constrain_ring(ring)
        return decode_attention(q_f, ring["ckr"], ring["pos"], cur_pos,
                                scale=scale, page_size=page_tokens)
    if mode not in ("prefill", "extend"):
        raise ValueError(f"no ring mode {mode!r}")
    if S > C:
        raise ValueError(f"a {mode} chunk of {S} tokens does not fit an MLA "
                         f"ring of {C} slots")
    write_rows_to_ring(ring["ckr"], ring["pos"], row, positions)
    _constrain_ring(ring)
    return extend_attention(q_f, ring["ckr"], ring["pos"], positions,
                            scale=scale, page_size=page_tokens)


def mla_sublayer(
    cfg: ModelConfig,
    p: dict,
    x,
    *,
    positions,
    cache: Optional[dict] = None,
    mode: str = "extend",  # train | prefill | extend | decode
    cur_pos=None,
    decode_active=None,   # (B,) bool: rows whose cache the decode may write
    page_table=None,      # (B, W) int32: the paged plane
    page_tokens: Optional[int] = None,   # ring modes: the ring's page size
) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (out (B, S, d), the cache), written IN PLACE: the
    pool ``{"kv_pages": (P, ps, 2, r + dr)}`` through ``page_table``, or a
    ring ``{"ckr", "pos"}`` read as pages of ``page_tokens`` slots.
    Train (no cache): causal attention over the whole sequence at
    ``positions`` 0..S-1, un-absorbed. Prefill (rings only: the first chunk
    at positions 0..S-1 into a fresh ring) and extend: every row of the
    batch is one sequence whose S queries sit at ``positions``; decode: B
    sequences of one query at ``cur_pos`` (B,), rows where
    ``decode_active`` is False writing nothing."""
    B, S, d = x.shape
    r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim
    scale = (dn + dr) ** -0.5
    qn, qr = _project_q(cfg, p, x, positions)
    c, kr = _compress_kv(cfg, p, x, positions)
    if mode == "train":
        o = _train_attention(cfg, p, qn, qr, c, kr, scale)
        out = o.reshape(B * S, -1) @ p["wo"].reshape(-1, d)
        return out.reshape(B, S, d), None
    if cache is None:
        raise ValueError(f"mode {mode!r} needs a cache")
    k_f = torch.cat([c, kr], dim=-1)                         # (B, S, r + dr)
    qc = torch.einsum("bshk,rhk->bshr", qn, p["w_uk"])
    q_f = torch.cat([qc, qr], dim=-1)                        # (B, S, H, r + dr)
    H = q_f.shape[2]

    if "kv_pages" not in cache:
        if page_table is not None:
            raise ValueError("a ring cache takes no page table")
        o = _ring_attention(mode, q_f, cache, k_f[:, :, None], positions=positions,
                            cur_pos=cur_pos, decode_active=decode_active,
                            scale=scale, page_tokens=page_tokens)
        o = o.reshape(B * S, H, r + dr)
    else:
        if page_table is None:
            raise ValueError("a page pool needs a page table")
        kv_pages = cache["kv_pages"]
        pos2d, act, cu, kv_lens = paged_rows(mode, B, S, positions, cur_pos,
                                             decode_active, x.device)
        v_f = torch.cat([c, torch.zeros_like(kr)], dim=-1)
        write_tokens_to_pages(kv_pages, torch.stack([k_f, v_f], dim=2), pos2d,
                              page_table, active=act)
        o = ragged_paged_attention(
            q_f.reshape(B * S, H, r + dr).contiguous(), kv_pages,
            page_table.to(torch.int32).contiguous(), cu, kv_lens, scale=scale,
            max_q_len=S)
    out = torch.einsum("nhr,rhk->nhk", o[..., :r].to(x.dtype), p["w_uv"])
    out = out.reshape(B * S, -1) @ p["wo"].reshape(-1, d)
    return out.reshape(B, S, d), cache
