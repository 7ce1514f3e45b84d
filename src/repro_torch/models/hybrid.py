"""Hymba-style hybrid block: parallel attention + SSM heads
[arXiv:2411.13676], on the paged compute plane (DESIGN.md §10) and on ring
caches.

The port of ``repro.models.hybrid``. Both halves read the same normed
input; each half's output is RMS-normed by its own zero-initialised scale
and the two are averaged. The attention half attends on the layer's KV
pages (sliding window except at ``cfg.global_layers``) through ragged paged
attention; the SSM half runs the SSD chunk scan from its state page. One
page table indexes both pools: ``{"attn": {"kv_pages"}, "ssm":
{"conv_pages", "state_pages"}}``. On ring caches, ``{"attn": {"kv",
"pos"}, "ssm": {"conv", "state"}}``, each half runs its own ring modes: a
first chunk through the flash forward and the scan from zeros, later
chunks and decode through the position-mode kernel and the carried state.
The meta tokens are prepended by the transformer assembly and sit in both
halves' caches like any other token. ``train`` runs both halves over the
whole sequence without caches: the attention half through the flash
kernels under the layer's window, the SSM half through ``SSDScan``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention_sublayer, attn_defs
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import ParamDef
from repro_torch.models.ssm import ssm_defs, ssm_sublayer


def hybrid_defs(cfg: ModelConfig) -> dict:
    return {
        "attn": attn_defs(cfg),
        "ssm": ssm_defs(cfg),
        "attn_out_norm": ParamDef((cfg.d_model,), ("embed",), init="zeros"),
        "ssm_out_norm": ParamDef((cfg.d_model,), ("embed",), init="zeros"),
    }


def hybrid_sublayer(
    cfg: ModelConfig,
    p: dict,
    x,
    *,
    positions,
    window: Optional[int],
    cache: Optional[dict] = None,
    mode: str = "extend",  # train | prefill | extend | decode
    cur_pos=None,
    decode_active=None,
    page_table=None,
    page_tokens: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, d) -> (out, {"attn": ..., "ssm": ...}), both halves'
    pools or rings written IN PLACE. ``decode_active`` masks both halves'
    writes for inactive rows; ``page_tokens`` is the page size of the
    state-page slots and of the ring view. ``train`` takes no cache and
    returns None for it."""
    if mode == "train":
        if cache is not None:
            raise ValueError("hybrid training takes no cache")
        a_out, _ = attention_sublayer(cfg, p["attn"], x, positions=positions,
                                      window=window, mode="train")
        s_out, _ = ssm_sublayer(cfg, p["ssm"], x, mode="train")
        return _combine(cfg, p, a_out, s_out), None
    a_out, a_cache = attention_sublayer(
        cfg, p["attn"], x, positions=positions, window=window,
        cache=cache["attn"], mode=mode, cur_pos=cur_pos,
        decode_active=decode_active, page_table=page_table,
        page_tokens=page_tokens)
    s_out, s_cache = ssm_sublayer(
        cfg, p["ssm"], x, cache=cache["ssm"], mode=mode,
        decode_active=decode_active, positions=positions, cur_pos=cur_pos,
        page_table=page_table, page_tokens=page_tokens)
    return _combine(cfg, p, a_out, s_out), {"attn": a_cache, "ssm": s_cache}


def _combine(cfg: ModelConfig, p: dict, a_out, s_out):
    """The mean of the two halves, each RMS-normed by its own scale."""
    return 0.5 * (rmsnorm(a_out, p["attn_out_norm"], cfg.norm_eps)
                  + rmsnorm(s_out, p["ssm_out_norm"], cfg.norm_eps))
