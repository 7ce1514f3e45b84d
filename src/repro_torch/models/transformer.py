"""Model assembly for dense attention, MLA, SSM and hybrid stacks, with
dense or MoE MLPs: embeddings (and meta tokens, image embeds) -> layer
groups -> head (one per codebook for multi-codebook audio),
on the paged compute plane, on ring caches and for training.

The parameter tree keeps ``repro.models.transformer``'s paths and stacked
layout — ``groups[gi][u]`` holds one unit's leaves stacked over the
group's repeats — so the JAX tree carries across leaf for leaf. Where JAX
runs a group under ``lax.scan``, the port loops over the layers: every
stacked leaf is ``unbind``-ed once per call (under autograd, indexing
``leaf[i]`` per layer would build a zero tensor of the whole stack in each
layer's backward), and layer ``i`` writes ``pool[i]`` of its page pool in
place.

Entry points:
- ``loss_and_metrics`` — the training forward with seq-chunked CE (each
  chunk recomputed in the backward, so only one chunk's (B, chunk, V)
  logits, or (B, chunk, K, V) over K codebooks, are alive at a time),
  z-loss and the MoE aux loss summed over layers; layers rematerialised
  per ``cfg.remat``;
- ``paged_prefill`` — the first chunk of a prompt, meta tokens and image
  embeds first, at positions 0..S-1;
- ``paged_extend``  — a later chunk at ``offset + [0, S)``;
- ``paged_decode``  — one batched decode step at per-row positions;
- ``prefill``/``extend``/``decode`` — the same three steps on per-slot ring
  caches (``init_caches``: ``{"kv": (R, B, C, 2*Hkv, D), "pos": (R, B,
  C)}`` per attention unit, a windowed layer's ring ``cache_len_for(window,
  max_len)`` long; ``{"ckr", "pos"}`` per MLA unit, ``{"conv", "state"}``
  per SSM unit, both halves' per hybrid unit).
Attention layers compute on KV pages, SSM layers on point-state pages
(conv left-context + SSD state at page boundaries), hybrid layers on both
under one page table. A point stack's extend chunk must lie within one
page; its first chunk may span pages only as far as the meta prefix forces
(``_check_point_chunk``). MLA layers compute on latent pages; an MoE
layer's aux loss is dropped on the serving path (the paged entry points
return logits and pools only). The frontends are stubs: multi-codebook
tokens (summed embeddings, one head per codebook) and image embeds in
front of the text. Training runs every stack the reference trains: dense
attention, MLA (un-absorbed, through the flash kernels' Dk != Dv mode),
MoE (the aux loss summed in layer order and added to the loss), SSM and
hybrid, with the meta prefix and the image embeds in front, cut before
the loss, and codebook tokens scored per codebook.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import jax_random
from repro_torch.models import param as prm
from repro_torch.models.attention import (attention_sublayer, attn_defs,
                                          cache_len_for, init_cache)
from repro_torch.models.hybrid import hybrid_defs, hybrid_sublayer
from repro_torch.models.layers import embed, embed_defs, lm_logits, mlp, mlp_defs, rmsnorm, rmsnorm_def
from repro_torch.models.mla import mla_cache_init, mla_defs, mla_sublayer
from repro_torch.models.moe import moe_defs, moe_sublayer
from repro_torch.models.param import ParamDef
from repro_torch.models.ssm import (ssm_cache_init, ssm_defs, ssm_paged_init,
                                    ssm_sublayer)
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.tracing import NOOP, TRACER


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    defs: dict = {"norm1": rmsnorm_def(cfg.d_model)}
    defs["mixer"] = {"attn": attn_defs, "mla": mla_defs, "ssm": ssm_defs,
                     "hybrid": hybrid_defs}[spec.kind](cfg)
    if cfg.post_norms:
        defs["post_norm1"] = rmsnorm_def(cfg.d_model)
    if spec.mlp != "none":
        defs["norm2"] = rmsnorm_def(cfg.d_model)
        defs["mlp"] = moe_defs(cfg) if spec.mlp == "moe" else mlp_defs(cfg, cfg.d_ff)
        if cfg.post_norms:
            defs["post_norm2"] = rmsnorm_def(cfg.d_model)
    return defs


def model_defs(cfg: ModelConfig) -> dict:
    groups = []
    for g in cfg.scan_groups():
        unit_defs = tuple(prm.stack_defs(block_defs(cfg, spec), g.repeats) for spec in g.unit)
        groups.append(unit_defs)
    defs = {
        "embed": embed_defs(cfg),
        "groups": tuple(groups),
        "final_norm": rmsnorm_def(cfg.d_model),
    }
    if cfg.n_meta_tokens:
        defs["meta_tokens"] = ParamDef((cfg.n_meta_tokens, cfg.d_model),
                                       (None, "embed"), std=0.02)
    return defs


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random parameters on ``device`` (default ``cuda``): the reference's
    ``init_params(cfg, jax.random.key(seed))``, drawn by the port's copy of
    JAX's generator (``models/jax_random.py``)."""
    return prm.materialize(model_defs(cfg), jax_random.key(seed),
                           resolve_device(device), cfg.param_dtype)


def abstract_params(cfg: ModelConfig, shardings=None, mesh=None):
    """The parameters as ``meta`` tensors (``param.abstract``), or meta
    DTensors placed by ``shardings`` on ``mesh``."""
    return prm.abstract(model_defs(cfg), cfg.param_dtype, shardings, mesh)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def apply_block(cfg: ModelConfig, spec: LayerSpec, p: dict, x, *, positions,
                cache, mode, cur_pos=None, decode_active=None, page_table=None,
                page_tokens=None):
    """Pre-norm residual block over one layer's parameters and page pool or
    ring (``page_tokens`` is the page size SSM and hybrid layers resolve
    their state-page slots with, and the page size rings are read as).
    Returns (x, cache, aux): aux is an MoE layer's load-balance loss (fp32
    scalar; the serving modes drop it), None for a dense MLP."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.kind == "hybrid":
        h, new_cache = hybrid_sublayer(cfg, p["mixer"], h, positions=positions,
                                       window=spec.window, cache=cache,
                                       mode=mode, cur_pos=cur_pos,
                                       decode_active=decode_active,
                                       page_table=page_table,
                                       page_tokens=page_tokens)
    elif spec.kind == "mla":
        h, new_cache = mla_sublayer(cfg, p["mixer"], h, positions=positions,
                                    cache=cache, mode=mode, cur_pos=cur_pos,
                                    decode_active=decode_active,
                                    page_table=page_table,
                                    page_tokens=page_tokens)
    elif spec.kind == "ssm":
        h, new_cache = ssm_sublayer(cfg, p["mixer"], h, cache=cache, mode=mode,
                                    decode_active=decode_active,
                                    positions=positions, cur_pos=cur_pos,
                                    page_table=page_table,
                                    page_tokens=page_tokens)
    else:
        h, new_cache = attention_sublayer(cfg, p["mixer"], h,
                                          positions=positions,
                                          window=spec.window, cache=cache,
                                          mode=mode, cur_pos=cur_pos,
                                          decode_active=decode_active,
                                          page_table=page_table,
                                          page_tokens=page_tokens)
    if cfg.post_norms:
        h = rmsnorm(h, p["post_norm1"], cfg.norm_eps)
    x = shd.constrain_active(x + h, ("act_batch", "act_seq_res", "act_embed"))
    aux = None
    if spec.mlp != "none":
        h = rmsnorm(x, p["norm2"], cfg.norm_eps)
        if spec.mlp == "moe":
            with TRACER.span("model.moe") if TRACER.on else NOOP:
                h, aux = moe_sublayer(cfg, p["mlp"], h)
        else:
            h = mlp(cfg, p["mlp"], h)
        if cfg.post_norms:
            h = rmsnorm(h, p["post_norm2"], cfg.norm_eps)
        x = shd.constrain_active(x + h, ("act_batch", "act_seq_res", "act_embed"))
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Page pools
# ---------------------------------------------------------------------------


def _paged_unit_cache(cfg: ModelConfig, spec: LayerSpec, n_pages: int,
                      page_tokens: int, dtype, device) -> dict:
    """One unit's paged-plane pool, unstacked. Attention pages hold fused
    head-interleaved KV; SSM pages hold the conv left-context + SSD
    recurrent state after the last written token of the page; MLA pages
    hold one fused latent head, K' = [c, kr] and V' = [c, 0]; hybrid pages
    are the union of the attention and SSM pools under one table."""
    if spec.kind == "ssm":
        return ssm_paged_init(cfg, n_pages, dtype, device)
    if spec.kind == "mla":
        shape = (n_pages, page_tokens, 2, cfg.kv_lora_rank + cfg.qk_rope_dim)
        return {"kv_pages": torch.zeros(shape, dtype=dtype, device=device)}
    shape = (n_pages, page_tokens, 2 * cfg.n_kv_heads, cfg.resolved_head_dim)
    kv = {"kv_pages": torch.zeros(shape, dtype=dtype, device=device)}
    if spec.kind == "hybrid":
        return {"attn": kv, "ssm": ssm_paged_init(cfg, n_pages, dtype, device)}
    return kv


def _unit_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int,
                dtype, device) -> dict:
    """One unit's ring cache, unstacked: attention KV (a windowed layer
    keeps ``cache_len_for(window, max_len)`` slots), MLA latents of
    ``max_len`` slots, SSM conv + state, or a hybrid's both halves."""
    if spec.kind == "mla":
        return mla_cache_init(cfg, batch, max_len, dtype, device)
    if spec.kind == "ssm":
        return ssm_cache_init(cfg, batch, dtype, device)
    attn = init_cache(cfg, batch, cache_len_for(spec.window, max_len), dtype,
                      device)
    if spec.kind == "hybrid":
        return {"attn": attn, "ssm": ssm_cache_init(cfg, batch, dtype, device)}
    return attn


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None):
    """Per-group tuple of per-unit ring caches, each leaf stacked over the
    group's repeats as in the JAX package: attention ``{"kv": (R, B, C,
    2*Hkv, D), "pos": (R, B, C) int32}``, K and V fused as in a page (the
    JAX package keeps ``k`` and ``v`` apart), -1 marking an empty slot;
    MLA ``{"ckr": (R, B, C, 1, r + dr), "pos"}`` ([c, kr] fused: the JAX
    package's ``c`` and ``kr``); SSM ``{"conv", "state"}`` as the JAX
    package lays them out; hybrid ``{"attn", "ssm"}``."""
    dev = resolve_device(device)
    return tuple(
        tuple(prm.tree_map(
            lambda a, r=g.repeats: a[None].repeat((r,) + (1,) * a.dim()),
            _unit_cache(cfg, spec, batch, max_len, dtype, dev))
              for spec in g.unit)
        for g in cfg.scan_groups())


def init_paged_caches(cfg: ModelConfig, n_pages: int, page_tokens: int,
                      dtype=torch.bfloat16, device=None):
    """Per-group tuple of per-unit page pools, each leaf stacked over the
    group's repeats — the JAX package's layout, page axis 1:
    ``{"kv_pages": (R, P, ps, 2*Hkv, D)}`` for attention, ``{"kv_pages":
    (R, P, ps, 2, r + dr)}`` for MLA, ``{"conv_pages":
    (R, P, cw-1, conv_dim), "state_pages": (R, P, nh, hd, ns) fp32}`` for
    SSM, ``{"attn": {...}, "ssm": {...}}`` for hybrid. Page id 0 is the
    reserved null page."""
    dev = resolve_device(device)
    meta = torch.device("meta")   # shapes and dtypes only: nothing allocated
    return tuple(
        tuple(prm.tree_map(
            lambda a, r=g.repeats: torch.zeros((r,) + a.shape, dtype=a.dtype,
                                               device=dev),
            _paged_unit_cache(cfg, spec, n_pages, page_tokens, dtype, meta))
              for spec in g.unit)
        for g in cfg.scan_groups())


# ---------------------------------------------------------------------------
# Trunk
# ---------------------------------------------------------------------------


def _embed(cfg: ModelConfig, params, tokens):
    with TRACER.span("model.embed") if TRACER.on else NOOP:
        return embed(cfg, params["embed"], tokens)


def _embed_inputs(cfg: ModelConfig, params, batch: dict):
    """tokens (+ image embeds, then meta tokens, in front) -> x (B, S_total,
    d) in the order meta, image, text, and the index of the first 'real'
    position (the prefix's length)."""
    x = _embed(cfg, params, batch["tokens"])
    prefix = 0
    if cfg.frontend == "vision" and "image_embeds" in batch:
        img = batch["image_embeds"].to(x.dtype)
        x = torch.cat([img, x], dim=1)
        prefix += img.shape[1]
    if cfg.n_meta_tokens:
        meta = params["meta_tokens"].to(x.dtype)[None].expand(
            x.shape[0], cfg.n_meta_tokens, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
        prefix += cfg.n_meta_tokens
    return shd.constrain_active(x, ("act_batch", "act_seq_res", "act_embed")), prefix


def _layers(tree, repeats: int) -> list:
    """The ``repeats`` layers of a stacked-repeats tree: one ``unbind(0)``
    per leaf, so layer ``i`` holds a view ``leaf[i]`` of every leaf."""
    if isinstance(tree, dict):
        per_key = {k: _layers(v, repeats) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(repeats)]
    return list(tree.unbind(0))


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep matrix-product outputs, recompute the rest
    (``jax.checkpoint_policies.checkpoint_dots``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat``: ``"full"`` recomputes it in the
    backward (``torch.utils.checkpoint``), ``"dots"`` keeps its matrix
    products, ``"none"`` keeps everything."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_matmuls))
    raise ValueError(f"remat {cfg.remat!r}")


def _train_block(cfg: ModelConfig, spec: LayerSpec, positions, x, p):
    """One layer in train mode -> (x, its MoE aux loss or None)."""
    x, _, aux = apply_block(cfg, spec, p, x, positions=positions, cache=None,
                            mode="train")
    return x, aux


def train_groups(cfg: ModelConfig, params, x, *, positions):
    """Every layer in order in train mode, each under ``cfg.remat``
    (``_remat``). Returns (x, aux): the MoE aux losses summed in layer
    order, as the JAX package's scan carries them (a zero fp32 scalar for a
    stack without MoE)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, g in enumerate(cfg.scan_groups()):
        gp = params["groups"][gi]
        layer_params = [_layers(gp[u], g.repeats) for u in range(len(g.unit))]
        blocks = [_remat(cfg, functools.partial(_train_block, cfg, spec, positions))
                  for spec in g.unit]
        for i in range(g.repeats):
            for u, block in enumerate(blocks):
                x, aux = block(x, layer_params[u][i])
                if aux is not None:
                    aux_total = aux_total + aux
    return x, aux_total


def apply_groups(cfg: ModelConfig, params, x, *, positions, caches, mode,
                 cur_pos=None, decode_active=None, page_table=None,
                 page_tokens=None):
    """Run every layer in order in a serving mode. Paged modes: each
    layer's pool slice ``pool[i]`` is a contiguous view written in place,
    so the caches come back as the same tensors. Returns (x, caches).
    Traced, each block is a span ``model.<kind>`` with its layer index."""
    layer = 0
    for gi, g in enumerate(cfg.scan_groups()):
        gp = params["groups"][gi]
        layer_params = [_layers(gp[u], g.repeats) for u in range(len(g.unit))]
        layer_caches = [_layers(caches[gi][u], g.repeats)
                        for u in range(len(g.unit))]
        for i in range(g.repeats):
            for u, spec in enumerate(g.unit):
                with (TRACER.span(f"model.{spec.kind}", layer=layer)
                      if TRACER.on else NOOP):
                    x, _, _ = apply_block(cfg, spec, layer_params[u][i], x,
                                          positions=positions,
                                          cache=layer_caches[u][i], mode=mode,
                                          cur_pos=cur_pos,
                                          decode_active=decode_active,
                                          page_table=page_table,
                                          page_tokens=page_tokens)
                layer += 1
    return x, caches


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def _ce_chunk(cfg: ModelConfig, xs, labels, embed_params):
    """(sum of masked NLL, label count, sum of masked lse²) of one chunk:
    logits (B, chunk[, K], V) against labels (B, chunk[, K]); labels < 0
    are masked."""
    logits = lm_logits(cfg, embed_params, xs).float()
    lse = shd.logsumexp_last(logits)
    gold = shd.gather_last(logits, labels.clamp(min=0).long())
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum(), (torch.square(lse) * mask).sum()


def loss_and_metrics(cfg: ModelConfig, params, batch: dict,
                     loss_chunk: int = 1024) -> Tuple[torch.Tensor, dict]:
    """Causal-LM loss. batch: tokens (B, S[, K]) int, labels (B, S[, K])
    int with -100 = masked, and for a vision stack optionally
    ``image_embeds`` (B, n, d), attended in front and never scored. Returns
    (loss, {"ce", "z_loss", "aux", "tokens"}) with loss = ce + 1e-4 *
    mean(lse²) + aux (the MoE aux losses summed over layers), as the JAX
    package computes it; K codebooks are K labels a position."""
    x, prefix = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = train_groups(cfg, params, x, positions=positions)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)[:, prefix:]
    labels = batch["labels"]

    S = x.shape[1]
    chunk = min(loss_chunk, S)
    while S % chunk:
        chunk //= 2
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    tot, cnt, zsum = zero, zero, zero
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        t, c, z = checkpoint(functools.partial(_ce_chunk, cfg), x[:, sl],
                             labels[:, sl], params["embed"],
                             use_reentrant=False)
        tot, cnt, zsum = tot + t, cnt + c, zsum + z
    cnt = torch.clamp(cnt, min=1.0)
    ce = tot / cnt
    z_loss = 1e-4 * zsum / cnt
    loss = ce + z_loss + aux
    return loss, {"ce": ce, "z_loss": z_loss, "aux": aux, "tokens": cnt}


def supports_extend(cfg: ModelConfig) -> bool:
    """Chunked prefill (``extend``) capability probe, as in the JAX
    package: every mixer family supports it."""
    return all(spec.kind in ("attn", "mla", "ssm", "hybrid")
               for spec in cfg.layer_specs())


def snapshot_kind(cfg: ModelConfig) -> str:
    """How a published prefix of this stack may be reused (DESIGN.md §8):
    ``"positional"`` for attention/MLA, ``"point"`` for SSM/hybrid."""
    if any(spec.kind in ("ssm", "hybrid") for spec in cfg.layer_specs()):
        return "point"
    return "positional"


# ---------------------------------------------------------------------------
# Paged serving steps (DESIGN.md §10): compute in place on the page pool
# ---------------------------------------------------------------------------


def _head(cfg: ModelConfig, params, x):
    with TRACER.span("model.head") if TRACER.on else NOOP:
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return lm_logits(cfg, params["embed"], x)


def _check_point_chunk(cfg: ModelConfig, offset: int, S: int,
                       page_tokens) -> None:
    """A point stack's chunk reads one state page and writes one, the page
    of its last position: a later chunk must lie within one page (the
    engine chunks point stacks on the page grid). The first chunk carries
    the meta prefix, which cannot be cut, so it may reach from position 0
    to the page of the first prompt token, and no further."""
    if snapshot_kind(cfg) != "point":
        return
    if page_tokens is None:
        raise ValueError(f"{cfg.name}: paged SSM layers need page_tokens")
    last = (offset + S - 1) // page_tokens
    if offset == 0 and last <= cfg.n_meta_tokens // page_tokens:
        return
    if offset // page_tokens != last:
        raise ValueError(f"{cfg.name}: a chunk at positions [{offset}, "
                         f"{offset + S}) crosses a {page_tokens}-token page "
                         "boundary; point stacks chunk on the page grid")


def paged_prefill(cfg: ModelConfig, params, batch: dict, caches, page_table,
                  page_tokens=None):
    """First chunk on the paged plane: the meta prefix, the image embeds
    (``batch["image_embeds"]``, vision stacks) and the prompt at absolute
    positions 0..S-1, KV or state written straight into the pool pages
    named by ``page_table`` (B, W). Returns (last_logits, caches)."""
    x, _ = _embed_inputs(cfg, params, batch)
    S_tot = x.shape[1]
    _check_point_chunk(cfg, 0, S_tot, page_tokens)
    positions = torch.arange(S_tot, dtype=torch.int32, device=x.device)
    x, caches = apply_groups(cfg, params, x, positions=positions,
                             caches=caches, mode="extend",
                             page_table=page_table, page_tokens=page_tokens)
    return _head(cfg, params, x[:, -1]), caches


def paged_extend(cfg: ModelConfig, params, caches, tokens, offset, page_table,
                 page_tokens=None):
    """Later chunks on the paged plane: ``tokens`` (B, S[, K]) at absolute
    positions ``offset + [0, S)``; earlier context is whatever the pages in
    ``page_table`` hold — including pages spliced in from a prefix hit."""
    x = shd.constrain_active(_embed(cfg, params, tokens),
                             ("act_batch", "act_seq_res", "act_embed"))
    S = x.shape[1]
    _check_point_chunk(cfg, int(offset), S, page_tokens)
    positions = int(offset) + torch.arange(S, dtype=torch.int32, device=x.device)
    x, caches = apply_groups(cfg, params, x, positions=positions,
                             caches=caches, mode="extend",
                             page_table=page_table, page_tokens=page_tokens)
    return _head(cfg, params, x[:, -1]), caches


def paged_decode(cfg: ModelConfig, params, caches, last_tokens, cur_pos,
                 page_table, active=None, page_tokens=None):
    """One batched decode step on the paged plane. cur_pos: (B,) absolute
    positions; rows where ``active`` is False neither write their pages
    nor advance (their page-table row may be all null pages)."""
    x = shd.constrain_active(_embed(cfg, params, last_tokens),
                             ("act_batch", None, "act_embed"))
    cp = cur_pos.to(torch.int32)
    x, caches = apply_groups(cfg, params, x, positions=cp[:, None],
                             caches=caches, mode="decode", cur_pos=cp,
                             decode_active=active, page_table=page_table,
                             page_tokens=page_tokens)
    return _head(cfg, params, x[:, 0]), caches


# ---------------------------------------------------------------------------
# Ring-cache serving steps: per-slot rings, the JAX package's default path
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params, batch: dict, max_cache_len=None,
            page_tokens=None):
    """The maximal first chunk of a prompt (the meta prefix, the image
    embeds and the tokens at positions 0..S-1) into fresh ring caches of
    ``max_cache_len`` slots (default S): attention layers attend through
    the flash forward, MLA layers write the fresh ring and read it as pages
    of ``page_tokens`` slots (the chunk must fit it), SSM layers scan from
    the zero state. Returns (last-position logits (B, V[, K]), caches)."""
    x, _ = _embed_inputs(cfg, params, batch)
    B, S_tot = x.shape[0], x.shape[1]
    positions = torch.arange(S_tot, dtype=torch.int32, device=x.device)
    L, dt = max_cache_len or S_tot, prm.torch_dtype(cfg.dtype)
    if shd.is_dtensor(x):
        # the dry run: rings placed by the active rules; the global shapes
        # are read off meta tensors made outside any trace
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            shapes = init_caches(cfg, B, L, dt, "meta")
        caches = shd.place_caches(shd.active(), cfg, shapes)
    else:
        caches = init_caches(cfg, B, L, dt, x.device)
    x, caches = apply_groups(cfg, params, x, positions=positions,
                             caches=caches, mode="prefill",
                             page_tokens=page_tokens)
    return _head(cfg, params, x[:, -1]), caches


def extend(cfg: ModelConfig, params, caches, tokens, offset, *,
           page_tokens: int):
    """A later chunk of a prompt: ``tokens`` (B, S[, K]) at absolute
    positions ``offset + [0, S)`` against the rings, which already hold
    every earlier chunk (written in place), read as pages of
    ``page_tokens`` slots. Returns (last-position logits, caches)."""
    x = shd.constrain_active(_embed(cfg, params, tokens),
                             ("act_batch", "act_seq_res", "act_embed"))
    S = x.shape[1]
    positions = int(offset) + torch.arange(S, dtype=torch.int32, device=x.device)
    x, caches = apply_groups(cfg, params, x, positions=positions,
                             caches=caches, mode="extend",
                             page_tokens=page_tokens)
    return _head(cfg, params, x[:, -1]), caches


def decode(cfg: ModelConfig, params, caches, last_tokens, cur_pos,
           active=None, *, page_tokens: int):
    """One batched decode step on the rings, read as pages of
    ``page_tokens`` slots. cur_pos: (B,) absolute positions; rows where
    ``active`` is False leave their rings as they were. Returns (logits
    (B, V[, K]), caches)."""
    x = shd.constrain_active(_embed(cfg, params, last_tokens),
                             ("act_batch", None, "act_embed"))
    cp = cur_pos.to(torch.int32)
    x, caches = apply_groups(cfg, params, x, positions=cp[:, None],
                             caches=caches, mode="decode", cur_pos=cp,
                             decode_active=active, page_tokens=page_tokens)
    return _head(cfg, params, x[:, 0]), caches
