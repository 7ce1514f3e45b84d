"""Model assembly for dense attention and SSM stacks: embeddings -> layer
groups -> head, on the paged compute plane and for training.

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
  logits are alive at a time) and z-loss; layers rematerialised per
  ``cfg.remat``;
- ``paged_prefill`` — the first chunk of a prompt at positions 0..S-1;
- ``paged_extend``  — a later chunk at ``offset + [0, S)``;
- ``paged_decode``  — one batched decode step at per-row positions.
Attention layers compute on KV pages, SSM layers on point-state pages
(conv left-context + SSD state at page boundaries); a point stack's
prefill or extend chunk must lie within one page. MLA, hybrid, MoE,
frontends, SSM training and the ring-cache path raise
``NotImplementedError`` naming their ROADMAP item.
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
from repro_torch.models.attention import attention_sublayer, attn_defs
from repro_torch.models.layers import embed, embed_defs, lm_logits, mlp, mlp_defs, rmsnorm, rmsnorm_def
from repro_torch.models.ssm import ssm_defs, ssm_paged_init, ssm_sublayer

_UNPORTED = {"mla": "MLA (ROADMAP A.7)", "hybrid": "hybrid (ROADMAP A.8)"}


def _check_ported(cfg: ModelConfig) -> None:
    for spec in cfg.layer_specs():
        if spec.kind in _UNPORTED:
            raise NotImplementedError(f"{cfg.name}: {_UNPORTED[spec.kind]} "
                                      "is not ported yet")
        if spec.mlp == "moe":
            raise NotImplementedError(f"{cfg.name}: MoE (ROADMAP A.9) is not "
                                      "ported yet")
    if cfg.frontend is not None or cfg.n_meta_tokens or cfg.n_codebooks > 1:
        raise NotImplementedError(f"{cfg.name}: frontends and meta tokens "
                                  "(ROADMAP A.9) are not ported yet")

# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    defs: dict = {"norm1": rmsnorm_def(cfg.d_model)}
    if spec.kind in _UNPORTED:
        raise NotImplementedError(f"{_UNPORTED[spec.kind]} is not ported yet")
    defs["mixer"] = ssm_defs(cfg) if spec.kind == "ssm" else attn_defs(cfg)
    if cfg.post_norms:
        defs["post_norm1"] = rmsnorm_def(cfg.d_model)
    if spec.mlp != "none":
        if spec.mlp == "moe":
            raise NotImplementedError("MoE (ROADMAP A.9) is not ported yet")
        defs["norm2"] = rmsnorm_def(cfg.d_model)
        defs["mlp"] = mlp_defs(cfg, cfg.d_ff)
        if cfg.post_norms:
            defs["post_norm2"] = rmsnorm_def(cfg.d_model)
    return defs


def model_defs(cfg: ModelConfig) -> dict:
    _check_ported(cfg)
    groups = []
    for g in cfg.scan_groups():
        unit_defs = tuple(prm.stack_defs(block_defs(cfg, spec), g.repeats) for spec in g.unit)
        groups.append(unit_defs)
    return {
        "embed": embed_defs(cfg),
        "groups": tuple(groups),
        "final_norm": rmsnorm_def(cfg.d_model),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random parameters on ``device`` (default ``cuda``): the reference's
    ``init_params(cfg, jax.random.key(seed))``, drawn by the port's copy of
    JAX's generator (``models/jax_random.py``)."""
    return prm.materialize(model_defs(cfg), jax_random.key(seed),
                           resolve_device(device), cfg.param_dtype)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def apply_block(cfg: ModelConfig, spec: LayerSpec, p: dict, x, *, positions,
                cache, mode, cur_pos=None, decode_active=None, page_table=None,
                page_tokens=None):
    """Pre-norm residual block over one layer's parameters and page pool
    (``page_tokens`` is the page size SSM layers need to resolve their
    state-page slots). Returns (x, cache)."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.kind == "ssm":
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
                                          page_table=page_table)
    if cfg.post_norms:
        h = rmsnorm(h, p["post_norm1"], cfg.norm_eps)
    x = x + h
    if spec.mlp != "none":
        h = rmsnorm(x, p["norm2"], cfg.norm_eps)
        h = mlp(cfg, p["mlp"], h)
        if cfg.post_norms:
            h = rmsnorm(h, p["post_norm2"], cfg.norm_eps)
        x = x + h
    return x, new_cache


# ---------------------------------------------------------------------------
# Page pools
# ---------------------------------------------------------------------------


def _paged_unit_cache(cfg: ModelConfig, spec: LayerSpec, n_pages: int,
                      page_tokens: int, dtype, device) -> dict:
    """One unit's paged-plane pool, unstacked. Attention pages hold fused
    head-interleaved KV; SSM pages hold the conv left-context + SSD
    recurrent state after the last written token of the page."""
    if spec.kind == "ssm":
        return ssm_paged_init(cfg, n_pages, dtype, device)
    shape = (n_pages, page_tokens, 2 * cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"kv_pages": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_caches(cfg: ModelConfig, n_pages: int, page_tokens: int,
                      dtype=torch.bfloat16, device=None):
    """Per-group tuple of per-unit page pools, each leaf stacked over the
    group's repeats — the JAX package's layout, page axis 1:
    ``{"kv_pages": (R, P, ps, 2*Hkv, D)}`` for attention, ``{"conv_pages":
    (R, P, cw-1, conv_dim), "state_pages": (R, P, nh, hd, ns) fp32}`` for
    SSM. Page id 0 is the reserved null page."""
    _check_ported(cfg)
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


def _embed_inputs(cfg: ModelConfig, params, batch: dict):
    """tokens -> x (B, S, d), and the index of the first 'real' position
    (always 0: frontends and meta tokens are not ported yet)."""
    return embed(cfg, params["embed"], batch["tokens"]), 0


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
    return apply_block(cfg, spec, p, x, positions=positions, cache=None,
                       mode="train")[0]


def apply_groups(cfg: ModelConfig, params, x, *, positions, caches=None,
                 mode, cur_pos=None, decode_active=None, page_table=None,
                 page_tokens=None):
    """Run every layer in order. Paged modes: each layer's pool slice
    ``pool[i]`` is a contiguous view written in place, so the caches come
    back as the same tensors. Train (no caches): each layer runs under
    ``cfg.remat`` (``_remat``). Returns (x, caches)."""
    for gi, g in enumerate(cfg.scan_groups()):
        gp = params["groups"][gi]
        layer_params = [_layers(gp[u], g.repeats) for u in range(len(g.unit))]
        if mode == "train":
            blocks = [_remat(cfg, functools.partial(_train_block, cfg, spec, positions))
                      for spec in g.unit]
            for i in range(g.repeats):
                for u, block in enumerate(blocks):
                    x = block(x, layer_params[u][i])
            continue
        layer_caches = [_layers(caches[gi][u], g.repeats)
                        for u in range(len(g.unit))]
        for i in range(g.repeats):
            for u, spec in enumerate(g.unit):
                x, _ = apply_block(cfg, spec, layer_params[u][i], x,
                                   positions=positions,
                                   cache=layer_caches[u][i], mode=mode,
                                   cur_pos=cur_pos,
                                   decode_active=decode_active,
                                   page_table=page_table,
                                   page_tokens=page_tokens)
    return x, caches


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def _ce_chunk(cfg: ModelConfig, xs, labels, embed_params):
    """(sum of masked NLL, label count, sum of masked lse²) of one chunk;
    labels < 0 are masked."""
    logits = lm_logits(cfg, embed_params, xs).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum(), (torch.square(lse) * mask).sum()


def loss_and_metrics(cfg: ModelConfig, params, batch: dict,
                     loss_chunk: int = 1024) -> Tuple[torch.Tensor, dict]:
    """Causal-LM loss. batch: tokens (B, S) int, labels (B, S) int with
    -100 = masked. Returns (loss, {"ce", "z_loss", "aux", "tokens"}) with
    loss = ce + 1e-4 * mean(lse²) + aux, as the JAX package computes it."""
    _check_ported(cfg)
    if snapshot_kind(cfg) == "point":
        raise NotImplementedError(f"{cfg.name}: SSM training (the ring-cache "
                                  "SSM modes, ROADMAP A.10) is not ported yet")
    x, prefix = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = apply_groups(cfg, params, x, positions=positions, mode="train")
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
    aux = zero
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
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params["embed"], x)


def _check_point_chunk(cfg: ModelConfig, offset: int, S: int,
                       page_tokens) -> None:
    """A point stack's chunk reads one state page and writes one: it must
    lie within the page of its first position (the engine chunks point
    stacks on the page grid)."""
    if snapshot_kind(cfg) != "point":
        return
    if page_tokens is None:
        raise ValueError(f"{cfg.name}: paged SSM layers need page_tokens")
    if offset // page_tokens != (offset + S - 1) // page_tokens:
        raise ValueError(f"{cfg.name}: a chunk at positions [{offset}, "
                         f"{offset + S}) crosses a {page_tokens}-token page "
                         "boundary; point stacks chunk on the page grid")


def paged_prefill(cfg: ModelConfig, params, batch: dict, caches, page_table,
                  page_tokens=None):
    """First chunk on the paged plane: the prompt at absolute positions
    0..S-1, KV or state written straight into the pool pages named by
    ``page_table`` (B, W). Returns (last_logits, caches)."""
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
    """Later chunks on the paged plane: ``tokens`` (B, S) at absolute
    positions ``offset + [0, S)``; earlier context is whatever the pages in
    ``page_table`` hold — including pages spliced in from a prefix hit."""
    x = embed(cfg, params["embed"], tokens)
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
    x = embed(cfg, params["embed"], last_tokens)
    cp = cur_pos.to(torch.int32)
    x, caches = apply_groups(cfg, params, x, positions=cp[:, None],
                             caches=caches, mode="decode", cur_pos=cp,
                             decode_active=active, page_table=page_table,
                             page_tokens=page_tokens)
    return _head(cfg, params, x[:, 0]), caches
