"""Mixture-of-Experts MLP (DeepSeek-V2: fine-grained routed experts plus
shared experts) — the port of ``repro.models.moe``.

Dispatch keeps the reference's GShard capacity-slot semantics. Tokens are
split into groups along the sequence (``_group_size``); within a group the
(token, choice) pairs claim their expert's ``cap`` slots in flattened
(token, choice) order — earlier tokens, then earlier choices, first — and
a pair past its expert's capacity is dropped. The reference forms one-hot
(group, expert, capacity) tensors and contracts them (the portable TPU
pattern under pjit) and scans the groups to bound those temporaries. The
port computes the same slot for every pair and moves tokens by index
instead:

- a scatter of each kept pair's token into an (expert, group x capacity)
  buffer — every slot receives one token, so the copy is exact;
- one batched product per expert matrix over every group at once
  (``_expert_ffn``), empty slots included, as the reference computes them;
- a gather of each kept pair's expert output, weighted and summed over the
  choices in fp32 and rounded once.

The kept set is the reference's; the sums differ from its einsums only in
order. Training differentiates through the same index moves: a kept pair's
gradient flows back through its scatter and gather, a dropped pair's (the
spare row, weight 0) is zero, as the reference's one-hot contractions
give it, and the router's through the kept weights and the Switch aux
loss. Shared experts run densely for every token. On DTensors (the dry
run) ``_moe_sharded`` places the layer where the reference's ``sh``
constraints do (``repro/models/moe.py:82, 122, 125, 143``): the experts,
or each expert's d_ff where the experts do not divide the model axis,
and the shared experts' d_ff split over the model axis, tokens over the
batch axes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation
from repro_torch.models.param import ParamDef
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.sharding import is_dtensor


def moe_defs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    gated = cfg.act in ("silu", "gelu")
    defs = {
        "router": ParamDef((d, e), ("embed", "experts")),
        "w_up": ParamDef((e, d, f), ("experts", "embed", "ff")),
        "w_down": ParamDef((e, f, d), ("experts", "ff", "embed")),
    }
    if gated:
        defs["w_gate"] = ParamDef((e, d, f), ("experts", "embed", "ff"))
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        defs["shared_up"] = ParamDef((d, fs), ("embed", "ff"))
        defs["shared_down"] = ParamDef((fs, d), ("ff", "embed"))
        if gated:
            defs["shared_gate"] = ParamDef((d, fs), ("embed", "ff"))
    return defs


def _group_size(cfg: ModelConfig, seq_len: int) -> int:
    """The reference's group size: the largest power of two up to 256 that
    divides the sequence (grown past 256 while the dispatch overhead
    g*cf/(3*f) stays under 3%)."""
    g = 256
    while g * 2 <= min(seq_len, 4096) and (g * 2 * cfg.capacity_factor) / (3 * cfg.expert_d_ff) < 0.03:
        g *= 2
    while seq_len % g:
        g //= 2
    return max(g, 1)


def _capacity(cfg: ModelConfig, g: int) -> int:
    """Slots per expert and group, rounded as the reference rounds them
    (Python's ``round``: half to even)."""
    cap = max(4, int(round(g / cfg.n_experts * cfg.moe_top_k * cfg.capacity_factor)))
    return min(cap, g)


def route(cfg: ModelConfig, router_w, tokens):
    """tokens: (T, d) -> (weights (T, k) in the tokens' dtype, expert ids
    (T, k), Switch load-balance aux loss (fp32 scalar)).

    ``jax.lax.top_k`` breaks ties toward the lower index; a stable
    descending sort does the same (``torch.topk`` promises no order)."""
    logits = (tokens @ router_w).float()                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :cfg.moe_top_k], idx[:, :cfg.moe_top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    e = cfg.n_experts
    me = probs.mean(dim=0)                                   # mean router prob per expert
    ce = torch.zeros(e, dtype=torch.float32, device=tokens.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=tokens.device)) / idx.numel()
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef
    return w.to(tokens.dtype), idx, aux


def capacity_slots(idx, n_experts: int, cap: int):
    """idx: (N, g*k) expert ids of each group's (token, choice) pairs in
    flattened order -> (slot (N, g*k): how many earlier pairs of the group
    chose the same expert, keep (N, g*k): slot < cap)."""
    experts = torch.arange(n_experts, device=idx.device)
    oh = (idx[..., None] == experts).to(torch.int32)                   # (N, g*k, E)
    slot = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(-1)
    return slot, slot < cap


def _expert_ffn(cfg: ModelConfig, p: dict, xe):
    """xe: (E, M, d) each expert's slot rows -> (E, M, d)."""
    act = activation(cfg.act)
    up = torch.bmm(xe, p["w_up"])
    h = act(torch.bmm(xe, p["w_gate"])) * up if "w_gate" in p else act(up)
    return torch.bmm(h, p["w_down"])


def moe_sublayer(cfg: ModelConfig, p: dict, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss scalar). Groups are chunks
    of each sequence; every (sequence, group) has its own capacity."""
    if is_dtensor(x):
        return _moe_sharded(cfg, p, x)
    B, S, d = x.shape
    k, E = cfg.moe_top_k, cfg.n_experts
    g = _group_size(cfg, S)
    N = B * (S // g)                                         # (sequence, group) pairs
    cap = _capacity(cfg, g)

    w_all, idx_all, aux = route(cfg, p["router"], x.reshape(B * S, d))
    slot, keep = capacity_slots(idx_all.reshape(N, g * k), E, cap)
    dev = x.device
    grp = torch.arange(N, device=dev)[:, None]
    # each kept pair's row in its expert's buffer; dropped pairs all land in
    # a spare last row that no expert computes
    row = torch.where(keep, grp * cap + slot, N * cap)
    tok = x.reshape(N, g, d)[grp, torch.arange(g * k, device=dev)[None] // k]   # (N, g*k, d)
    buf = x.new_zeros((p["w_up"].shape[0], N * cap + 1, d))
    buf[idx_all.reshape(N, g * k), row] = tok
    ye = _expert_ffn(cfg, p, buf[:, :N * cap])
    y = ye[idx_all.reshape(N, g * k), torch.where(keep, row, 0)]                 # (N, g*k, d)
    wk = w_all.reshape(N, g * k).float() * keep
    out = (y.float() * wk[..., None]).reshape(B, S, k, d).sum(2).to(x.dtype)

    if cfg.n_shared_experts:
        act = activation(cfg.act)
        up = x @ p["shared_up"]
        h = act(x @ p["shared_gate"]) * up if "shared_gate" in p else act(up)
        out = out + h @ p["shared_down"]
    return out, aux


def _moe_sharded(cfg: ModelConfig, p: dict, x):
    """``moe_sublayer`` on DTensors (the dry run). Each device routes its
    batch shard over every expert (the router gathered) and computes the
    slots of the experts it holds — experts split over a mesh dim, or each
    expert's d_ff where the experts do not divide it — on its own weight
    shards, with the shared experts' d_ff likewise; the partial outputs are
    then summed over the mesh dims that split the weights."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    xp = tuple(q if q.is_shard(0) else Replicate() for q in shd.replicated(x))

    def weights(v):   # a mesh dim that splits the batch holds whole weights
        return tuple(Replicate() if xp[i].is_shard() else q
                     for i, q in enumerate(shd.replicated(v)))

    wp = {name: ((Replicate(),) * mesh.ndim if name == "router" else weights(v))
          for name, v in p.items()}
    local = {name: shd.local_of(v, wp[name]) for name, v in p.items()}
    split = {i for pl in wp.values() for i, q in enumerate(pl) if q.is_shard()}
    out, aux = moe_sublayer(cfg, local, shd.local_of(x, xp))
    out_p = tuple(q if q.is_shard() else shd.partial_placement() if i in split
                  else Replicate() for i, q in enumerate(xp))
    out = shd.global_of(out, mesh, out_p, tuple(x.shape)).redistribute(mesh, xp)
    aux_p = tuple(shd.partial_placement() if q.is_shard() else Replicate() for q in xp)
    return out, shd.global_of(aux, mesh, aux_p, ())
