"""Mamba2 SSD (state-space duality) block [arXiv:2405.21060] on the paged
compute plane (DESIGN.md §10) and on ring caches.

The port of ``repro.models.ssm`` carries the parameter definitions, the
depthwise causal conv, the one-token decode recurrence, the state-page
pools, the per-slot ring cache (``ssm_cache_init``: the conv left-context
and the SSD state) and every mode of ``ssm_sublayer``. Prefill and extend
chunks run the SSD chunk scan (``kernels.ssd_scan``: the Hopper kernel on
CUDA tensors, its plain version on the CPU), continuing from the state
page they read or from the ring's carried state (a fresh zero ring is the
empty history); decode runs the O(1) recurrence in plain torch, as the
JAX package does. ``train`` runs the whole sequence from the zero state
through ``SSDScan``: the forward kernel, and the backward kernels in the
backward pass.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import ParamDef


def ssm_defs(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    ng, ns, nh, cw = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv
    conv_dim = di + 2 * ng * ns
    return {
        "in_proj": ParamDef((d, 2 * di + 2 * ng * ns + nh), ("embed", "ssm_inner")),
        "conv_w": ParamDef((cw, conv_dim), ("conv", "ssm_inner")),
        "conv_b": ParamDef((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": ParamDef((nh,), ("ssm_heads",), init="a_log", dtype="float32"),
        "d_skip": ParamDef((nh,), ("ssm_heads",), init="ones", dtype="float32"),
        "dt_bias": ParamDef((nh,), ("ssm_heads",), init="dt_bias", dtype="float32"),
        "norm_g": ParamDef((di,), ("ssm_inner",), init="zeros"),
        "out_proj": ParamDef((di, d), ("ssm_inner", "embed")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    di, ng, ns = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    b = zxbcdt[..., 2 * di:2 * di + ng * ns]
    c = zxbcdt[..., 2 * di + ng * ns:2 * di + 2 * ng * ns]
    dt = zxbcdt[..., 2 * di + 2 * ng * ns:]
    return z, x, b, c, dt


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv via shifted adds. xbc: (B, S, C); w: (W, C).
    state: (B, W-1, C) left context; returns (y, new_state)."""
    W = w.shape[0]
    Bsz, S, C = xbc.shape
    if state is None:
        state = torch.zeros((Bsz, W - 1, C), dtype=xbc.dtype, device=xbc.device)
    ext = torch.cat([state, xbc], dim=1)  # (B, S+W-1, C)
    y = torch.zeros((Bsz, S, C), dtype=torch.float32, device=xbc.device)
    for i in range(W):
        y = y + ext[:, i:i + S, :].float() * w[i].float()
    y = y + b.float()
    new_state = ext[:, S:, :] if S >= W - 1 else ext[:, -(W - 1):, :]
    return F.silu(y).to(xbc.dtype), new_state


def ssd_decode(x1, dt1, a, b1, c1, state):
    """One-token recurrence. x1: (B, H, P); dt1: (B, H); b1/c1: (B, G, N);
    state: (B, H, P, N) -> (y (B, H, P), new state)."""
    H = x1.shape[1]
    rep = H // b1.shape[1]
    bh = b1.float().repeat_interleave(rep, dim=1)  # (B, H, N)
    ch = c1.float().repeat_interleave(rep, dim=1)
    decay = torch.exp(dt1 * a[None, :])  # (B, H)
    state = state * decay[..., None, None] + torch.einsum(
        "bhn,bhp,bh->bhpn", bh, x1.float(), dt1)
    y = torch.einsum("bhpn,bhn->bhp", state, ch)
    return y.to(x1.dtype), state


def ssm_cache_init(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    """A fresh ring cache, the empty-history state: ``{"conv": (B, cw-1,
    conv_dim)`` in ``dtype``, ``"state": (B, nh, hd, ns)`` fp32``}``."""
    di, ng, ns = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    nh, hd, cw = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_conv
    return {"conv": torch.zeros((batch, cw - 1, di + 2 * ng * ns), dtype=dtype,
                                device=device),
            "state": torch.zeros((batch, nh, hd, ns), dtype=torch.float32,
                                 device=device)}


def ssm_paged_init(cfg: ModelConfig, n_pages: int, dtype, device) -> dict:
    """Pooled *state pages* for the paged compute plane (DESIGN.md §10):
    slot j of a session's page table maps to the page holding the conv
    left-context and SSD recurrent state *after the last written token of
    page j*. Page 0 is the reserved null page — all zeros, never written —
    so an empty table entry reads as the empty-history init state."""
    di, ng, ns = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    nh, hd, cw = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_conv
    conv_dim = di + 2 * ng * ns
    return {
        "conv_pages": torch.zeros((n_pages, cw - 1, conv_dim), dtype=dtype,
                                  device=device),
        "state_pages": torch.zeros((n_pages, nh, hd, ns), dtype=torch.float32,
                                   device=device),
    }


def _paged_state_slots(page_table, q0, page_tokens: int, q_last=None):
    """Resolve the state-page slots for a chunk/step whose first query sits
    at absolute position ``q0`` and whose last sits at ``q_last`` (default
    ``q0``; each (B,), 0-d or int). Reads the state after token ``q0 - 1``:
    slot ``j0 - 1`` when q0 opens page ``j0 = q0 // pt`` (the previous
    page's sealed boundary state), else slot ``j0`` (the open page's
    running state); an empty history maps to null page 0, whose zeros ARE
    the zero init state. Writes land in the slot of the page holding
    ``q_last`` — ``j0`` for a chunk within one page, as in the JAX package;
    for a first chunk whose meta prefix spans pages, the page where the
    next chunk (or a prefix hit) reads it. ``ok`` masks rows whose table
    entry is null. Returns int64 page ids (pid_read, pid_write) and ``ok``,
    all (B,) on the table's device."""
    B, W = page_table.shape
    table = page_table.to(torch.int64)
    q0 = torch.as_tensor(q0, device=table.device).to(torch.int64).expand(B)
    j0 = torch.div(q0, page_tokens, rounding_mode="floor")
    jw = j0 if q_last is None else torch.div(
        torch.as_tensor(q_last, device=table.device).to(torch.int64).expand(B),
        page_tokens, rounding_mode="floor")
    rs = torch.where(q0 % page_tokens == 0, j0 - 1, j0)
    rd = torch.gather(table, 1, rs.clamp(0, W - 1)[:, None])[:, 0]
    pid_read = torch.where(rs >= 0, rd, torch.zeros_like(rd))
    pid_write = torch.gather(table, 1, jw.clamp(0, W - 1)[:, None])[:, 0]
    ok = (jw < W) & (pid_write != 0)
    return pid_read, pid_write, ok


def _write_state_pages(pages, pid_write, ok, new):
    """``pages[pid_write[r]] = new[r]`` for rows where ``ok``, IN PLACE,
    without a host sync. JAX drops the other rows through an out-of-range
    scatter index (``mode="drop"``); here they write zeros into the null
    page 0, which holds zeros already, so page 0 stays zero and no other
    page is touched."""
    mask = ok.reshape((-1,) + (1,) * (new.dim() - 1))
    pages.index_copy_(0, torch.where(ok, pid_write, torch.zeros_like(pid_write)),
                      torch.where(mask, new.to(pages.dtype),
                                  torch.zeros((), dtype=pages.dtype,
                                              device=pages.device)))


def ssm_sublayer(
    cfg: ModelConfig,
    p: dict,
    x,
    *,
    cache: Optional[dict] = None,
    mode: str = "extend",  # train | prefill | extend | decode
    decode_active=None,
    positions=None,
    cur_pos=None,
    page_table=None,
    page_tokens: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, d_model) -> (out, the cache), written IN PLACE.

    ``train`` (no cache, returns None for it): the conv from zero left
    context and the scan from the zero state over the whole sequence
    through ``SSDScan``, so gradients reach every parameter by autograd —
    the reference's train mode.

    Ring cache ``{"conv", "state"}`` (no ``page_table``): ``prefill`` and
    ``extend`` are one path, the scan from the carried state, whose final
    conv and state replace the ring's; ``decode`` steps the recurrence, and
    rows where ``decode_active`` is False keep theirs (a masked write, no
    host sync).

    Paged ``{"conv_pages", "state_pages"}``: the conv left-context and SSD
    state live in pooled pages indexed
    through ``page_table`` and are updated IN PLACE (JAX returns new
    pools; here the returned dict holds the same tensors). The read slot
    is resolved from the first query position (``positions[0]`` for
    extend — the engine chunks point stacks so every chunk but a first one
    carrying the meta prefix lies within one page — and ``cur_pos`` per row
    for decode), and the updated state is written to the page owning the
    last query position (``positions[-1]``; ``cur_pos`` for decode). The
    JAX package writes to the first position's page; the two differ only
    for a first chunk that spans pages (ROADMAP §C.5). Null page 0's zeros
    are the empty-history init, so a cold start and a chunk resumed at a
    page boundary run the same recurrence. Decode rows where ``decode_active``
    is False write nothing."""
    if mode == "train":
        if cache is not None:
            raise ValueError("SSM training takes no cache")
        return _ssm_mix(cfg, p, x, None, None, "train")[0], None
    if cache is None:
        raise ValueError(f"SSM mode {mode!r} needs a cache")
    ring = "state" in cache
    if mode not in ("decode", "extend") and not (ring and mode == "prefill"):
        raise ValueError(f"no {'ring' if ring else 'paged'} SSM mode {mode!r}")
    if ring:
        if page_table is not None:
            raise ValueError("a ring cache takes no page table")
        conv_in, state = cache["conv"], cache["state"]
    else:
        if page_tokens is None:
            raise ValueError("paged SSM layers need page_tokens to resolve "
                             "their state-page slots")
        if mode == "decode":
            q0 = q_last = cur_pos
        else:
            q0, q_last = positions[0], positions[-1]
        conv_pages, state_pages = cache["conv_pages"], cache["state_pages"]
        pid_read, pid_write, ok = _paged_state_slots(page_table, q0, page_tokens,
                                                     q_last)
        conv_in = conv_pages.index_select(0, pid_read)
        state = state_pages.index_select(0, pid_read)

    out, new_conv, new_state = _ssm_mix(cfg, p, x, conv_in, state, mode)
    if mode == "decode" and decode_active is not None:
        act = decode_active.to(device=x.device, dtype=torch.bool)
        if ring:
            new_state = torch.where(act[:, None, None, None], new_state, state)
            new_conv = torch.where(act[:, None, None], new_conv, conv_in)
        else:
            ok = ok & act
    if ring:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(new_state)
    else:
        _write_state_pages(conv_pages, pid_write, ok, new_conv)
        _write_state_pages(state_pages, pid_write, ok, new_state)
    return out, cache


def _ssm_mix(cfg: ModelConfig, p: dict, x, conv_in, state, mode: str):
    """The SSM block on x (B, S, d) from the conv left context ``conv_in``
    and the SSD ``state`` (None: zeros): projections, conv, the scan (the
    one-token recurrence for ``decode``; ``SSDScan`` for ``train``), the
    skip, the gated norm and the output projection. Returns (out, the new
    conv context, the new state)."""
    B, S, _ = x.shape
    di, nh, hd = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    ng, ns = cfg.ssm_ngroups, cfg.ssm_state
    zxbcdt = x @ p["in_proj"]
    z, xi, b, c, dt = _split_proj(cfg, zxbcdt)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    xbc = torch.cat([xi, b, c], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_in)
    xi, b, c = xbc[..., :di], xbc[..., di:di + ng * ns], xbc[..., di + ng * ns:]
    xh = xi.reshape(B, S, nh, hd)
    bg = b.reshape(B, S, ng, ns)
    cg = c.reshape(B, S, ng, ns)

    if mode == "decode":
        y1, new_state = ssd_decode(xh[:, 0], dt[:, 0], a, bg[:, 0], cg[:, 0], state)
        y = y1[:, None]
    elif mode == "train":
        y, new_state = SSDScan.apply(xh, dt, a, bg, cg, state, cfg.ssm_chunk)
    else:
        y, new_state = ssd_scan(xh, dt, a, bg, cg, chunk=cfg.ssm_chunk,
                                init_state=state)
    y = y + xh.float().to(y.dtype) * p["d_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm_g"], cfg.norm_eps)
    return y @ p["out_proj"], new_conv, new_state
