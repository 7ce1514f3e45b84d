"""Plain PyTorch versions of the Mamba2 SSD chunk scan: the CPU path and
the oracle the Hopper kernel (``csrc/ssd_scan.cu``) is held against.

- :func:`ssd_scan_ref` is the port of ``repro.models.ssm.ssd_chunked`` in
  the model layout, with a Python loop over chunks where JAX runs
  ``lax.scan``: within a chunk the quadratic "attention" form
  (C·Bᵀ ⊙ exp-segsum decay)·(x·dt), plus the carried (P, N) state scaled
  by exp(cumsum dA); the state is carried across chunks in fp32. Its
  chunks are the model's ``ssm_chunk``; both kernels walk 32-token blocks
  instead, so they agree with it within rounding, not bit for bit: the
  fp32 FMA kernel within fp32 rounding, the bf16 tensor-core kernel
  (exact bf16 products, its fp32 operands split into bf16 hi + lo) within
  2e-4 in the state and two bf16 ulps in y. Everything here runs in fp32
  on bf16 inputs and rounds y once.
- :func:`ssd_scan_bwd_ref` is its backward, derived by hand chunk by
  chunk (not autograd of :func:`ssd_scan_ref`): the oracle of the backward
  kernels and the CPU backward of the training path. The reference has no
  backward kernel; it differentiates ``ssd_chunked`` with JAX autodiff.
- :func:`ssd_scan_sequential` is the port of
  ``repro.kernels.ssd_scan.ref.ssd_scan_ref``: the token-by-token
  recurrence in the kernel's (batch·head) layout, an implementation
  independent of the chunked one, for the tests. It also takes an
  initial state and returns the final one.
"""
from __future__ import annotations

from typing import Optional

import torch


def _chunk_len(chunk: int, S: int) -> int:
    """``min(chunk, S)``, halved until it divides S (``ssd_chunked``'s
    rule)."""
    L = min(chunk, S)
    while S % L:
        L //= 2
    return L


def ssd_scan_ref(x, dt, a, b, c, *, chunk: int,
                 init_state: Optional[torch.Tensor] = None):
    """SSD over a sequence, optionally continuing from a carried state.

    x: (B, S, H, P); dt: (B, S, H) fp32 (post-softplus); a: (H,) fp32,
    negative; b, c: (B, S, G, N) with H % G == 0; ``init_state``
    (B, H, P, N) fp32 is the state after every earlier token (zeros when
    None). The chunk length is ``L = min(chunk, S)``, halved until it
    divides S, as ``ssd_chunked`` does. Returns (y (B, S, H, P) in x's
    dtype, final state (B, H, P, N) fp32)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    L = _chunk_len(chunk, S)
    dt = dt.float()
    x_dt = x.float() * dt[..., None]                    # (B, S, H, P)
    bh = b.float().repeat_interleave(rep, dim=2)        # (B, S, H, N)
    ch = c.float().repeat_interleave(rep, dim=2)
    da = dt * a.float()[None, None, :]                  # (B, S, H) log-decay
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    if init_state is None:
        state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    else:
        state = init_state.float()
    ys = []
    for k in range(S // L):
        sl = slice(k * L, (k + 1) * L)
        xc, bc, cc = x_dt[:, sl], bh[:, sl], ch[:, sl]
        cs = torch.cumsum(da[:, sl], dim=1)             # (B, L, H)
        csh = cs.transpose(1, 2)                        # (B, H, L)
        seg = csh[..., :, None] - csh[..., None, :]     # (B, H, L, L)
        decay = torch.exp(seg.masked_fill(~tri, float("-inf")))
        cb = torch.einsum("blhn,bshn->bhls", cc, bc)
        y_in = torch.einsum("bhls,bshp->blhp", cb * decay, xc)
        y_off = torch.einsum("blhn,bhpn,blh->blhp", cc, state, torch.exp(cs))
        tail = torch.exp(cs[:, -1:, :] - cs)            # (B, L, H)
        new_state = torch.einsum("bshn,bshp,bsh->bhpn", bc, xc, tail)
        state = state * torch.exp(cs[:, -1])[..., None, None] + new_state
        ys.append(y_in + y_off)
    y = torch.cat(ys, dim=1)
    return y.to(x.dtype), state


def ssd_scan_bwd_ref(x, dt, a, b, c, dy, *, chunk: int,
                     init_state: Optional[torch.Tensor] = None,
                     d_final: Optional[torch.Tensor] = None):
    """Gradients of :func:`ssd_scan_ref` given the cotangents ``dy`` of y
    (x's shape) and ``d_final`` of the final state (B, H, P, N) fp32, or
    None (zeros). Returns (dx, d_dt, d_a, db, dc, d_init): dx, db, dc in
    x's dtype, d_dt (B, S, H), d_a (H,) and d_init (B, H, P, N) in fp32
    (float64 for float64 x: then every sum runs in float64).

    Per chunk of L tokens, with da = dt a, cs its inclusive cumsum in the
    chunk, w_ls = exp(cs_l - cs_s) for s <= l, xdt = x dt, S0 the state at
    the chunk's start and dS the cotangent of the state at its end:

      y_l   = sum_{s<=l} (C_l.B_s) w_ls xdt_s + exp(cs_l) S0 C_l
      S_end = exp(cs_L) S0 + sum_s exp(cs_L - cs_s) xdt_s (outer) B_s

    so, walking the chunks last to first (the start states from a forward
    walk):

      dxdt_s = sum_{l>=s} (C_l.B_s) w_ls dy_l + exp(cs_L - cs_s) dS B_s
      dC_l   = sum_{s<=l} (dy_l.xdt_s) w_ls B_s + exp(cs_l) dy_l S0
      dB_s   = sum_{l>=s} (dy_l.xdt_s) w_ls C_l + exp(cs_L - cs_s) xdt_s dS
      dS0    = exp(cs_L) dS + sum_l exp(cs_l) dy_l (outer) C_l

    and d(cs) collects every exp's exponent: with G_ls = (C_l.B_s)
    (dy_l.xdt_s) w_ls and T_s = exp(cs_L - cs_s) xdt_s.(dS B_s),
    d(cs_l) = sum_s G_ls - sum_l' G_l'l + exp(cs_l) C_l.(dy_l S0) - T_l,
    plus exp(cs_L) <dS, S0> + sum_s T_s at the last token. d(da) is its
    reverse cumsum in the chunk; d(dt) = a d(da) + x.dxdt, d(a) = sum over
    (B, S) of dt d(da), dx = dt dxdt; db and dc sum their heads' terms
    over each group. Every exponent is cs_l - cs_s with s <= l, cs_l or
    cs_L - cs_s: never positive (exp(-cs) would overflow under strong
    decay)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    L = _chunk_len(chunk, S)
    acc = torch.promote_types(x.dtype, torch.float32)
    dt = dt.to(acc)
    a = a.to(acc)
    xf = x.to(acc)
    x_dt = xf * dt[..., None]
    bh = b.to(acc).repeat_interleave(rep, dim=2)
    ch = c.to(acc).repeat_interleave(rep, dim=2)
    dyf = dy.to(acc)
    da = dt * a[None, None, :]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    n_chunks = S // L

    state = (torch.zeros((B, H, P, N), dtype=acc, device=x.device)
             if init_state is None else init_state.to(acc))
    starts = []
    for k in range(n_chunks):                           # the forward walk
        sl = slice(k * L, (k + 1) * L)
        starts.append(state)
        cs = torch.cumsum(da[:, sl], dim=1)
        tail = torch.exp(cs[:, -1:, :] - cs)
        state = (state * torch.exp(cs[:, -1])[..., None, None]
                 + torch.einsum("bshn,bshp,bsh->bhpn", bh[:, sl], x_dt[:, sl], tail))

    dS = (torch.zeros((B, H, P, N), dtype=acc, device=x.device)
          if d_final is None else d_final.to(acc))
    dx_dt = torch.empty_like(x_dt)
    d_dt = torch.empty_like(dt)
    dbh = torch.empty_like(bh)
    dch = torch.empty_like(ch)
    d_a = torch.zeros_like(a)
    for k in reversed(range(n_chunks)):
        sl = slice(k * L, (k + 1) * L)
        xc, bc, cc, dyc, S0 = x_dt[:, sl], bh[:, sl], ch[:, sl], dyf[:, sl], starts[k]
        cs = torch.cumsum(da[:, sl], dim=1)             # (B, L, H)
        csh = cs.transpose(1, 2)
        w = torch.exp((csh[..., :, None] - csh[..., None, :]).masked_fill(
            ~tri, float("-inf")))                       # (B, H, l, s)
        e_cs = torch.exp(cs)
        tail = torch.exp(cs[:, -1:, :] - cs)
        total = torch.exp(cs[:, -1])                    # (B, H)
        m = torch.einsum("blhn,bshn->bhls", cc, bc) * w
        q = torch.einsum("blhp,bshp->bhls", dyc, xc) * w
        g = m * torch.einsum("blhp,bshp->bhls", dyc, xc)
        v = torch.einsum("bhpn,bshn->bshp", dS, bc)     # dS B_s
        u = torch.einsum("blhp,bhpn->blhn", dyc, S0)    # dy_l S0
        dxc = torch.einsum("bhls,blhp->bshp", m, dyc) + v * tail[..., None]
        dch[:, sl] = torch.einsum("bhls,bshn->blhn", q, bc) + u * e_cs[..., None]
        dbh[:, sl] = (torch.einsum("bhls,blhn->bshn", q, cc)
                      + torch.einsum("bshp,bhpn->bshn", xc, dS) * tail[..., None])
        t = tail * (xc * v).sum(-1)                     # (B, L, H)
        dcs = (g.sum(-1) - g.sum(-2)).transpose(1, 2) + e_cs * (cc * u).sum(-1) - t
        dcs[:, -1] += total * (dS * S0).sum((-1, -2)) + t.sum(1)
        dda = torch.flip(torch.cumsum(torch.flip(dcs, (1,)), dim=1), (1,))
        dx_dt[:, sl] = dxc
        d_dt[:, sl] = dda * a + (dxc * xf[:, sl]).sum(-1)
        d_a += (dda * dt[:, sl]).sum((0, 1))
        dS = dS * total[..., None, None] + torch.einsum("blhp,blhn,blh->bhpn",
                                                        dyc, cc, e_cs)
    dx = (dx_dt * dt[..., None]).to(x.dtype)
    db = dbh.reshape(B, S, G, rep, N).sum(3).to(b.dtype)
    dc = dch.reshape(B, S, G, rep, N).sum(3).to(c.dtype)
    return dx, d_dt, d_a, db, dc, dS


def ssd_scan_sequential(xdt, da, b, c, init_state=None):
    """xdt: (BH, S, P); da: (BH, S); b/c: (BH, S, N); ``init_state``
    (BH, P, N) or None (zeros) -> (y (BH, S, P) in xdt's dtype, final
    state (BH, P, N) fp32).

    state_t = exp(da_t) * state_{t-1} + xdt_t (outer) b_t
    y_t     = state_t @ c_t
    """
    BH, S, P = xdt.shape
    N = b.shape[-1]
    if init_state is None:
        state = torch.zeros((BH, P, N), dtype=torch.float32, device=xdt.device)
    else:
        state = init_state.float()
    ys = []
    for t in range(S):
        state = (state * torch.exp(da[:, t].float())[:, None, None]
                 + xdt[:, t, :, None].float() * b[:, t, None, :].float())
        ys.append(torch.einsum("bpn,bn->bp", state, c[:, t].float()))
    return torch.stack(ys, dim=1).to(xdt.dtype), state
