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
- :func:`ssd_scan_sequential` is the port of
  ``repro.kernels.ssd_scan.ref.ssd_scan_ref``: the token-by-token
  recurrence in the kernel's (batch·head) layout, an implementation
  independent of the chunked one, for the tests. It also takes an
  initial state and returns the final one.
"""
from __future__ import annotations

from typing import Optional

import torch


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
    L = min(chunk, S)
    while S % L:
        L //= 2
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
