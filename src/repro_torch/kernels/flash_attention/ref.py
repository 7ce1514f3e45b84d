"""Plain PyTorch versions of the flash-attention kernels: the CPU path of
``ops`` and the oracles the card checks the kernels against.

Layout as in ``repro.models.attention.chunked_attention``: q (B, Sq, H,
Dk), k (B, Skv, Hkv, Dk), v (B, Skv, Hkv, Dv), query head ``hkv*G + g``
with G = H // Hkv. Query i sits at position i, key j at position j:
causal self-attention over an unpadded sequence, with an optional tanh
softcap and sliding window, applied as scale -> softcap -> mask.

- ``attention_ref``  — the naive oracle (port of
  ``repro.kernels.flash_attention.ref.attention_ref``, in the model
  layout);
- ``flash_fwd_ref``  — the chunked online softmax returning ``(out, m,
  l)`` (port of ``_flash_scan``, ``repro/models/attention.py:86``);
- ``flash_bwd_ref``  — the backward that recomputes each block's
  probabilities from the saved ``(m, l)`` (port of ``_flash_chunk_bwd``,
  ``repro/models/attention.py:126``).

Sums run in fp32 (fp64 for fp64 inputs, so ``gradcheck`` can use these).
A masked score contributes exactly 0, so a row with no visible key has
``l == 0`` (stored as 1) and outputs 0.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def _mask(qpos, kpos, window: Optional[int]):
    """(Q, K) bool: key visible to query."""
    mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    return mask


def _scores(q_i, kc, qpos, kpos, scale, cap, window):
    """Post-cap scores (B, Hkv, G, Q, K), the tanh values (or None) and
    the mask (Q, K)."""
    s = torch.einsum("bhgqd,bkhd->bhgqk", q_i, kc) * scale
    t = None
    if cap is not None:
        t = torch.tanh(s / cap)
        s = t * cap
    return s, t, _mask(qpos, kpos, window)


def _chunks(Sq: int, Skv: int, window, q_chunk: int, kv_chunk: int):
    """The JAX chunking (``chunked_attention``): q chunks dividing Sq, and
    for each the kv chunks from its window start (aligned down to the kv
    grid) to its causal end. Yields (q0, q1, [(k0, k1), ...])."""
    q_chunk = min(q_chunk, Sq)
    while Sq % q_chunk:
        q_chunk //= 2
    kv_chunk = min(kv_chunk, Skv)
    for q0 in range(0, Sq, q_chunk):
        hi = min(Skv, q0 + q_chunk)
        lo = 0
        if window is not None:
            lo = max(0, q0 - window + 1) // kv_chunk * kv_chunk
        yield q0, q0 + q_chunk, [(k0, min(k0 + kv_chunk, hi))
                                 for k0 in range(lo, hi, kv_chunk)]


def _grouped(x, Hkv: int):
    """(B, S, H, D) -> (B, Hkv, G, S, D)."""
    B, S, H, D = x.shape
    return x.reshape(B, S, Hkv, H // Hkv, D).permute(0, 2, 3, 1, 4)


def attention_ref(q, k, v, *, scale: float, cap: Optional[float] = None,
                  window: Optional[int] = None):
    """Naive causal attention -> (B, Sq, H, Dv) in q's dtype. Differentiable
    by autograd (the oracle of the backward)."""
    B, Sq, H, _ = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    acc = _acc_dtype(q)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    s, _, mask = _scores(_grouped(q.to(acc), Hkv), k.to(acc), qpos, kpos,
                         scale, cap, window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l == 0, 1.0, l)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(acc))
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


@torch.no_grad()
def flash_fwd_ref(q, k, v, *, scale: float, cap: Optional[float] = None,
                  window: Optional[int] = None, q_chunk: int = 512,
                  kv_chunk: int = 1024):
    """Chunked online-softmax attention. Returns (out (B, Sq, H, Dv) in
    v's dtype, m (B, H, Sq), l (B, H, Sq)) with m the running max of the
    post-mask scores and l the softmax denominator (1 where it is 0), both
    fp32 (fp64 for fp64 inputs) — what the backward needs. As in
    ``_flash_scan``, the probabilities are rounded to v's dtype before the
    product with V."""
    B, Sq, H, _ = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    acc_t = _acc_dtype(q)
    qg = _grouped(q.to(acc_t), Hkv)
    kf, vf = k.to(acc_t), v.to(acc_t)
    out = torch.empty((B, Hkv, G, Sq, Dv), dtype=acc_t, device=q.device)
    m_out = torch.empty((B, Hkv, G, Sq), dtype=acc_t, device=q.device)
    l_out = torch.empty_like(m_out)
    for q0, q1, kv_ranges in _chunks(Sq, Skv, window, q_chunk, kv_chunk):
        q_i = qg[:, :, :, q0:q1]
        qpos = torch.arange(q0, q1, device=q.device)
        m = torch.full((B, Hkv, G, q1 - q0), NEG_INF, dtype=acc_t, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, q1 - q0, Dv), dtype=acc_t, device=q.device)
        for k0, k1 in kv_ranges:
            kpos = torch.arange(k0, k1, device=q.device)
            s, _, mask = _scores(q_i, kf[:, k0:k1], qpos, kpos, scale, cap, window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None]) * mask
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).to(acc_t),
                              vf[:, k0:k1])
            acc = acc * corr[..., None] + pv
            m = m_new
        l = torch.where(l == 0, 1.0, l)
        out[:, :, :, q0:q1] = acc / l[..., None]
        m_out[:, :, :, q0:q1] = m
        l_out[:, :, :, q0:q1] = l
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(v.dtype)
    return out, m_out.reshape(B, H, Sq), l_out.reshape(B, H, Sq)


@torch.no_grad()
def flash_bwd_ref(q, k, v, m, l, dout, delta, *, scale: float,
                  cap: Optional[float] = None, window: Optional[int] = None,
                  q_chunk: int = 512, kv_chunk: int = 1024):
    """Gradients of ``flash_fwd_ref``'s output. m, l: (B, H, Sq) from the
    forward; dout (B, Sq, H, Dv); delta (B, H, Sq) = rowsum(dout * out) in
    fp32. Per block: P = exp(s - m) / l on visible keys, dV += Pᵀ dO,
    dS = P (dO Vᵀ - delta), times (1 - tanh²) under a softcap, times the
    scale; dQ += dS K, dK += dSᵀ Q. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    B, Sq, H, Dk = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    acc_t = _acc_dtype(q)
    qg = _grouped(q.to(acc_t), Hkv)
    gg = _grouped(dout.to(acc_t), Hkv)
    kf, vf = k.to(acc_t), v.to(acc_t)
    mg = m.to(acc_t).reshape(B, Hkv, G, Sq)
    lg = l.to(acc_t).reshape(B, Hkv, G, Sq)
    dg = delta.to(acc_t).reshape(B, Hkv, G, Sq)
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0, q1, kv_ranges in _chunks(Sq, Skv, window, q_chunk, kv_chunk):
        q_i, g_i = qg[:, :, :, q0:q1], gg[:, :, :, q0:q1]
        m_i, l_i, d_i = (x[..., q0:q1, None] for x in (mg, lg, dg))
        qpos = torch.arange(q0, q1, device=q.device)
        for k0, k1 in kv_ranges:
            kpos = torch.arange(k0, k1, device=q.device)
            kc, vc = kf[:, k0:k1], vf[:, k0:k1]
            s, t, mask = _scores(q_i, kc, qpos, kpos, scale, cap, window)
            p = torch.exp(torch.where(mask, s, NEG_INF) - m_i) / l_i * mask
            dv[:, k0:k1] += torch.einsum("bhgqk,bhgqd->bkhd", p, g_i)
            dp = torch.einsum("bhgqd,bkhd->bhgqk", g_i, vc)
            ds = p * (dp - d_i)
            if t is not None:
                ds = ds * (1.0 - torch.square(t))
            ds = ds * scale
            dq[:, :, :, q0:q1] += torch.einsum("bhgqk,bkhd->bhgqd", ds, kc)
            dk[:, k0:k1] += torch.einsum("bhgqk,bhgqd->bkhd", ds, q_i)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dk)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
