"""The flash attention's Dk != Dv mode on the CPU, where the port runs the
plain versions, against the JAX package: ``flash_fwd_ref`` /
``flash_bwd_ref`` and ``chunked_attention`` under autograd (the
``FlashAttention`` function) against the reference's ``chunked_attention``
and ``jax.vjp`` of it (its ``_flash_scan`` forward and ``_flash_chunk_bwd``
custom VJP), at reduced deepseek-v2-lite's head dims (Dk = dn + dr = 32 +
16, Dv 32) and the full config's (128 + 64, Dv 128), with and without a
softcap and a sliding window, at 3e-5; and a float64 ``gradcheck`` of
``FlashAttention`` with Dv != Dk. MLA attends 16 query heads on 16 KV
heads; the cases add a group of 2 beside it."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import (FlashAttention, flash_bwd_ref,
                                                 flash_fwd_ref)
from repro_torch.models.attention import chunked_attention
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

TOL = 3e-5
CASES = [  # B, S, H, Hkv, Dk, Dv, cap, window, q_chunk, kv_chunk
    (2, 40, 4, 4, 48, 32, None, None, 8, 16),      # reduced deepseek-v2-lite
    (1, 48, 4, 2, 48, 32, 30.0, 12, 16, 8),
    (1, 32, 2, 2, 192, 128, None, None, 16, 16),   # deepseek-v2-lite
    (1, 40, 4, 2, 192, 128, 50.0, 16, 8, 16),
]


def _inputs(seed, B, S, H, Hkv, Dk, Dv):
    rng = np.random.default_rng(seed)
    shapes = [(B, S, H, Dk), (B, S, Hkv, Dk), (B, S, Hkv, Dv), (B, S, H, Dv)]
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def _jax_vjp(q, k, v, g, **kw):
    """(out, dq, dk, dv) of the reference's chunked attention."""
    out, vjp = jax.vjp(functools.partial(jax_chunked, **kw), *map(jnp.asarray, (q, k, v)))
    return (out, *vjp(jnp.asarray(g)))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,S,H,Hkv,Dk,Dv,cap,window,qc,kvc", CASES)
def test_plain_versions_match_jax_vjp(B, S, H, Hkv, Dk, Dv, cap, window, qc, kvc):
    q, k, v, g = _inputs(0, B, S, H, Hkv, Dk, Dv)
    kw = dict(scale=Dk ** -0.5, cap=cap, window=window, q_chunk=qc, kv_chunk=kvc)
    want = _jax_vjp(q, k, v, g, **kw)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, m, l = flash_fwd_ref(tq, tk, tv, **kw)
    assert out.shape == (B, S, H, Dv) and m.shape == l.shape == (B, H, S)
    delta = (tg * out).sum(-1).transpose(1, 2).contiguous()
    grads = flash_bwd_ref(tq, tk, tv, m, l, tg, delta, **kw)
    assert [tuple(x.shape) for x in grads] == [q.shape, k.shape, v.shape]
    for got, ref in zip((out, *grads), want):
        _close(got, ref)


@pytest.mark.parametrize("B,S,H,Hkv,Dk,Dv,cap,window,qc,kvc", CASES)
def test_chunked_attention_autograd_matches_jax_vjp(B, S, H, Hkv, Dk, Dv, cap, window,
                                                    qc, kvc):
    q, k, v, g = _inputs(1, B, S, H, Hkv, Dk, Dv)
    kw = dict(scale=Dk ** -0.5, cap=cap, window=window, q_chunk=qc, kv_chunk=kvc)
    want = _jax_vjp(q, k, v, g, **kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = chunked_attention(tq, tk, tv, **kw)
    out.backward(torch.from_numpy(g))
    for got, ref in zip((out.detach(), tq.grad, tk.grad, tv.grad), want):
        _close(got, ref)


def test_flash_attention_gradcheck_float64_dk_ne_dv():
    B, S, H, Hkv, Dk, Dv = 1, 12, 4, 2, 6, 4
    q, k, v = (torch.from_numpy(a).double().requires_grad_()
               for a in _inputs(5, B, S, H, Hkv, Dk, Dv)[:3])
    for cap, window in ((None, None), (2.0, 5)):
        assert torch.autograd.gradcheck(
            lambda q, k, v: FlashAttention.apply(q, k, v, Dk ** -0.5, cap, window, 4, 8),
            (q, k, v))
