"""The port's flash attention (repro_torch.kernels.flash_attention and
models.attention.chunked_attention) on the CPU, where it runs the plain
versions, against the JAX package: chunked_attention values (3e-5) and
gradients (2e-4, the reference's own tolerances, tests/test_models.py),
the Pallas flash kernel in interpret mode (3e-5 fp32, 2e-2 bf16,
tests/test_kernels.py), a float64 gradcheck of the autograd function, and
the argument checks the CUDA wrappers apply before a launch."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import (FlashAttention, attention_ref,
                                                 flash_fwd_ref, ops)
from repro_torch.models.attention import chunked_attention


def _inputs(seed, B, S, H, Hkv, D, n=3):
    rng = np.random.default_rng(seed)
    shapes = [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)]
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes[:n]]


@pytest.mark.parametrize("window,cap,qc,kvc", [
    (None, None, 16, 16), (None, 50.0, 32, 16), (24, None, 16, 32),
    (24, 30.0, 64, 64), (None, None, 128, 128),
])
def test_chunked_attention_matches_jax(window, cap, qc, kvc):
    B, S, H, Hkv, D = 2, 96, 4, 2, 16
    q, k, v = _inputs(0, B, S, H, Hkv, D)
    kw = dict(scale=D ** -0.5, window=window, cap=cap, q_chunk=qc, kv_chunk=kvc)
    ref = np.asarray(jax.jit(functools.partial(jax_chunked, **kw))(
        *map(jnp.asarray, (q, k, v))))
    out = chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("cap,window", [(None, None), (30.0, 24)])
def test_chunked_attention_grads_match_jax(cap, window):
    B, S, H, D = 1, 64, 2, 8
    q, k, v, g = _inputs(1, B, S, H, H, D, n=4)
    kw = dict(scale=D ** -0.5, cap=cap, window=window, q_chunk=16, kv_chunk=16)

    def f(q, k, v):
        return (jax_chunked(q, k, v, **kw) * jnp.asarray(g)).sum()

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (chunked_attention(tq, tk, tv, **kw) * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap,window", [(50.0, None), (None, 48)])
def test_plain_forward_matches_pallas_interpret(dtype, cap, window):
    """MQA at D 64 (the sweep's (1, 256, 8, 1, 64) case, at S 128)."""
    B, S, H, Hkv, D = 1, 128, 8, 1, 64
    q, k, v = _inputs(42, B, S, H, Hkv, D)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)), scale=D ** -0.5,
                    cap=cap, window=window, q_block=32, kv_block=32)
    tdt = getattr(torch, dtype)
    out, _, _ = flash_fwd_ref(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                              scale=D ** -0.5, cap=cap, window=window,
                              q_chunk=32, kv_chunk=32)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_forward_stats_are_the_softmax_max_and_denominator():
    """m and l are what the backward (and the kernel) rely on: the row max
    of the post-mask scores and the row sum of exp(s - m)."""
    B, S, H, Hkv, D = 1, 40, 4, 2, 8
    q, k, v = (torch.from_numpy(a).double() for a in _inputs(3, B, S, H, Hkv, D))
    out, m, l = flash_fwd_ref(q, k, v, scale=0.3, window=9, q_chunk=8, kv_chunk=16)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, S, Hkv, 2, D), k) * 0.3
    pos = torch.arange(S)
    mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - 9)
    s = torch.where(mask, s, -torch.inf).reshape(B, H, S, S)
    torch.testing.assert_close(m, s.amax(-1), rtol=0, atol=1e-12)
    torch.testing.assert_close(l, torch.exp(s - s.amax(-1, keepdim=True)).sum(-1))
    torch.testing.assert_close(out, attention_ref(q, k, v, scale=0.3, window=9))


def test_flash_attention_gradcheck_float64():
    B, S, H, Hkv, D = 1, 12, 4, 2, 4
    q, k, v = (torch.from_numpy(a).double().requires_grad_()
               for a in _inputs(5, B, S, H, Hkv, D))
    for cap, window in ((None, None), (2.0, 5)):
        assert torch.autograd.gradcheck(
            lambda q, k, v: FlashAttention.apply(q, k, v, 0.5, cap, window, 4, 8),
            (q, k, v))


def test_cuda_wrapper_checks_before_launch():
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    with pytest.raises(NotImplementedError, match="A.7"):
        ops._check(q, k, torch.zeros(1, 8, 2, 32))        # Dk != Dv: MLA
    with pytest.raises(ValueError, match="head_dim"):
        ops._check(q[..., :48], k[..., :48], k[..., :48])
    with pytest.raises(TypeError):
        ops._check(q.bfloat16(), k, k)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="no flash_attention_fwd"):
        ops.flash_attention_fwd(q.to("meta"), k.to("meta"), k.to("meta"),
                                scale=1.0)
    ops._check(q, k, k)                                    # accepted as is
