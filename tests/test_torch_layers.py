"""The port's layer primitives (repro_torch.models.layers) against the JAX
package's on the same numpy inputs: fp32 within 1e-6 relative, bf16
within 2e-2 (bf16 rounds at other places in the two frameworks). The
bound is relative to the reference's largest magnitude: matrix products
sum in another order, so a single element that cancels to near zero can
differ by more than 1e-6 of itself."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as jl
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as tl
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

TOLS = {"float32": 1e-6, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a)).to(td)


def _close(t, j, dtype):
    ref = np.asarray(j, np.float32)
    tol = TOLS[dtype]
    np.testing.assert_allclose(t.float().numpy(), ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _cfgs(dtype, **kw):
    jc = jax_reduced(jax_get_config("qwen3-8b"), dtype=dtype, param_dtype=dtype, **kw)
    tc = reduced(get_config("qwen3-8b"), dtype=dtype, param_dtype=dtype, **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(0, 3, (2, 5, 64)).astype(np.float32), dtype)
    gj, gt = _pair(rng.normal(0, 0.1, (64,)).astype(np.float32), dtype)
    _close(tl.rmsnorm(xt, gt, 1e-6), jl.rmsnorm(xj, gj, 1e-6), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos_shape", ["scalar", "seq", "batch_seq"])
def test_apply_rope(dtype, pos_shape):
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 6, 3, 32
    xj, xt = _pair(rng.normal(0, 1, (B, S, H, D)).astype(np.float32), dtype)
    pos = {"scalar": np.int32(17), "seq": np.arange(40, 40 + S, dtype=np.int32),
           "batch_seq": rng.integers(0, 120, (B, S)).astype(np.int32)}[pos_shape]
    theta = 1_000_000.0
    np.testing.assert_allclose(tl.rope_freqs(D, theta).numpy(),
                               np.asarray(jl.rope_freqs(D, theta)), rtol=1e-6)
    _close(tl.apply_rope(xt, torch.as_tensor(pos), theta),
           jl.apply_rope(xj, jnp.asarray(pos), theta), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_activation_and_softcap(dtype, name):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.normal(0, 4, (7, 33)).astype(np.float32), dtype)
    _close(tl.activation(name)(xt), jl.activation(name)(xj), dtype)
    _close(tl.softcap(xt, 5.0), jl.softcap(xj, 5.0), dtype)
    assert tl.softcap(xt, None) is xt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(dtype):
    jc, tc = _cfgs(dtype)
    rng = np.random.default_rng(3)
    defs = tl.mlp_defs(tc, tc.d_ff)
    assert {k: d.shape for k, d in defs.items()} == {
        k: d.shape for k, d in jl.mlp_defs(jc, jc.d_ff).items()}
    p = {k: rng.normal(0, d.shape[0] ** -0.5, d.shape).astype(np.float32)
         for k, d in defs.items()}
    xj, xt = _pair(rng.normal(0, 1, (2, 4, tc.d_model)).astype(np.float32), dtype)
    pj = {k: _pair(v, dtype)[0] for k, v in p.items()}
    pt = {k: _pair(v, dtype)[1] for k, v in p.items()}
    _close(tl.mlp(tc, pt, xt), jl.mlp(jc, pj, xj), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tie,cap", [(False, None), (True, 30.0)])
def test_embed_and_lm_logits(dtype, tie, cap):
    jc, tc = _cfgs(dtype, tie_embeddings=tie, final_softcap=cap,
                   scale_embeddings=tie)
    rng = np.random.default_rng(4)
    defs = tl.embed_defs(tc)
    jdefs = jl.embed_defs(jc)
    assert {k: (d.shape, d.std) for k, d in defs.items()} == {
        k: (d.shape, d.std) for k, d in jdefs.items()}
    p = {k: rng.normal(0, 0.5, d.shape).astype(np.float32) for k, d in defs.items()}
    pj = {k: _pair(v, dtype)[0] for k, v in p.items()}
    pt = {k: _pair(v, dtype)[1] for k, v in p.items()}
    toks = rng.integers(0, tc.vocab_size, (2, 5)).astype(np.int32)
    _close(tl.embed(tc, pt, torch.from_numpy(toks)),
           jl.embed(jc, pj, jnp.asarray(toks)), dtype)
    xj, xt = _pair(rng.normal(0, 1, (2, tc.d_model)).astype(np.float32), dtype)
    _close(tl.lm_logits(tc, pt, xt), jl.lm_logits(jc, pj, xj), dtype)
