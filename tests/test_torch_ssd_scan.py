"""The port's SSD chunk scan against the JAX package: the plain PyTorch
version (``ssd_scan_ref``, model layout) against the Pallas kernel in
interpret mode at the reference tests' shapes, against ``ssd_chunked``
with a carried initial state (y and final state), and against the
sequential oracle; the oracle against the JAX oracle; and the wrapper's
CPU routing and input checks. Inputs are made with numpy and handed to
both packages. Tolerance: 2e-4, the reference's own SSD tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan import ssd_scan_ref as jax_ssd_scan_seq
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref, ssd_scan_sequential
from repro_torch.kernels.ssd_scan import ops as ssd_ops

TOL = dict(atol=2e-4, rtol=2e-4)


def _inputs(B, S, H, G, P, N, seed=0, state=False):
    """x, dt, a, b, c (and a random init_state) drawn as
    tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (B, S, H)).astype(np.float32)
    a = -rng.uniform(0.5, 8, (H,)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, G, N)).astype(np.float32)
    c = rng.normal(0, 1, (B, S, G, N)).astype(np.float32)
    init = rng.normal(0, 1, (B, H, P, N)).astype(np.float32) if state else None
    return x, dt, a, b, c, init


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _fold(x, dt, a, b, c):
    """Model layout -> the oracle's (batch*head) layout, as the JAX
    wrapper folds it."""
    B, S, H, P = x.shape
    rep = H // b.shape[2]
    xdt = (x * dt[..., None]).transpose(0, 2, 1, 3).reshape(B * H, S, P)
    da = (dt * a[None, None, :]).transpose(0, 2, 1).reshape(B * H, S)
    bh = np.repeat(b, rep, 2).transpose(0, 2, 1, 3).reshape(B * H, S, -1)
    ch = np.repeat(c, rep, 2).transpose(0, 2, 1, 3).reshape(B * H, S, -1)
    return xdt, da, bh, ch


@pytest.mark.parametrize("B,S,H,G,P,N,chunk", [
    (1, 64, 2, 1, 8, 16, 16), (2, 128, 4, 2, 16, 8, 32), (1, 96, 3, 1, 8, 8, 32),
])
def test_plain_matches_pallas_kernel(B, S, H, G, P, N, chunk):
    x, dt, a, b, c, _ = _inputs(B, S, H, G, P, N)
    want = jax_ssd_scan(*(jnp.asarray(v) for v in (x, dt, a, b, c)), chunk=chunk)
    y, _ = ssd_scan_ref(*(_t(v) for v in (x, dt, a, b, c)), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,chunk", [(1, 256), (9, 256), (32, 256), (64, 16),
                                     (96, 64)])
@pytest.mark.parametrize("G", [1, 2])
def test_plain_matches_ssd_chunked_with_state(S, chunk, G):
    """y and the final state, continuing from a random carried state;
    (96, 64) walks 32-token chunks (64 halves until it divides 96)."""
    x, dt, a, b, c, init = _inputs(2, S, 4, G, 8, 16, seed=S, state=True)
    jy, jstate = jax_ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, b, c)),
                                 chunk=chunk, init_state=jnp.asarray(init))
    y, state = ssd_scan_ref(*(_t(v) for v in (x, dt, a, b, c)), chunk=chunk,
                            init_state=_t(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)


@pytest.mark.parametrize("S,chunk", [(9, 256), (40, 8), (64, 32)])
def test_plain_matches_sequential_oracle(S, chunk):
    x, dt, a, b, c, init = _inputs(2, S, 4, 2, 8, 16, seed=3, state=True)
    y, state = ssd_scan_ref(*(_t(v) for v in (x, dt, a, b, c)), chunk=chunk,
                            init_state=_t(init))
    B, _, H, P = x.shape
    ys, ss = ssd_scan_sequential(*(_t(v) for v in _fold(x, dt, a, b, c)),
                                 init_state=_t(init.reshape(B * H, P, -1)))
    np.testing.assert_allclose(
        y.numpy(), ys.numpy().reshape(B, H, S, P).transpose(0, 2, 1, 3), **TOL)
    np.testing.assert_allclose(state.numpy(), ss.numpy().reshape(state.shape),
                               **TOL)


def test_sequential_oracle_matches_jax_oracle():
    x, dt, a, b, c, _ = _inputs(1, 24, 3, 1, 8, 8, seed=4)
    folded = _fold(x, dt, a, b, c)
    want = jax_ssd_scan_seq(*(jnp.asarray(v) for v in folded))
    ys, _ = ssd_scan_sequential(*(_t(v) for v in folded))
    np.testing.assert_allclose(ys.numpy(), np.asarray(want), **TOL)


def test_bf16_inputs_compute_in_fp32():
    """bf16 x/b/c: the plain version upcasts, computes in fp32 and rounds y
    once, so it equals the fp32 run on the same (bf16-representable)
    values rounded to bf16."""
    x, dt, a, b, c, init = _inputs(1, 32, 4, 1, 8, 16, seed=5, state=True)
    xb, bb, cb = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, b, c))
    y16, s16 = ssd_scan_ref(xb, _t(dt), _t(a), bb, cb, chunk=256,
                            init_state=_t(init))
    y32, s32 = ssd_scan_ref(xb.float(), _t(dt), _t(a), bb.float(), cb.float(),
                            chunk=256, init_state=_t(init))
    assert y16.dtype == torch.bfloat16 and s16.dtype == torch.float32
    assert torch.equal(y16, y32.to(torch.bfloat16))
    assert torch.equal(s16, s32)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    x, dt, a, b, c, init = _inputs(1, 9, 4, 2, 8, 16, seed=6, state=True)
    args = [_t(v) for v in (x, dt, a, b, c)]
    before = ssd_scan.launches
    y, state = ssd_scan(*args, chunk=256, init_state=_t(init))
    ry, rstate = ssd_scan_ref(*args, chunk=256, init_state=_t(init))
    assert torch.equal(y, ry) and torch.equal(state, rstate)
    assert ssd_scan.launches == before


@pytest.mark.parametrize("bad,match", [
    (lambda v: v.update(x=v["x"].double()), "float32 or all bfloat16"),
    (lambda v: v.update(dt=v["dt"].to(torch.bfloat16)), "dt must be float32"),
    (lambda v: v.update(b=v["b"][:, :, :1].expand(-1, -1, 3, -1).contiguous(),
                        c=v["c"][:, :, :1].expand(-1, -1, 3, -1).contiguous()),
     "do not match"),
    (lambda v: v.update(a=v["a"][:2]), r"dt must be \(B, S, H\)"),
    (lambda v: v.update(init_state=v["init_state"][..., :8]), "init_state must be"),
    (lambda v: v.update(x=v["x"].transpose(2, 3).contiguous().transpose(2, 3)),
     "dense over"),
])
def test_wrapper_checks_refuse_what_the_kernel_does_not_take(bad, match):
    x, dt, a, b, c, init = _inputs(1, 9, 4, 2, 8, 16, seed=7, state=True)
    v = dict(x=_t(x), dt=_t(dt), a=_t(a), b=_t(b), c=_t(c), init_state=_t(init))
    ssd_ops._check(**v)
    bad(v)
    with pytest.raises((TypeError, ValueError), match=match):
        ssd_ops._check(**v)


def test_wrapper_checks_accept_projection_views():
    """The model hands the kernel x, b and c as views into the conv
    output (strided over the sequence): the checks take them as they
    are, without a copy."""
    rng = np.random.default_rng(8)
    B, S, H, P, G, N = 1, 9, 4, 8, 1, 16
    xbc = torch.from_numpy(rng.normal(0, 1, (B, S, H * P + 2 * G * N))
                           .astype(np.float32))
    x = xbc[..., :H * P].reshape(B, S, H, P)
    b = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
    c = xbc[..., H * P + G * N:].reshape(B, S, G, N)
    assert not x.is_contiguous() and x.data_ptr() == xbc.data_ptr()
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (B, S, H)).astype(np.float32))
    ssd_ops._check(x, dt, -torch.ones(H), b, c, None)
