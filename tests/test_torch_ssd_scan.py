"""The port's SSD chunk scan against the JAX package: the plain PyTorch
version (``ssd_scan_ref``, model layout) against the Pallas kernel in
interpret mode at the reference tests' shapes, against ``ssd_chunked``
with a carried initial state (y and final state), and against the
sequential oracle; the oracle against the JAX oracle; the wrapper's CPU
routing and input checks; and a plain-torch emulation of the bf16
tensor-core kernel's arithmetic against the plain version. Inputs are made
with numpy and handed to both packages. Tolerance: 2e-4, the reference's
own SSD tolerance (bf16 y: chip_smoke.py's limits)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan import ssd_scan_ref as jax_ssd_scan_seq
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref, ssd_scan_sequential
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

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


# -- the bf16 tensor-core kernel's arithmetic, emulated in plain torch ------
#
# The kernel (csrc/ssd_scan.cu, ssd_scan_mma_kernel) walks 32-token blocks
# and runs every product on mma.sync with bf16 operands and fp32 sums, one
# operand an exact bf16 input, the fp32 operand split into bf16 hi + lo.
# Below, the same arithmetic: bf16 values held in fp32 (their products are
# exact in fp32), fp32 matmuls for the sums. Never on the main path.

BLOCK = 32
Y_RTOL = 2 ** -6        # chip_smoke.py's bf16 y limit: rtol, and atol
STATE_TOL = 2e-4        # SSD_TOL x max|y|; the state: atol = rtol = SSD_TOL


def _split(v, keep_lo=True):
    """fp32 -> (hi, lo), each a bf16 value held in fp32."""
    hi = v.to(torch.bfloat16).float()
    lo = (v - hi).to(torch.bfloat16).float()
    return hi, lo if keep_lo else torch.zeros_like(lo)


def _emulate_kernel(x, dt, a, b, c, init_state=None, keep_lo=True):
    """The bf16 kernel's arithmetic on (B, S, H, P) bf16 x and (B, S, G, N)
    bf16 b/c; returns (y bf16, final state fp32). ``keep_lo=False`` drops
    the lo halves: single-pass bf16 rounding of the fp32 operands."""
    B, S, H, P = x.shape
    rep = H // b.shape[2]
    xf = x.float().transpose(1, 2)                               # (B, H, S, P)
    bf = b.float().repeat_interleave(rep, 2).transpose(1, 2)     # (B, H, S, N)
    cf = c.float().repeat_interleave(rep, 2).transpose(1, 2)
    dtf = dt.float().transpose(1, 2)                             # (B, H, S)
    state = (torch.zeros((B, H, P, b.shape[3])) if init_state is None
             else init_state.float().clone())
    ys = []
    for t0 in range(0, S, BLOCK):
        sl = slice(t0, min(S, t0 + BLOCK))
        xb, bb, cb, dtb = xf[:, :, sl], bf[:, :, sl], cf[:, :, sl], dtf[:, :, sl]
        L = xb.shape[2]
        cs = torch.cumsum(dtb * a[None, :, None], dim=-1)        # (B, H, L)
        tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
        seg = torch.where(tri, cs[..., :, None] - cs[..., None, :], -torch.inf)
        m = (cb @ bb.transpose(-1, -2)) * torch.exp(seg) * dtb[..., None, :]
        mh, ml = _split(m, keep_lo)
        y_in = mh @ xb + ml @ xb
        sh, sl_ = _split(state, keep_lo)
        y_off = cb @ sh.transpose(-1, -2) + cb @ sl_.transpose(-1, -2)
        ys.append(y_in + torch.exp(cs)[..., None] * y_off)
        w = dtb * torch.exp(cs[..., -1:] - cs)
        xh, xl = _split(xb * w[..., None], keep_lo)
        state = (state * torch.exp(cs[..., -1])[..., None, None]
                 + xh.transpose(-1, -2) @ bb + xl.transpose(-1, -2) @ bb)
    y = torch.cat(ys, dim=2).transpose(1, 2)
    return y.to(torch.bfloat16), state


def _bf16_inputs(B, S, H, G, P, N, seed, state):
    x, dt, a, b, c, init = _inputs(B, S, H, G, P, N, seed=seed, state=state)
    xb, bb, cb = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, b, c))
    return xb, _t(dt), _t(a), bb, cb, _t(init)


def _within_chip_limits(y, state, want_y, want_state):
    """chip_smoke.py's bf16 limits: y within rtol 2**-6 and atol 2e-4 x
    max|y|, the state within 2e-4 atol and rtol."""
    scale = want_y.float().abs().max().item()
    return (torch.allclose(y.float(), want_y.float(), rtol=Y_RTOL,
                           atol=STATE_TOL * scale)
            and torch.allclose(state, want_state, atol=STATE_TOL, rtol=STATE_TOL))


@pytest.mark.parametrize("S", [1, 9, 32, 40])
@pytest.mark.parametrize("state", [False, True])
def test_tensor_core_arithmetic_matches_plain_version(S, state):
    """hi/lo splits of the fp32 operands, exact bf16 products and fp32 sums
    agree with the plain version within the limits chip_smoke.py holds the
    bf16 kernel to, on ragged blocks (S 1, 9, 40) and with G > 1."""
    args = _bf16_inputs(1, S, 4, 2, 16, 32, seed=10 + S, state=state)
    y, st = _emulate_kernel(*args)
    want_y, want_st = ssd_scan_ref(*args[:5], chunk=256, init_state=args[5])
    assert y.dtype == torch.bfloat16 and st.shape == want_st.shape
    assert _within_chip_limits(y, st, want_y, want_st)


def test_tensor_core_state_error_stays_bounded_over_chunks():
    """The state carried chunk to chunk (8 chunks of 32 tokens, each
    resuming from the previous one's state, as prefill chunks resume from
    state pages): its error against the plain version's own chain stays
    inside 2e-4 and does not grow. Dropping the lo halves (single-pass bf16
    operands) does not hold that tolerance."""
    rng_state = _inputs(1, 1, 4, 1, 16, 32, seed=20, state=True)[5]
    state = want = torch.from_numpy(rng_state)
    lossy = state
    errs, lossy_errs = [], []
    for k in range(8):
        xb, dt, a, bb, cb, _ = _bf16_inputs(1, 32, 4, 1, 16, 32, seed=30 + k,
                                            state=False)
        y, state = _emulate_kernel(xb, dt, a, bb, cb, state)
        want_y, want = ssd_scan_ref(xb, dt, a, bb, cb, chunk=256, init_state=want)
        _, lossy = _emulate_kernel(xb, dt, a, bb, cb, lossy, keep_lo=False)
        assert _within_chip_limits(y, state, want_y, want)
        errs.append((state - want).abs().max().item())
        lossy_errs.append((lossy - want).abs().max().item())
    assert max(errs[4:]) <= 2 * max(errs[:4])
    assert max(lossy_errs) > STATE_TOL > max(errs)


# -- refusals of the bf16 kernel ---------------------------------------------

def _bf16_views(P=16, N=16, width_pad=0, offset=0):
    """x, b, c as views into one bf16 projection (B 1, S 9, H 4, G 1), as
    the model hands them over; ``width_pad`` widens each token's row and
    ``offset`` shifts the views' start, in elements."""
    rng = np.random.default_rng(9)
    B, S, H, G = 1, 9, 4, 1
    width = H * P + 2 * G * N + width_pad
    flat = torch.from_numpy(rng.normal(0, 1, B * S * width + offset)
                            .astype(np.float32)).to(torch.bfloat16)
    xbc = flat[offset:].view(B, S, width)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    b = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
    c = xbc[..., H * P + G * N:H * P + 2 * G * N].reshape(B, S, G, N)
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (B, S, H)).astype(np.float32))
    return dict(x=x, dt=dt, a=-torch.ones(H), b=b, c=c,
                init_state=torch.zeros((B, H, P, N)))


def test_wrapper_checks_accept_bf16_projection_views():
    """The bf16 kernel takes the model's views into the conv output as
    they are: 16-byte aligned rows, strided over the sequence."""
    v = _bf16_views()
    assert not v["x"].is_contiguous()
    ssd_ops._check(**v)


def _misaligned_state():
    v = _bf16_views()
    flat = torch.zeros(v["init_state"].numel() + 1)
    return dict(v, init_state=flat[1:].view(v["init_state"].shape))


@pytest.mark.parametrize("make,match", [
    (lambda: _bf16_views(P=8), r"P 8 and N 16 must be multiples of 16"),
    (lambda: _bf16_views(N=24), r"P 16 and N 24 must be multiples of 16"),
    (lambda: _bf16_views(width_pad=4), "x's rows must start 16-byte aligned"),
    (lambda: _bf16_views(offset=4), "x's rows must start 16-byte aligned"),
    (lambda: dict(_bf16_views(), b=_bf16_views(offset=4)["b"]),
     "b's rows must start 16-byte aligned"),
    (lambda: dict(_bf16_views(), c=_bf16_views(offset=4)["c"]),
     "c's rows must start 16-byte aligned"),
    (_misaligned_state, "init_state must start 16-byte aligned"),
])
def test_wrapper_checks_refuse_what_the_bf16_kernel_does_not_take(make, match):
    with pytest.raises(ValueError, match=match):
        ssd_ops._check(**make())
