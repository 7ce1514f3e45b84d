"""The SSD scan's backward in the port: the plain version
(``ssd_scan_bwd_ref``, derived by hand chunk by chunk) against ``jax.vjp``
of the reference's ``ssd_chunked`` and against ``torch.autograd`` through
``ssd_scan_ref``, with a carried initial state and a final-state
cotangent, at S spanning several chunks and at an S whose chunk halves;
a float64 transcription of the bf16 kernels' two-phase decomposition
against ``jax.vjp``; ``SSDScan`` on CPU tensors routing to the plain
versions; and the backward wrapper's input checks. Inputs are made with
numpy and handed to both packages. Tolerance: 1e-5 of each gradient's
largest |value| (both sides sum in fp32, in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import (SSDScan, ssd_scan, ssd_scan_bwd,
                                          ssd_scan_bwd_ref, ssd_scan_ref)
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

REL = 1e-5
NAMES = ("dx", "d_dt", "d_a", "db", "dc", "d_init")


def _inputs(B, S, H, G, P, N, seed=0):
    """x, dt, a, b, c, init_state and the cotangents dy, d_final, drawn as
    tests/test_kernels.py draws the scan's inputs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (B, S, H)).astype(np.float32)
    a = -rng.uniform(0.5, 8, (H,)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, G, N)).astype(np.float32)
    c = rng.normal(0, 1, (B, S, G, N)).astype(np.float32)
    init = rng.normal(0, 1, (B, H, P, N)).astype(np.float32)
    dy = rng.normal(0, 1, (B, S, H, P)).astype(np.float32)
    d_final = rng.normal(0, 1, (B, H, P, N)).astype(np.float32)
    return x, dt, a, b, c, init, dy, d_final


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("B,S,H,G,P,N,chunk", [
    (2, 64, 4, 2, 8, 16, 16),      # four chunks, two heads a group
    (1, 40, 3, 1, 8, 8, 16),       # 16 halves to 8: five chunks
    (2, 96, 4, 1, 8, 16, 64),      # 64 halves to 32
    (1, 9, 2, 2, 4, 8, 256),       # one chunk shorter than the kernels' block
])
def test_plain_backward_matches_jax_vjp(B, S, H, G, P, N, chunk):
    x, dt, a, b, c, init, dy, d_final = _inputs(B, S, H, G, P, N, seed=S)
    _, vjp = jax.vjp(lambda *v: jax_ssd_chunked(*v[:5], chunk, init_state=v[5]),
                     *(jnp.asarray(v) for v in (x, dt, a, b, c, init)))
    want = vjp((jnp.asarray(dy), jnp.asarray(d_final)))
    got = ssd_scan_bwd_ref(*(torch.from_numpy(v) for v in (x, dt, a, b, c, dy)),
                           chunk=chunk, init_state=torch.from_numpy(init),
                           d_final=torch.from_numpy(d_final))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g.numpy(), w, name)


def test_plain_backward_matches_jax_vjp_without_state_or_final_cotangent():
    x, dt, a, b, c, _, dy, _ = _inputs(2, 64, 4, 1, 8, 16, seed=11)
    _, vjp = jax.vjp(lambda *v: jax_ssd_chunked(*v, 32)[0],
                     *(jnp.asarray(v) for v in (x, dt, a, b, c)))
    want = vjp(jnp.asarray(dy))
    got = ssd_scan_bwd_ref(*(torch.from_numpy(v) for v in (x, dt, a, b, c, dy)),
                           chunk=32)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w, name)


@pytest.mark.parametrize("S,chunk", [(64, 32), (40, 32), (17, 256)])
def test_plain_backward_matches_torch_autograd(S, chunk):
    x, dt, a, b, c, init, dy, d_final = _inputs(2, S, 4, 2, 8, 16, seed=20 + S)
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, dt, a, b, c, init)]
    y, final = ssd_scan_ref(*leaves[:5], chunk=chunk, init_state=leaves[5])
    want = torch.autograd.grad((y, final), leaves,
                               (torch.from_numpy(dy), torch.from_numpy(d_final)))
    got = ssd_scan_bwd_ref(*(torch.from_numpy(v) for v in (x, dt, a, b, c, dy)),
                           chunk=chunk, init_state=torch.from_numpy(init),
                           d_final=torch.from_numpy(d_final))
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w.numpy(), name)


def _two_phase_bwd(x, dt, a, b, c, dy, init, d_final, block=32):
    """The bf16 kernels' decomposition, in float64 (numpy). Phase 1: per
    (batch, head) the state at each ``block``-token block's start, walked
    first to last, and the cotangent of the state at each block's end,
    walked last to first (its last value is d_init). Phase 2: per (batch,
    block, group) every head's gradients from those two alone, dB and dC
    summed over the group's heads in head order."""
    x, dt, a, b, c, dy, init, d_final = (np.asarray(v, np.float64) for v in
                                         (x, dt, a, b, c, dy, init, d_final))
    B, S, H, P = x.shape
    G, N = b.shape[2:]
    rep = H // G
    spans = [(t0, min(S, t0 + block)) for t0 in range(0, S, block)]
    s0 = np.zeros((B, len(spans), H, P, N))
    ds = np.zeros_like(s0)
    d_init = np.zeros((B, H, P, N))
    for bi in range(B):
        for h in range(H):
            g = h // rep
            state, dstate = init[bi, h], d_final[bi, h]
            for k, (t0, t1) in enumerate(spans):
                s0[bi, k, h] = state
                cs = np.cumsum(dt[bi, t0:t1, h] * a[h])
                w = dt[bi, t0:t1, h] * np.exp(cs[-1] - cs)
                state = (np.exp(cs[-1]) * state
                         + (x[bi, t0:t1, h] * w[:, None]).T @ b[bi, t0:t1, g])
            for k, (t0, t1) in reversed(list(enumerate(spans))):
                ds[bi, k, h] = dstate
                cs = np.cumsum(dt[bi, t0:t1, h] * a[h])
                dstate = (np.exp(cs[-1]) * dstate
                          + (dy[bi, t0:t1, h] * np.exp(cs)[:, None]).T @ c[bi, t0:t1, g])
            d_init[bi, h] = dstate
    dx, d_dt = np.zeros_like(x), np.zeros_like(dt)
    db, dc, d_a = np.zeros_like(b), np.zeros_like(c), np.zeros_like(a)
    for bi in range(B):
        for k, (t0, t1) in enumerate(spans):
            for g in range(G):
                bb, cc = b[bi, t0:t1, g], c[bi, t0:t1, g]
                dbg, dcg = np.zeros_like(bb), np.zeros_like(cc)
                for h in range(g * rep, (g + 1) * rep):
                    xx, yy, d = x[bi, t0:t1, h], dy[bi, t0:t1, h], dt[bi, t0:t1, h]
                    S0, dS = s0[bi, k, h], ds[bi, k, h]
                    cs = np.cumsum(d * a[h])
                    w = np.tril(np.exp(np.tril(cs[:, None] - cs[None, :])))
                    tail, e = np.exp(cs[-1] - cs), np.exp(cs)
                    m = (cc @ bb.T) * w
                    q = (yy @ xx.T) * d[None, :] * w
                    gm = (cc @ bb.T) * q
                    v = bb @ dS.T
                    u = yy @ S0
                    dxdt = m.T @ yy + tail[:, None] * v
                    dcg += q @ bb + e[:, None] * u
                    dbg += q.T @ cc + (tail * d)[:, None] * (xx @ dS)
                    t = tail * d * (xx * v).sum(1)
                    dcs = gm.sum(1) - gm.sum(0) + e * (cc * u).sum(1) - t
                    dcs[-1] += np.exp(cs[-1]) * (dS * S0).sum() + t.sum()
                    dda = np.cumsum(dcs[::-1])[::-1]
                    dx[bi, t0:t1, h] = d[:, None] * dxdt
                    d_dt[bi, t0:t1, h] = a[h] * dda + (xx * dxdt).sum(1)
                    d_a[h] += (dda * d).sum()
                db[bi, t0:t1, g], dc[bi, t0:t1, g] = dbg, dcg
    return dx, d_dt, d_a, db, dc, d_init


def test_two_phase_decomposition_matches_jax_vjp():
    """The algebra of the bf16 kernels (block-start states S0_k, block-end
    cotangents dS_k, the last token's d(cs) terms, dB and dC summed over a
    group's heads) against the reference's autodiff: a ragged S 40 (a
    32-token block and an 8-token one), G 2 of two heads each, an initial
    state and a final-state cotangent."""
    x, dt, a, b, c, init, dy, d_final = _inputs(2, 40, 4, 2, 8, 16, seed=31)
    _, vjp = jax.vjp(lambda *v: jax_ssd_chunked(*v[:5], 16, init_state=v[5]),
                     *(jnp.asarray(v) for v in (x, dt, a, b, c, init)))
    want = vjp((jnp.asarray(dy), jnp.asarray(d_final)))
    got = _two_phase_bwd(x, dt, a, b, c, dy, init, d_final)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        _close(g, w, name)


def test_bf16_inputs_give_grads_in_their_dtype():
    """dx, db, dc come back in x's dtype (the fp32 sums rounded once),
    d_dt, d_a and d_init in fp32."""
    x, dt, a, b, c, init, dy, d_final = _inputs(1, 32, 4, 1, 8, 16, seed=5)
    xb, bb, cb, dyb = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, b, c, dy))
    args = (torch.from_numpy(dt), torch.from_numpy(a))
    g16 = ssd_scan_bwd_ref(xb, *args, bb, cb, dyb, chunk=32,
                           init_state=torch.from_numpy(init),
                           d_final=torch.from_numpy(d_final))
    g32 = ssd_scan_bwd_ref(xb.float(), *args, bb.float(), cb.float(), dyb.float(),
                           chunk=32, init_state=torch.from_numpy(init),
                           d_final=torch.from_numpy(d_final))
    for name, lo, hi in zip(NAMES, g16, g32):
        want = hi.to(torch.bfloat16) if name in ("dx", "db", "dc") else hi
        assert lo.dtype == want.dtype and torch.equal(lo, want), name


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_function_on_cpu_runs_the_plain_versions(with_state):
    """``SSDScan`` on CPU tensors: the forward is ``ssd_scan_ref``, the
    backward ``ssd_scan_bwd_ref`` (the gradients of autograd through the
    plain forward), no launch counted; a None cotangent for the final
    state (only y used) means zeros."""
    x, dt, a, b, c, init, dy, _ = _inputs(1, 40, 4, 2, 8, 16, seed=9)
    init = torch.from_numpy(init) if with_state else None
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, dt, a, b, c)]
    if with_state:
        init.requires_grad_()
    before = (ssd_scan.launches, ssd_scan_bwd.launches)
    y, final = SSDScan.apply(*leaves, init, 32)
    want_y, want_final = ssd_scan_ref(*leaves, chunk=32, init_state=init)
    assert torch.equal(y, want_y) and torch.equal(final, want_final)
    inputs = leaves + ([init] if with_state else [])
    got = torch.autograd.grad(y, inputs, torch.from_numpy(dy))
    want = ssd_scan_bwd_ref(*(t.detach() for t in leaves), torch.from_numpy(dy),
                            chunk=32, init_state=None if init is None else init.detach())
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == before


def test_ssd_scan_function_gradients_reach_projection_views():
    """The model hands ``SSDScan`` x, b and c as views into one conv
    output: the gradients of the three views land in that tensor's
    gradient, where autograd through ``ssd_scan_ref`` puts them."""
    rng = np.random.default_rng(12)
    B, S, H, P, G, N = 2, 32, 4, 8, 1, 16
    xbc0 = torch.from_numpy(rng.normal(0, 1, (B, S, H * P + 2 * G * N)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (B, S, H)).astype(np.float32))
    a = -torch.from_numpy(rng.uniform(0.5, 8, (H,)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(0, 1, (B, S, H, P)).astype(np.float32))
    grads = []
    for fn in (lambda *v: SSDScan.apply(*v, None, 32)[0],
               lambda *v: ssd_scan_ref(*v, chunk=32)[0]):
        xbc = xbc0.clone().requires_grad_()
        x = xbc[..., :H * P].reshape(B, S, H, P)
        b = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
        c = xbc[..., H * P + G * N:].reshape(B, S, G, N)
        grads.append(torch.autograd.grad(fn(x, dt, a, b, c), xbc, dy)[0])
    _close(grads[0].numpy(), grads[1].numpy(), "d(xbc)")


def _bwd_args(B=1, S=9, H=4, G=2, P=8, N=16):
    x, dt, a, b, c, init, dy, d_final = _inputs(B, S, H, G, P, N, seed=7)
    return {k: torch.from_numpy(v) for k, v in
            dict(x=x, dt=dt, a=a, b=b, c=c, dy=dy, init_state=init,
                 d_final=d_final).items()}


@pytest.mark.parametrize("bad,match", [
    (lambda v: v.update(dy=v["dy"][:, :-1]), "dy must be"),
    (lambda v: v.update(dy=v["dy"].to(torch.bfloat16)), "dy must be"),
    (lambda v: v.update(d_final=v["d_final"][..., :8]), "d_final must be"),
    (lambda v: v.update(d_final=v["d_final"].double()), "d_final must be"),
    (lambda v: v.update(x=v["x"].double()), "float32 or all bfloat16"),
    (lambda v: v.update(a=v["a"][:2]), r"dt must be \(B, S, H\)"),
    (lambda v: v.update(d_final=v["d_final"].transpose(2, 3).contiguous().transpose(2, 3)),
     "d_final must be"),
])
def test_bwd_wrapper_checks_refuse_what_the_kernel_does_not_take(bad, match):
    v = _bwd_args()
    ssd_ops._check_bwd(**v)
    bad(v)
    with pytest.raises((TypeError, ValueError), match=match):
        ssd_ops._check_bwd(**v)


def test_bwd_wrapper_checks_take_bf16_tiles_the_forward_refuses():
    """The bf16 backward runs on the tensor cores under the forward's tile
    rules: P 8 / N 24 are refused in bf16, as by the forward, and taken in
    fp32, whose FMA kernels read every element by itself; the forward's
    16-multiples are taken in bf16."""
    v = _bwd_args(P=8, N=24)
    ssd_ops._check_bwd(**v)
    for k in ("x", "b", "c", "dy"):
        v[k] = v[k].to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        ssd_ops._check_bwd(**v)
    with pytest.raises(ValueError, match="multiples of 16"):
        ssd_ops._check(v["x"], v["dt"], v["a"], v["b"], v["c"], v["init_state"])
    v = _bwd_args(P=16, N=16)
    for k in ("x", "b", "c", "dy"):
        v[k] = v[k].to(torch.bfloat16)
    ssd_ops._check_bwd(**v)
