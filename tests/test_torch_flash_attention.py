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
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)


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
    # Dk != Dv: the kernels take (192, 128), MLA's training shape, and
    # name any other pair they are handed
    ops._check(torch.zeros(1, 8, 4, 192), torch.zeros(1, 8, 2, 192),
               torch.zeros(1, 8, 2, 128))
    with pytest.raises(NotImplementedError, match=r"\(64, 32\)"):
        ops._check(q, k, torch.zeros(1, 8, 2, 32))
    with pytest.raises(NotImplementedError, match=r"\(128, 192\)"):
        ops._check(torch.zeros(1, 8, 4, 128), torch.zeros(1, 8, 2, 128),
                   torch.zeros(1, 8, 2, 192))
    with pytest.raises(ValueError, match="differ"):
        ops._check(q, k, torch.zeros(1, 7, 2, 64))         # v's keys differ
    with pytest.raises(ValueError, match="head_dim"):
        ops._check(q[..., :48], k[..., :48], k[..., :48])
    with pytest.raises(TypeError):
        ops._check(q.bfloat16(), k, k)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(q.transpose(1, 2), k, k)
    # meta tensors (the dry run) get the kernel's output shapes and dtypes
    out, m, l = ops.flash_attention_fwd(q.to("meta"), k.to("meta"),
                                        k.to("meta"), scale=1.0)
    assert out.is_meta and (out.shape, m.shape, l.shape) == (
        q.shape, (1, 4, 8), (1, 4, 8)) and m.dtype == l.dtype == torch.float32
    ops._check(q, k, k)                                    # accepted as is


# -- the bf16 dK/dV kernel's plan of work units (ops.dkdv_plan) ------------

PLAN_CASES = [  # Sq, Skv, G, window, unit_rows
    (2048, 2048, 8, None, ops.DKDV_UNIT_ROWS),   # gemma-2b training
    (130, 130, 4, None, 128), (130, 130, 4, 40, 96), (17, 17, 8, None, 64),
    (100, 160, 2, None, 64), (160, 100, 3, 7, None), (200, 200, 1, None, 4096),
]


@pytest.mark.parametrize("Sq,Skv,G,window,unit_rows", PLAN_CASES)
def test_dkdv_plan_covers_each_visible_pair_once(Sq, Skv, G, window, unit_rows):
    """Every (row, key tile) pair with a key the row sees lies in exactly one
    unit, no unit holds a row that sees none of its keys, and every key tile
    has a unit (an empty one writes zeros)."""
    units = ops.dkdv_plan(Sq, Skv, G, window, unit_rows)
    keys = ops.DKDV_KEYS
    n_tiles = -(-Skv // keys)
    count = np.zeros((Sq * G, n_tiles), dtype=np.int64)
    for j, r0, r1, _ in units:
        count[r0:r1, j] += 1
    t = np.arange(Sq * G)[:, None] // G
    k0 = np.arange(n_tiles)[None, :] * keys
    k1 = np.minimum(k0 + keys, Skv)
    sees = k0 <= t                                   # the tile's first key is visible
    if window is not None:
        sees &= (k1 - 1) > t - window                # its last key is in the window
    np.testing.assert_array_equal(count, sees.astype(np.int64))
    assert sorted({u[0] for u in units}) == list(range(n_tiles))
    lengths = [r1 - r0 for _, r0, r1, _ in units]
    assert lengths == sorted(lengths, reverse=True)  # longest first


@pytest.mark.parametrize("Sq,Skv,G,window,unit_rows", PLAN_CASES)
def test_dkdv_plan_cuts_at_fixed_row_boundaries(Sq, Skv, G, window, unit_rows):
    """Cuts fall on multiples of unit_rows, a key tile's units do not depend
    on the other tiles (the same tile of a longer key axis is cut the same),
    and cut tiles own consecutive slots in row order."""
    units = ops.dkdv_plan(Sq, Skv, G, window, unit_rows)
    longer = ops.dkdv_plan(Sq, Skv + 3 * ops.DKDV_KEYS, G, window, unit_rows)
    by_tile = {}
    for j, r0, r1, slot in units:
        by_tile.setdefault(j, []).append((r0, r1, slot))
    slots = []
    for j, ranges in sorted(by_tile.items()):
        ranges.sort()
        for (_, a1, _), (b0, _, _) in zip(ranges, ranges[1:]):
            assert a1 == b0 and unit_rows and b0 % unit_rows == 0
        if (j + 1) * ops.DKDV_KEYS <= Skv:               # a whole tile
            assert sorted((r0, r1) for jj, r0, r1, _ in longer if jj == j) == \
                [(r0, r1) for r0, r1, _ in ranges]
        if len(ranges) == 1:
            assert ranges[0][2] == -1
        else:
            slots += [s for _, _, s in ranges]
    assert slots == list(range(len(slots)))


def _unit_partials(q, k, v, m, l, do, delta, unit, *, scale, cap, window):
    """dK and dV of one unit's rows and key tile, as flash_bwd_ref computes
    them: (B, keys, Hkv, D) each, fp32."""
    j, r0, r1, _ = unit
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    k0, k1 = j * ops.DKDV_KEYS, min(Skv, (j + 1) * ops.DKDV_KEYS)
    rows = torch.arange(r0, r1)
    t, g = rows // G, rows % G
    qr, dr = (x.reshape(B, S, Hkv, G, D).permute(1, 3, 0, 2, 4)[t, g].transpose(0, 1)
              for x in (q, do))                          # (B, R, Hkv, D)
    stat = [x.reshape(B, Hkv, G, S)[:, :, g, t][..., None] for x in (m, l, delta)]
    kc, vc = k[:, k0:k1], v[:, k0:k1]
    s = torch.einsum("brhd,bkhd->bhrk", qr, kc) * scale
    th = None
    if cap is not None:
        th = torch.tanh(s / cap)
        s = th * cap
    kpos = torch.arange(k0, k1)
    mask = kpos[None, :] <= t[:, None]
    if window is not None:
        mask &= kpos[None, :] > t[:, None] - window
    p = torch.exp(torch.where(mask, s, -2.0e38) - stat[0]) / stat[1] * mask
    ds = p * (torch.einsum("brhd,bkhd->bhrk", dr, vc) - stat[2])
    if th is not None:
        ds = ds * (1.0 - th * th)
    ds = ds * scale
    return (torch.einsum("bhrk,brhd->bkhd", ds, qr),
            torch.einsum("bhrk,brhd->bkhd", p, dr))


@pytest.mark.parametrize("Sq,G,Hkv,window,cap,unit_rows", [
    (130, 4, 1, None, None, 128), (130, 2, 2, 40, 30.0, 96), (96, 3, 1, None, None, 64),
])
def test_dkdv_plan_partials_sum_to_flash_bwd_ref(Sq, G, Hkv, window, cap, unit_rows):
    """Summing the units' fp32 partials of each key tile in slot order, as
    the kernel's second launch does, gives flash_bwd_ref's dK/dV."""
    B, D = 2, 16
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(11, B, Sq, G * Hkv, Hkv, D, n=4))
    kw = dict(scale=D ** -0.5, cap=cap, window=window)
    out, m, l = flash_fwd_ref(q, k, v, **kw)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    _, want_k, want_v = ops.flash_bwd_ref(q, k, v, m, l, do, delta, **kw)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    units = ops.dkdv_plan(Sq, Sq, G, window, unit_rows)
    assert any(u[3] >= 0 for u in units)             # some tile is cut
    for unit in sorted(units, key=lambda u: (u[0], u[3])):
        pk, pv = _unit_partials(q, k, v, m, l, do, delta, unit, **kw)
        k0 = unit[0] * ops.DKDV_KEYS
        dk[:, k0:k0 + pk.shape[1]] += pk
        dv[:, k0:k0 + pv.shape[1]] += pv
    for got, want in ((dk, want_k), (dv, want_v)):
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()
