"""The explicit-position mode of the port's ragged paged attention, and the
ring-cache view onto it (``repro_torch.kernels.decode_attention``),
against the JAX package. Inputs are made with numpy and handed to both.

- The plain version with ``q_pos``/``kv_pos_pages`` against JAX's Pallas
  kernel in interpret mode and against its jnp reference, within the
  reference's 3e-6: rings with scattered and empty positions, wrapped
  windowed rings, softcap, GQA 2 and 4, decode and extend.
- Within the port, positions that equal the slot-derived ones give the
  slot-derived mode's output bit for bit.
- The decode view against JAX's ``decode_attention`` over the reference's
  own sweep (``tests/test_kernels.py``), fp32 and bf16, and its windowed
  case; the extend view against JAX's ``extend_attention``.
- The wrapper: positions both or neither, CPU tensors to the plain
  version, the latent head's position mode included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.paged_attention import ragged_paged_attention as jax_rpa
from repro.kernels.paged_attention import ragged_paged_attention_ref as jax_rpa_ref
from repro.models.attention import extend_attention as jax_extend
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  extend_attention,
                                                  ring_page_size, ring_pages)
from repro_torch.kernels.paged_attention import (interleave_kv,
                                                 ragged_paged_attention,
                                                 ragged_paged_attention_ref)
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=3e-6, rtol=3e-6)   # the JAX package's own kernel tolerance


def _ring_case(B, C, ps, Hq, Hkv, D, S, *, wrap=0, empty=0.0, seed=0):
    """B rings of C slots viewed as pages of ``ps``: sequence b holds
    positions [0, n_b) at slot pos % C (``wrap`` more positions than C
    wrap the ring), a fraction ``empty`` of slots is emptied (-1), and S
    queries per sequence sit at the S newest positions. Returns the ragged
    call's arguments (q, kv_pages, table, cu, kv_lens, q_pos, kv_pos)."""
    rng = np.random.default_rng(seed)
    pos = np.full((B, C), -1, np.int32)
    q_pos = []
    for b in range(B):
        n = C + wrap + b if wrap else int(rng.integers(S, C + 1))
        for p in range(max(0, n - C), n):
            pos[b, p % C] = p
        q_pos += list(range(n - S, n))
    if empty:
        pos[rng.random((B, C)) < empty] = -1
    k = rng.normal(0, 1, (B, C, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, C, Hkv, D)).astype(np.float32)
    kv_pages = np.stack([k, v], axis=3).reshape(B * C // ps, ps, 2 * Hkv, D)
    n_per = C // ps
    table = np.arange(B * n_per, dtype=np.int32).reshape(B, n_per)
    q = rng.normal(0, 1, (B * S, Hq, D)).astype(np.float32)
    cu = np.arange(0, (B + 1) * S, S, dtype=np.int32)
    kv_lens = np.full((B,), C, np.int32)
    return (q, kv_pages, table, cu, kv_lens, np.asarray(q_pos, np.int32),
            pos.reshape(B * n_per, ps))


def _port(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _jax(args):
    return [jnp.asarray(a) for a in args]


# B, C, ps, Hq, Hkv, D, S, wrap, empty
RING_CASES = {
    "decode_scattered_g2": (3, 48, 16, 4, 2, 16, 1, 0, 0.2),
    "decode_wrapped_g4": (2, 64, 16, 8, 2, 16, 1, 37, 0.0),
    "decode_empty_tail_g2": (2, 64, 32, 4, 2, 32, 1, 0, 0.0),
    "extend_wrapped_g2": (2, 64, 16, 4, 2, 16, 12, 21, 0.0),
    "extend_scattered_g4": (1, 96, 32, 8, 2, 16, 9, 0, 0.3),
}


@pytest.mark.parametrize("name", sorted(RING_CASES))
@pytest.mark.parametrize("cap,window", [(None, None), (50.0, None),
                                        (None, 24), (50.0, 24)])
def test_position_mode_matches_jax(name, cap, window):
    B, C, ps, Hq, Hkv, D, S, wrap, empty = RING_CASES[name]
    case = _ring_case(B, C, ps, Hq, Hkv, D, S, wrap=wrap, empty=empty)
    *args, q_pos, kv_pos = case
    kw = dict(scale=D ** -0.5, cap=cap, window=window)
    out = ragged_paged_attention_ref(*_port(args), q_pos=torch.from_numpy(q_pos),
                                     kv_pos_pages=torch.from_numpy(kv_pos), **kw)
    jq, jkv = jnp.asarray(q_pos), jnp.asarray(kv_pos)
    ref = jax_rpa_ref(*_jax(args), q_pos=jq, kv_pos_pages=jkv, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    pallas = jax_rpa(*_jax(args), q_pos=jq, kv_pos_pages=jkv, max_q_len=S,
                     backend="pallas", interpret=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)


def test_rows_with_no_visible_key_are_zero():
    """A query whose window holds no stored key (an empty ring, or every
    key behind the window) returns 0, as the JAX reference does."""
    q, kvp, tbl, cu, kl, q_pos, kv_pos = _ring_case(2, 32, 16, 4, 2, 16, 1)
    kv_pos = kv_pos.copy()
    kv_pos[:2] = -1                                     # sequence 0: empty ring
    q_pos = np.asarray([40, 1000], np.int32)            # sequence 1: all behind
    kw = dict(scale=0.25, window=8)
    out = ragged_paged_attention_ref(*_port((q, kvp, tbl, cu, kl)),
                                     q_pos=torch.from_numpy(q_pos),
                                     kv_pos_pages=torch.from_numpy(kv_pos), **kw)
    assert not out.any()
    ref = jax_rpa_ref(*_jax((q, kvp, tbl, cu, kl)), q_pos=jnp.asarray(q_pos),
                      kv_pos_pages=jnp.asarray(kv_pos), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _slot_case(q_lens, kv_lens, ps, Hq, Hkv, D, seed=7):
    """A slot-derived paged batch (page 0 the null page, sequences on
    their own page runs, a trailing null slot) and the same batch's
    positions written out: ``kv_pos`` holds each live slot's positions,
    -1 elsewhere; ``q_pos`` the slot-derived query positions."""
    rng = np.random.default_rng(seed)
    W = max(-(-k // ps) for k in kv_lens) + 1
    P = 1 + len(kv_lens) * W
    kv_pages = rng.normal(0, 1, (P, ps, 2 * Hkv, D)).astype(np.float32)
    table = np.zeros((len(kv_lens), W), np.int32)
    kv_pos = np.full((P, ps), -1, np.int32)
    q_pos = []
    for s, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        n = -(-kl // ps)
        table[s, :n] = 1 + s * W + np.arange(n)
        for j in range(n):
            kv_pos[table[s, j]] = j * ps + np.arange(ps)
        q_pos += list(range(kl - ql, kl))
    q = rng.normal(0, 1, (sum(q_lens), Hq, D)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    return ((q, kv_pages, table, cu, np.asarray(kv_lens, np.int32)),
            np.asarray(q_pos, np.int32), kv_pos)


@pytest.mark.parametrize("q_lens,kv_lens,ps,cap,window", [
    ([5, 1, 9], [37, 12, 9], 8, None, None),
    ([1, 1, 1, 1], [33, 7, 64, 17], 16, 50.0, None),
    ([16], [48], 16, 30.0, 20),
])
def test_slot_derived_positions_bit_equal_slot_mode(q_lens, kv_lens, ps, cap,
                                                    window):
    args, q_pos, kv_pos = _slot_case(q_lens, kv_lens, ps, Hq=8, Hkv=2, D=16)
    kw = dict(scale=0.25, cap=cap, window=window)
    slot = ragged_paged_attention_ref(*_port(args), **kw)
    pos = ragged_paged_attention_ref(*_port(args), q_pos=torch.from_numpy(q_pos),
                                     kv_pos_pages=torch.from_numpy(kv_pos), **kw)
    assert torch.equal(slot, pos)


def _decode_inputs(B, C, H, Hkv, D, rng):
    kc = rng.normal(0, 1, (B, C, Hkv, D)).astype(np.float32)
    vc = rng.normal(0, 1, (B, C, Hkv, D)).astype(np.float32)
    pos = np.where(rng.random((B, C)) < 0.8, rng.integers(0, 70, (B, C)),
                   -1).astype(np.int32)
    q = rng.normal(0, 1, (B, 1, H, D)).astype(np.float32)
    cur = rng.integers(40, 70, (B,)).astype(np.int32)
    return q, kc, vc, pos, cur


@pytest.mark.parametrize("B,C,H,Hkv,D,page", [
    (2, 96, 4, 2, 16, 32), (1, 128, 8, 1, 32, 64), (3, 64, 6, 3, 16, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_view_matches_jax(B, C, H, Hkv, D, page, dtype):
    """The reference's sweep and tolerance (tests/test_kernels.py)."""
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=3e-5, rtol=3e-5)
    q, kc, vc, pos, cur = _decode_inputs(B, C, H, Hkv, D, np.random.default_rng(42))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_decode(*(jnp.asarray(a, jd) for a in (q, kc, vc)), jnp.asarray(pos),
                      jnp.asarray(cur), scale=D ** -0.5, page_size=page)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, kc, vc))
    got = decode_attention(tq, interleave_kv(tk, tv), torch.from_numpy(pos),
                           torch.from_numpy(cur), scale=D ** -0.5, page_size=page)
    assert got.shape == (B, 1, H, D) and got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_decode_view_windowed_matches_jax():
    B, C, H, D = 1, 64, 2, 16
    rng = np.random.default_rng(42)
    kc, vc = (rng.normal(0, 1, (B, C, H, D)).astype(np.float32) for _ in range(2))
    pos = np.arange(C, dtype=np.int32)[None]
    q = rng.normal(0, 1, (B, 1, H, D)).astype(np.float32)
    cur = np.asarray([C - 1], np.int32)
    want = jax_decode(*(jnp.asarray(a) for a in (q, kc, vc, pos, cur)),
                      scale=D ** -0.5, window=16, page_size=16)
    tq, tk, tv, tpos, tcur = (torch.from_numpy(a) for a in (q, kc, vc, pos, cur))
    got = decode_attention(tq, interleave_kv(tk, tv), tpos, tcur,
                           scale=D ** -0.5, window=16, page_size=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("cap,window", [(None, None), (50.0, 24)])
def test_extend_view_matches_jax(cap, window):
    """S queries of every sequence against a wrapped ring that holds them."""
    B, C, H, Hkv, D, S = 2, 64, 8, 2, 16, 12
    rng = np.random.default_rng(3)
    kc, vc = (rng.normal(0, 1, (B, C, Hkv, D)).astype(np.float32) for _ in range(2))
    qpos = np.arange(70, 70 + S, dtype=np.int32)
    p = np.arange(70 + S - C, 70 + S)
    pos = np.broadcast_to(np.full((C,), -1, np.int32), (B, C)).copy()
    pos[:, p % C] = p
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    kw = dict(scale=D ** -0.5, cap=cap, window=window)
    want = jax_extend(*(jnp.asarray(a) for a in (q, kc, vc, pos, qpos)), **kw)
    tq, tk, tv, tpos, tqpos = (torch.from_numpy(a) for a in (q, kc, vc, pos, qpos))
    got = extend_attention(tq, interleave_kv(tk, tv), tpos, tqpos, page_size=16, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_ring_pages_and_page_size():
    """The view: sequence b's fused ring is pages [b*C/ps, (b+1)*C/ps) in
    ring order, K at fused head 2h and V at 2h+1, with no copy; a page size
    must be given and divide the ring."""
    B, C, Hkv, D, ps = 2, 48, 2, 4, 16
    k = torch.randn(B, C, Hkv, D)
    v = torch.randn(B, C, Hkv, D)
    ring = interleave_kv(k, v)
    pos = torch.arange(B * C, dtype=torch.int32).reshape(B, C)
    kv, kv_pos, table = ring_pages(ring, pos, ps)
    assert kv.shape == (B * C // ps, ps, 2 * Hkv, D)
    assert torch.equal(kv[4, 3, 2], k[1, 19, 1]) and torch.equal(kv[4, 3, 3], v[1, 19, 1])
    assert torch.equal(kv_pos[4, 3], pos[1, 19])
    assert kv.data_ptr() == ring.data_ptr() and kv_pos.data_ptr() == pos.data_ptr()
    assert table.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert ring_page_size(96, 32) == 32
    for C, page in ((96, 64), (100, None), (96, 0)):
        with pytest.raises(ValueError, match="does not divide"):
            ring_page_size(C, page)


def test_wrapper_positions_both_or_neither_and_cpu_routing():
    q, kvp, tbl, cu, kl, q_pos, kv_pos = _port(_ring_case(2, 32, 16, 4, 2, 16, 3))
    with pytest.raises(ValueError, match="together"):
        ragged_paged_attention(q, kvp, tbl, cu, kl, scale=0.25, q_pos=q_pos)
    with pytest.raises(TypeError, match="int32"):
        ragged_paged_attention(q, kvp, tbl, cu, kl, scale=0.25, q_pos=q_pos.long(),
                               kv_pos_pages=kv_pos)
    with pytest.raises(ValueError, match="kv_pos_pages must be"):
        ragged_paged_attention(q, kvp, tbl, cu, kl, scale=0.25, q_pos=q_pos,
                               kv_pos_pages=kv_pos[:1])
    before = ragged_paged_attention.launches
    out = ragged_paged_attention(q, kvp, tbl, cu, kl, scale=0.25, q_pos=q_pos,
                                 kv_pos_pages=kv_pos)
    ref = ragged_paged_attention_ref(q, kvp, tbl, cu, kl, scale=0.25, q_pos=q_pos,
                                     kv_pos_pages=kv_pos)
    assert torch.equal(out, ref)
    assert ragged_paged_attention.launches == before   # no kernel launched


def test_latent_kernel_refuses_positions():
    """bf16 at D 576 is the latent-head (MLA) kernel, which once refused
    positions (ROADMAP A.6): the same call now returns the plain version's
    output, two planes and one."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 576, generator=g).to(torch.bfloat16)
    kvp = torch.randn(1, 16, 2, 576, generator=g).to(torch.bfloat16)
    one = torch.zeros(1, dtype=torch.int32) + 9
    args = (torch.zeros(1, 1, dtype=torch.int32), torch.tensor([0, 1], dtype=torch.int32),
            torch.tensor([16], dtype=torch.int32))
    kw = dict(scale=0.1, q_pos=one, kv_pos_pages=torch.arange(16, dtype=torch.int32)[None])
    for pages, v_from_k in ((kvp, False), (kvp[:, :, :1].contiguous(), True)):
        out = ragged_paged_attention(q, pages, *args, v_from_k=v_from_k, **kw)
        ref = ragged_paged_attention_ref(q, pages, *args, v_from_k=v_from_k, **kw)
        assert out.dtype == torch.bfloat16 and torch.equal(out, ref)
