"""MLA on ring caches: the port's ``mla_sublayer`` ring modes against the
JAX package on reduced deepseek-v2-lite-16b in fp32 (r 64, dr 16, 4 query
heads), and the latent kernel's single-plane read and position mode in
its plain version. Inputs are made with numpy and handed to both.

- ``prefill`` into a fresh ring, ``extend`` over a ring holding earlier,
  wrapped and empty slots, and ``decode`` with an inactive row: outputs
  within 1e-5 of the reference run absorbed (``mla_absorb=True``, built
  with ``dataclasses.replace``; its ring prefill is expanded whatever the
  flag) and within its own extend tolerance, 2e-4, of the expanded
  default; the ring leaves, ``ckr[..., :r]`` against ``c``, ``ckr[...,
  r:]`` against ``kr`` within 1e-5 and ``pos`` exactly, inactive rows
  untouched; a first chunk longer than the ring raises;
- the plain ragged paged attention reading one plane (``v_from_k``)
  equals the two-plane [c, kr] / [c, 0] read in lanes [0, r), bit for
  bit, at the reduced and the full latent width;
- at the full latent head (16 query heads on one KV head of D 576), the
  position mode with the slot-derived positions written out equals the
  slot-derived mode bit for bit, and the position mode matches JAX's
  Pallas kernel in interpret mode within its 3e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.paged_attention import ragged_paged_attention as jax_rpa
from repro.models import mla as jmla
from repro.models import param as jprm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.paged_attention import (ragged_paged_attention,
                                                 ragged_paged_attention_ref)
from repro_torch.models import mla as tmla
from repro_torch.models.param import params_from_numpy
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ARCH = "deepseek-v2-lite-16b"
C, PT = 32, 8        # ring slots, and the page the kernel reads it as


def _close(t, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(t), ref, rtol=rel,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config(ARCH), dtype="float32", param_dtype="float32")
    cfg = reduced(get_config(ARCH), dtype="float32", param_dtype="float32")
    tree = jax.tree.map(np.asarray, jprm.materialize(
        jmla.mla_defs(jcfg), jax.random.key(7), "float32"))
    return jcfg, cfg, tree


def _ring(cfg, B, filled, seed):
    """A ring of C slots per row holding positions ``range(*filled[b])``
    at slot p % C (a span longer than C wraps), a few slots emptied,
    random latents: (c (B, C, r), kr (B, C, dr), pos (B, C))."""
    rng = np.random.default_rng(seed)
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    pos = np.full((B, C), -1, np.int32)
    for b, (lo, hi) in enumerate(filled):
        p = np.arange(max(lo, hi - C), hi)
        pos[b, p % C] = p
    pos[rng.random((B, C)) < 0.1] = -1
    c = rng.normal(0, 1, (B, C, r)).astype(np.float32)
    kr = rng.normal(0, 1, (B, C, dr)).astype(np.float32)
    return c, kr, pos


def _both(setup, mode, x, ring, **kw):
    """The JAX sublayer (absorbed and the default) and the port's on the
    same ring: (port out, port ring, {flag: (jax out, jax ring)})."""
    jcfg, cfg, tree = setup
    c, kr, pos = ring
    jax_out = {}
    for absorb in (True, False):
        jc = {"c": jnp.asarray(c), "kr": jnp.asarray(kr), "pos": jnp.asarray(pos)}
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        out, new = jmla.mla_sublayer(dataclasses.replace(jcfg, mla_absorb=absorb),
                                     jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                                     cache=jc, mode=mode, **jkw)
        jax_out[absorb] = (np.asarray(out), jax.tree.map(np.asarray, new))
    tring = {"ckr": torch.from_numpy(np.concatenate([c, kr], -1)[:, :, None].copy()),
             "pos": torch.from_numpy(pos.copy())}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    out, new = tmla.mla_sublayer(cfg, params_from_numpy(tree, device="cpu"),
                                 torch.from_numpy(x), cache=tring, mode=mode,
                                 page_tokens=PT, **tkw)
    assert new is tring                   # written in place
    return out.numpy(), {k: v.numpy() for k, v in tring.items()}, jax_out


def _check(cfg, out, ring, jax_out, rel_absorbed):
    r = cfg.kv_lora_rank
    _close(out, jax_out[True][0], rel_absorbed)
    _close(out, jax_out[False][0], 2e-4)
    for jout, jring in jax_out.values():
        _close(ring["ckr"][:, :, 0, :r], jring["c"], 1e-5)
        _close(ring["ckr"][:, :, 0, r:], jring["kr"], 1e-5)
        np.testing.assert_array_equal(ring["pos"], jring["pos"])


@pytest.mark.parametrize("S,B", [(9, 1), (32, 2)])
def test_ring_prefill_matches_jax(setup, S, B):
    """A first chunk into a fresh ring (the JAX package's expanded flash
    path either way: 2e-4)."""
    jcfg, cfg, _ = setup
    rng = np.random.default_rng(S)
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    fresh = (np.zeros((B, C, cfg.kv_lora_rank), np.float32),
             np.zeros((B, C, cfg.qk_rope_dim), np.float32),
             np.full((B, C), -1, np.int32))
    out, ring, jax_out = _both(setup, "prefill", x, fresh,
                               positions=np.arange(S, dtype=np.int32))
    _check(cfg, out, ring, jax_out, 2e-4)
    assert (ring["pos"][:, :S] == np.arange(S)).all() and (ring["pos"][:, S:] == -1).all()


@pytest.mark.parametrize("offset,S,filled", [
    (20, 6, [(0, 20)]),                    # a plain continuation
    (40, 9, [(0, 40), (5, 40)]),           # the rings wrap; row 1 lost its head
    (16, 16, [(0, 16)]),                   # a page-aligned chunk of a page pair
])
def test_ring_extend_matches_jax(setup, offset, S, filled):
    jcfg, cfg, _ = setup
    B = len(filled)
    rng = np.random.default_rng(offset)
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    positions = (offset + np.arange(S)).astype(np.int32)
    out, ring, jax_out = _both(setup, "extend", x, _ring(cfg, B, filled, offset),
                               positions=positions)
    _check(cfg, out, ring, jax_out, 1e-5)
    assert (ring["pos"][:, positions % C] == positions).all()


def test_ring_decode_matches_jax_with_an_inactive_row(setup):
    jcfg, cfg, _ = setup
    filled = [(0, 13), (0, 30), (3, 45)]
    ring0 = _ring(cfg, 3, filled, 3)
    x = np.random.default_rng(3).normal(0, 1, (3, 1, cfg.d_model)).astype(np.float32)
    cur = np.array([13, 30, 45], np.int32)
    act = np.array([True, False, True])
    out, ring, jax_out = _both(setup, "decode", x, ring0, cur_pos=cur,
                               decode_active=act, positions=cur[:, None])
    _check(cfg, out[act], ring, {k: (o[act], rr) for k, (o, rr) in jax_out.items()}, 1e-5)
    c, kr, pos = ring0
    np.testing.assert_array_equal(ring["ckr"][1, :, 0], np.concatenate([c, kr], -1)[1])
    np.testing.assert_array_equal(ring["pos"][1], pos[1])
    assert ring["pos"][0, 13] == 13 and ring["pos"][2, 45 % C] == 45


def test_ring_refuses_what_it_cannot_hold(setup):
    jcfg, cfg, tree = setup
    p = params_from_numpy(tree, device="cpu")
    ring = tmla.mla_cache_init(cfg, 1, C, torch.float32)
    assert ring["ckr"].shape == (1, C, 1, 80) and (ring["pos"] == -1).all()
    x = torch.zeros(1, C + 1, cfg.d_model)
    with pytest.raises(ValueError, match="does not fit"):
        tmla.mla_sublayer(cfg, p, x, positions=torch.arange(C + 1), cache=ring,
                          mode="prefill", page_tokens=PT)
    with pytest.raises(ValueError, match="no page table"):
        tmla.mla_sublayer(cfg, p, x[:, :2], positions=torch.arange(2), cache=ring,
                          mode="extend", page_tokens=PT,
                          page_table=torch.zeros(1, 1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# The plain latent read: one plane, positions
# ---------------------------------------------------------------------------


def _latent_case(Hq, r, dr, q_lens, kv_lens, ps, seed=0):
    """A slot-derived paged batch at one latent head: (q, two-plane pages
    [c, kr] / [c, 0], one-plane pages [c, kr], table, cu, kv_lens) and the
    positions written out (q_pos, kv_pos; null page 0 stays -1)."""
    rng = np.random.default_rng(seed)
    W = max(-(-k // ps) for k in kv_lens) + 1
    P = 1 + len(kv_lens) * W
    c = rng.normal(0, 1, (P, ps, r)).astype(np.float32)
    kr = rng.normal(0, 1, (P, ps, dr)).astype(np.float32)
    two = np.stack([np.concatenate([c, kr], -1),
                    np.concatenate([c, np.zeros_like(kr)], -1)], axis=2)
    one = np.concatenate([c, kr], -1)[:, :, None]
    table = np.zeros((len(kv_lens), W), np.int32)
    kv_pos = np.full((P, ps), -1, np.int32)
    q_pos = []
    for s, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        n = -(-kl // ps)
        table[s, :n] = 1 + s * W + np.arange(n)
        for j in range(n):
            kv_pos[table[s, j]] = j * ps + np.arange(ps)
        q_pos += list(range(kl - ql, kl))
    q = rng.normal(0, 1, (sum(q_lens), Hq, r + dr)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    t = [torch.from_numpy(a) for a in (q, two, one, table, cu,
                                       np.asarray(kv_lens, np.int32))]
    return t, torch.tensor(q_pos, dtype=torch.int32), torch.from_numpy(kv_pos)


@pytest.mark.parametrize("Hq,r,dr", [(4, 64, 16), (16, 512, 64)])
@pytest.mark.parametrize("positions", [False, True])
def test_one_plane_equals_two_planes_in_latent_lanes(Hq, r, dr, positions):
    """V = K = [c, kr] against V' = [c, 0]: lanes [0, r) bit-equal (each
    output lane sums over its own value column), lanes [r, r + dr) carry
    P·kr where the two-plane read has 0; the wrapper routes CPU tensors to
    the same plain version."""
    (q, two, one, table, cu, kl), q_pos, kv_pos = _latent_case(
        Hq, r, dr, [3, 1, 9], [37, 12, 20], 8)
    kw = dict(scale=(r // 2 + dr) ** -0.5)
    if positions:
        kw.update(q_pos=q_pos, kv_pos_pages=kv_pos)
    o2 = ragged_paged_attention_ref(q, two, table, cu, kl, **kw)
    o1 = ragged_paged_attention_ref(q, one, table, cu, kl, v_from_k=True, **kw)
    assert torch.equal(o1[..., :r], o2[..., :r])
    assert not o2[..., r:].any() and o1[..., r:].abs().sum() > 0
    via = ragged_paged_attention(q, one, table, cu, kl, v_from_k=True, **kw)
    assert torch.equal(via, o1)
    with pytest.raises(ValueError, match="one plane"):
        ragged_paged_attention(q, two, table, cu, kl, v_from_k=True, **kw)


@pytest.mark.parametrize("q_lens,kv_lens,window", [
    ([1, 1, 1, 1], [41, 66, 80, 95], None),      # the serve traffic's decodes
    ([32], [96], None),                          # a chunk over three pages
    ([5, 1], [37, 70], 24),
])
def test_latent_slot_derived_positions_bit_equal_slot_mode(q_lens, kv_lens, window):
    """16 query heads on one KV head of D 576: the slot-derived positions
    written out (every slot below kv_lens, null page 0 at -1) give the
    slot-derived mode's output bit for bit, one plane and two."""
    (q, two, one, table, cu, kl), q_pos, kv_pos = _latent_case(
        16, 512, 64, q_lens, kv_lens, 16, seed=2)
    kw = dict(scale=192 ** -0.5, window=window)
    for pages, v_from_k in ((two, False), (one, True)):
        slot = ragged_paged_attention_ref(q, pages, table, cu, kl, v_from_k=v_from_k, **kw)
        pos = ragged_paged_attention_ref(q, pages, table, cu, kl, q_pos=q_pos,
                                         kv_pos_pages=kv_pos, v_from_k=v_from_k, **kw)
        assert torch.equal(slot, pos)


@pytest.mark.parametrize("S,wrap,empty", [(1, 0, 0.2), (1, 21, 0.0), (6, 10, 0.1)])
def test_latent_position_mode_matches_jax_pallas(S, wrap, empty):
    """Two latent rings of 48 slots (pages of 16) at D 576, wrapped or with
    empty slots, decode and a 6-row extend: the position mode (two planes,
    and one plane in lanes [0, r)) against JAX's Pallas kernel in interpret
    mode on the two-plane pages, within the reference's 3e-6."""
    rng = np.random.default_rng(S + wrap)
    B, Cr, ps, Hq, r, dr = 2, 48, 16, 16, 512, 64
    pos = np.full((B, Cr), -1, np.int32)
    q_pos = []
    for b in range(B):
        n = Cr + wrap + b if wrap else int(rng.integers(S, Cr + 1))
        p = np.arange(max(0, n - Cr), n)
        pos[b, p % Cr] = p
        q_pos += list(range(n - S, n))
    pos[rng.random((B, Cr)) < empty] = -1
    c = rng.normal(0, 1, (B, Cr, r)).astype(np.float32)
    kr = rng.normal(0, 1, (B, Cr, dr)).astype(np.float32)
    two = np.stack([np.concatenate([c, kr], -1),
                    np.concatenate([c, np.zeros_like(kr)], -1)], axis=2)
    two = two.reshape(B * Cr // ps, ps, 2, r + dr)
    one = np.ascontiguousarray(two[:, :, :1])
    table = np.arange(B * Cr // ps, dtype=np.int32).reshape(B, -1)
    q = rng.normal(0, 1, (B * S, Hq, r + dr)).astype(np.float32)
    cu = np.arange(0, (B + 1) * S, S, dtype=np.int32)
    kl = np.full((B,), Cr, np.int32)
    q_pos = np.asarray(q_pos, np.int32)
    kv_pos = pos.reshape(-1, ps)
    kw = dict(scale=192 ** -0.5)
    want = np.asarray(jax_rpa(*(jnp.asarray(a) for a in (q, two, table, cu, kl)),
                              q_pos=jnp.asarray(q_pos), kv_pos_pages=jnp.asarray(kv_pos),
                              max_q_len=S, backend="pallas", interpret=True, **kw))
    args = [torch.from_numpy(a) for a in (q, two, table, cu, kl)]
    pk = dict(q_pos=torch.from_numpy(q_pos), kv_pos_pages=torch.from_numpy(kv_pos), **kw)
    o2 = ragged_paged_attention(*args, **pk)
    np.testing.assert_allclose(o2.numpy(), want, atol=3e-6, rtol=3e-6)
    args[1] = torch.from_numpy(one)
    o1 = ragged_paged_attention(*args, v_from_k=True, **pk)
    np.testing.assert_allclose(o1[..., :r].numpy(), want[..., :r], atol=3e-6, rtol=3e-6)
