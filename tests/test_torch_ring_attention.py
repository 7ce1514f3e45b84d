"""The port's ring-cache functions and ring serving steps against the JAX
package (``repro.models.attention``, ``repro.models.transformer``):

- ``init_cache``, ``fill_cache_from_prefill``, ``write_chunk_to_cache`` and
  ``append_to_cache`` (scalar and per-row positions, with and without an
  ``active`` mask) write the reference's k, v and positions bit for bit
  (the port's ring holds K and V fused, ``{"kv", "pos"}``: compared
  through ``split_kv``);
- ``decode_attention`` and ``extend_attention`` (the paged kernel's
  explicit-position mode) agree with the reference's einsums within 1e-5
  in fp32, on wrapped, windowed and softcapped rings;
- the ring ``prefill -> extend -> decode`` logits and rings of reduced
  gemma2-27b (4096/global windows alternating, reduced to 64: the extend
  wraps the local rings; softcaps 50/30, post-norms) and deepseek-7b agree
  within 1e-5 of the reference's largest magnitude (wq and wk conditioned,
  as ``test_torch_frontends`` conditions them), an inactive decode row
  leaving its rings untouched;
- the paged ``prefill -> extend -> decode`` of the three configs
  registered last (deepseek-7b, gemma2-27b, llama2-70b) agree with the
  reference's logits and pools within 1e-5 (``test_torch_model``'s run,
  wq and wk conditioned);
- ``init_caches`` keeps the reference's stacked-repeats layout and ring
  lengths, and refuses MLA, SSM and hybrid units (ROADMAP A.6);
- ROADMAP §C.7: a chunk that wraps a windowed ring overwrites keys its own
  early queries' windows cover, in the reference and so in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.paged_attention import interleave_kv, split_kv
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import params_from_numpy, tree_leaves
from test_torch_frontends import _conditioned
from test_torch_model import _paged_run
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)


def _jax_layout(caches, r=None):
    """A port ring tree in the JAX package's layout: each ``{"kv", "pos"}``
    as ``{"k", "v", "pos"}``, an MLA ``{"ckr", "pos"}`` as ``{"c", "kr",
    "pos"}`` (``r`` the latent rank); SSM rings are laid out alike."""
    if isinstance(caches, dict):
        if "kv" in caches:
            k, v = split_kv(caches["kv"])
            return {"k": k, "v": v, "pos": caches["pos"]}
        if "ckr" in caches:
            ckr = caches["ckr"][..., 0, :]
            return {"c": ckr[..., :r], "kr": ckr[..., r:], "pos": caches["pos"]}
        if "attn" in caches:
            return {"attn": _jax_layout(caches["attn"]), "ssm": caches["ssm"]}
        return caches
    return tuple(_jax_layout(c, r) for c in caches)


def _assert_cache_equal(tcache, jcache):
    tcache = _jax_layout(tcache)
    for key in ("k", "v", "pos"):
        assert np.array_equal(tcache[key].numpy(), np.asarray(jcache[key])), key


def test_ring_cache_writes_bit_equal_jax():
    jcfg = jax_reduced(jax_get_config("qwen3-8b"), dtype="float32", param_dtype="float32")
    cfg = reduced(get_config("qwen3-8b"), dtype="float32", param_dtype="float32")
    B, C, Hkv, D = 3, 16, cfg.n_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(2)

    def kv(S):
        return [rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32) for _ in range(2)]

    jc = jattn.init_cache(jcfg, B, C, jnp.float32)
    tc = tattn.init_cache(cfg, B, C, torch.float32)
    _assert_cache_equal(tc, jc)
    for S in (11, 23):                    # 23 > C: keeps the last 16 tokens
        k, v = kv(S)
        jc = jattn.fill_cache_from_prefill(jattn.init_cache(jcfg, B, C, jnp.float32),
                                           jnp.asarray(k), jnp.asarray(v))
        tc = tattn.fill_cache_from_prefill(tattn.init_cache(cfg, B, C, torch.float32),
                                           torch.from_numpy(k), torch.from_numpy(v))
        _assert_cache_equal(tc, jc)
    k, v = kv(9)                          # positions 23..31 wrap the ring
    positions = np.arange(23, 32, dtype=np.int32)
    jc = jattn.write_chunk_to_cache(jc, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(positions))
    ret = tattn.write_chunk_to_cache(tc, torch.from_numpy(k), torch.from_numpy(v),
                                     torch.from_numpy(positions))
    assert ret is tc                      # written in place
    _assert_cache_equal(tc, jc)
    act = np.array([True, False, True])
    for pos, active in ((np.int32(32), None), (np.array([33, 40, 35], np.int32), None),
                        (np.array([34, 41, 36], np.int32), act),
                        (np.int32(37), act)):
        k1, v1 = (a[:, :1] for a in kv(1))
        jc = jattn.append_to_cache(jc, jnp.asarray(k1), jnp.asarray(v1), jnp.asarray(pos),
                                   active=None if active is None else jnp.asarray(active))
        tattn.append_to_cache(tc, torch.from_numpy(k1), torch.from_numpy(v1),
                              torch.from_numpy(np.asarray(pos)),
                              active=None if active is None else torch.from_numpy(active))
        _assert_cache_equal(tc, jc)


@pytest.mark.parametrize("cap,window", [(None, None), (50.0, 24)])
def test_ring_attention_matches_jax(cap, window):
    """Decode and extend over a wrapped ring with empty slots, GQA 2."""
    B, C, H, Hkv, D, S = 2, 48, 4, 2, 32, 7
    rng = np.random.default_rng(4)
    k, v = (rng.normal(0, 1, (B, C, Hkv, D)).astype(np.float32) for _ in range(2))
    p = np.arange(61 - C, 61)
    pos = np.full((B, C), -1, np.int32)
    pos[:, p % C] = p
    pos[1, rng.random(C) < 0.3] = -1
    kw = dict(scale=D ** -0.5, cap=cap, window=window)
    qd = rng.normal(0, 1, (B, 1, H, D)).astype(np.float32)
    cur = np.array([60, 55], np.int32)
    want = jattn.decode_attention(*(jnp.asarray(a) for a in (qd, k, v, pos, cur)), **kw)
    ring = interleave_kv(torch.from_numpy(k), torch.from_numpy(v))
    got = tattn.decode_attention(torch.from_numpy(qd), ring, torch.from_numpy(pos),
                                 torch.from_numpy(cur), page_size=16, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    qe = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    qpos = np.arange(54, 61, dtype=np.int32)
    want = jattn.extend_attention(*(jnp.asarray(a) for a in (qe, k, v, pos, qpos)), **kw)
    got = tattn.extend_attention(torch.from_numpy(qe), ring, torch.from_numpy(pos),
                                 torch.from_numpy(qpos), page_size=16, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _ring_run(tfm, cfg, params, to, page_tokens=None):
    """prefill 2 x 40 tokens into rings of 96 (windowed: 64), extend 30 —
    positions 40..69 wrap the 64-slot rings — then one decode round with
    row 1 inactive."""
    toks, ext, last, cur, act = to
    kw = {} if page_tokens is None else {"page_tokens": page_tokens}
    out = []
    lg, caches = tfm.prefill(cfg, params, {"tokens": toks}, max_cache_len=96)
    out.append(lg)
    lg, caches = tfm.extend(cfg, params, caches, ext, 40, **kw)
    out.append(lg)
    before = [np.array(a[:, 1]) for a in (jax.tree.leaves(caches) if tfm is jtfm
                                          else tree_leaves(caches))]
    lg, caches = tfm.decode(cfg, params, caches, last, cur, active=act, **kw)
    out.append(lg)
    return out, caches, before


@pytest.mark.parametrize("arch", ["gemma2-27b", "deepseek-7b"])
def test_ring_steps_match_jax(arch):
    """At the reference's initialisation the reduced models' fp32 results
    move by more than 1e-5 under a one-ulp change of the weights (ROADMAP
    §C notes), so wq and wk are rescaled to std d_model^-1/2 on both
    sides."""
    jcfg = jax_reduced(jax_get_config(arch), dtype="float32", param_dtype="float32")
    cfg = reduced(get_config(arch), dtype="float32", param_dtype="float32")
    tree = _conditioned_tree(jcfg, cfg.d_model)
    rng = np.random.default_rng(11)
    toks = rng.integers(2, cfg.vocab_size, (2, 40)).astype(np.int32)
    ext = rng.integers(2, cfg.vocab_size, (2, 30)).astype(np.int32)
    last = rng.integers(2, cfg.vocab_size, (2, 1)).astype(np.int32)
    cur = np.array([70, 70], np.int32)
    act = np.array([True, False])
    to = (toks, ext, last, cur, act)
    jout, jc, _ = _ring_run(jtfm, jcfg, jax.tree.map(jnp.asarray, tree),
                            [jnp.asarray(a) for a in to])
    tout, tc, before = _ring_run(ttfm, cfg, params_from_numpy(tree, device="cpu"),
                                 [torch.from_numpy(a) for a in to], page_tokens=16)
    for j, t in zip(jout, tout):
        _close(t, j)
    jleaves, tleaves = jax.tree.leaves(jc), tree_leaves(_jax_layout(tc))
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        ref = np.asarray(j)
        assert tuple(t.shape) == ref.shape
        if ref.dtype == np.int32:
            assert np.array_equal(t.numpy(), ref)
        else:
            _close(t, j)
    # the inactive row's rings came back bit-identical
    for b, t in zip(before, tree_leaves(tc)):
        assert np.array_equal(b, t[:, 1].numpy())
    if arch == "gemma2-27b":   # local rings of 64 hold the newest 64 positions
        pos = [t for t in tleaves if t.dtype == torch.int32]
        assert sorted({t.shape[-1] for t in pos}) == [64, 96]
        local = next(t for t in pos if t.shape[-1] == 64)
        assert local[0, 0].min() == 70 - 64 + 1 and local[0, 0].max() == 70


def _conditioned_tree(jcfg, d_model):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: _conditioned(path, np.asarray(a), d_model),
        jtfm.init_params(jcfg, jax.random.key(0)))


def _close(got, want):
    ref = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma2-27b", "llama2-70b"])
def test_new_configs_paged_steps_match_jax(arch):
    """Prefill 13 tokens, extend 6, one batched decode with row 1 inactive
    (page 8): logits and pools within 1e-5, the inactive row's pages and
    the null page untouched."""
    jcfg = jax_reduced(jax_get_config(arch), dtype="float32", param_dtype="float32")
    cfg = reduced(get_config(arch), dtype="float32", param_dtype="float32")
    tree = _conditioned_tree(jcfg, cfg.d_model)
    rng = np.random.default_rng(11)
    to = (rng.integers(2, cfg.vocab_size, (1, 13)).astype(np.int32),
          rng.integers(2, cfg.vocab_size, (1, 6)).astype(np.int32),
          rng.integers(2, cfg.vocab_size, (2, 1)).astype(np.int32),
          np.array([19, 0], np.int32))
    tbl1 = np.array([[1, 2, 3, 0]], np.int32)
    tbl2 = np.array([[1, 2, 3, 0], [0, 0, 0, 0]], np.int32)
    act = np.array([True, False])
    jout, jc = _paged_run(jtfm, jcfg, jax.tree.map(jnp.asarray, tree),
                          jtfm.init_paged_caches(jcfg, 6, 8, jnp.float32),
                          [jnp.asarray(a) for a in to], jnp.asarray(tbl1),
                          jnp.asarray(tbl2), jnp.asarray(act))
    tout, tc = _paged_run(ttfm, cfg, params_from_numpy(tree, device="cpu"),
                          ttfm.init_paged_caches(cfg, 6, 8, torch.float32, device="cpu"),
                          [torch.from_numpy(a) for a in to], torch.from_numpy(tbl1),
                          torch.from_numpy(tbl2), torch.from_numpy(act))
    for j, t in zip(jout, tout):
        _close(t, j)
    for j, t in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        _close(t, j)
    for t in tree_leaves(tc):
        assert not t[:, 0].any() and not t[:, 4:].any()


def test_init_caches_layout_and_refusals():
    """Every family's rings (MLA, SSM and hybrid ones refused until ROADMAP
    A.6 closed) in the JAX package's layout: leaf for leaf, shapes, dtypes
    and values."""
    for arch in ("gemma2-27b", "qwen3-8b", "deepseek-v2-lite-16b", "mamba2-2.7b",
                 "hymba-1.5b"):
        jcfg = jax_reduced(jax_get_config(arch))
        cfg = reduced(get_config(arch))
        want = jax.tree_util.tree_flatten_with_path(
            jtfm.init_caches(jcfg, 3, 96, jnp.bfloat16))[0]
        got = tree_leaves(_jax_layout(ttfm.init_caches(cfg, 3, 96, torch.bfloat16,
                                                       device="cpu"), cfg.kv_lora_rank))
        assert len(got) == len(want)
        for (path, a), t in zip(want, got):
            a = np.asarray(a)
            assert tuple(t.shape) == a.shape, path
            assert str(t.dtype) == f"torch.{a.dtype.name}", path
            assert np.array_equal(t.float().numpy(), a.astype(np.float32)), path


def test_windowed_ring_extend_loses_in_window_keys():
    """ROADMAP §C.7, a fault of the reference that the port keeps. Reduced
    gemma2-27b's local ring has its window's 64 slots and a chunk is
    written before it attends: positions 0..59 fill the ring, the chunk
    60..89 overwrites positions 0..25, which queries 60..88 still cover
    under the window. Exact attention (a 96-slot ring that keeps every key)
    differs from the ring's for those queries and agrees for query 89; the
    port's ring gives the JAX package's ring result."""
    jcfg = jax_reduced(jax_get_config("gemma2-27b"), dtype="float32", param_dtype="float32")
    cfg = reduced(get_config("gemma2-27b"), dtype="float32", param_dtype="float32")
    W, Hkv, D = cfg.window_pattern[0], cfg.n_kv_heads, cfg.resolved_head_dim
    assert W == 64 and tattn.cache_len_for(W, 96) == W
    rng = np.random.default_rng(7)
    k, v = (rng.normal(0, 1, (1, 90, Hkv, D)).astype(np.float32) for _ in range(2))
    q = rng.normal(0, 1, (1, 30, cfg.n_heads, D)).astype(np.float32)
    qpos = np.arange(60, 90, dtype=np.int32)
    kw = dict(scale=D ** -0.5, cap=cfg.attn_softcap, window=W)

    def port(C):
        c = tattn.init_cache(cfg, 1, C, torch.float32)
        tattn.fill_cache_from_prefill(c, torch.from_numpy(k[:, :60]),
                                      torch.from_numpy(v[:, :60]))
        tattn.write_chunk_to_cache(c, torch.from_numpy(k[:, 60:]),
                                   torch.from_numpy(v[:, 60:]), torch.from_numpy(qpos))
        return tattn.extend_attention(torch.from_numpy(q), c["kv"], c["pos"],
                                      torch.from_numpy(qpos), page_size=16, **kw)[0].numpy()

    jc = jattn.fill_cache_from_prefill(jattn.init_cache(jcfg, 1, W, jnp.float32),
                                       jnp.asarray(k[:, :60]), jnp.asarray(v[:, :60]))
    jc = jattn.write_chunk_to_cache(jc, jnp.asarray(k[:, 60:]), jnp.asarray(v[:, 60:]),
                                    jnp.asarray(qpos))
    want = jattn.extend_attention(jnp.asarray(q), jc["k"], jc["v"], jc["pos"],
                                  jnp.asarray(qpos), **kw)
    ring, exact = port(W), port(96)
    np.testing.assert_allclose(ring, np.asarray(want)[0], atol=1e-5, rtol=1e-5)
    gap = np.abs(ring - exact).max(axis=(1, 2))
    assert (gap[:29] > 1e-4).all()            # queries 60..88 lost keys 0..25
    np.testing.assert_allclose(ring[29], exact[29], atol=1e-5, rtol=1e-5)
