"""The port's SSM block and SSM stack (repro_torch.models.ssm and the
transformer's point-state pools) against the JAX package on reduced
mamba2-2.7b in fp32: the causal conv, the state-page slot resolution, the
decode recurrence and the paged ``ssm_sublayer`` in extend and decode
modes (inactive and null rows write nothing, page 0 stays zero); the
pool layout; the a_log / dt_bias initialisers; and paged prefill ->
extend -> decode logits and pools within 1e-5 of the reference's largest
magnitude. Inputs and weights are made with numpy / JAX and bridged."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import param as jprm
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch.configs import get_config, reduced
from repro_torch.models import jax_random
from repro_torch.models import param as tprm
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import params_from_numpy, tree_leaves

PT = 8    # page tokens


def _close(t, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(t), ref, rtol=rel,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def _cfgs():
    jcfg = jax_reduced(jax_get_config("mamba2-2.7b"), dtype="float32",
                       param_dtype="float32")
    cfg = reduced(get_config("mamba2-2.7b"), dtype="float32",
                  param_dtype="float32")
    return jcfg, cfg


@pytest.mark.parametrize("S,with_state", [(1, True), (2, True), (9, True),
                                          (9, False)])
def test_causal_conv_matches_jax(S, with_state):
    rng = np.random.default_rng(S)
    xbc = rng.normal(0, 1, (2, S, 24)).astype(np.float32)
    w = rng.normal(0, 1, (4, 24)).astype(np.float32)
    b = rng.normal(0, 1, (24,)).astype(np.float32)
    st = rng.normal(0, 1, (2, 3, 24)).astype(np.float32) if with_state else None
    jy, jst = jssm._causal_conv(*(None if a is None else jnp.asarray(a)
                                  for a in (xbc, w, b, st)))
    ty, tst = tssm._causal_conv(*(None if a is None else torch.from_numpy(a)
                                  for a in (xbc, w, b, st)))
    _close(ty.numpy(), jy)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


@pytest.mark.parametrize("q0", [0, 5, 8, 15, 16, 31, 32, [0, 8, 13, 40]])
def test_paged_state_slots_match_jax(q0):
    table = np.array([[3, 7, 2, 0], [1, 0, 4, 5], [0, 0, 0, 0],
                      [6, 8, 9, 10]], np.int32)
    want = jssm._paged_state_slots(jnp.asarray(table), jnp.asarray(q0), PT)
    got = tssm._paged_state_slots(torch.from_numpy(table), torch.tensor(q0), PT)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ssd_decode_matches_jax():
    rng = np.random.default_rng(2)
    B, H, P, G, N = 3, 4, 8, 2, 16
    args = (rng.normal(0, 1, (B, H, P)), rng.uniform(0.001, 0.1, (B, H)),
            -rng.uniform(0.5, 8, (H,)), rng.normal(0, 1, (B, G, N)),
            rng.normal(0, 1, (B, G, N)), rng.normal(0, 1, (B, H, P, N)))
    args = [a.astype(np.float32) for a in args]
    jy, js = jssm.ssd_decode(*(jnp.asarray(a) for a in args))
    ty, ts = tssm.ssd_decode(*(torch.from_numpy(a) for a in args))
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)


def _layer_setup(seed=0, n_pages=6):
    """One SSM layer's weights (JAX init, bridged) and random pools whose
    null page 0 is zero."""
    jcfg, cfg = _cfgs()
    tree = jax.tree.map(np.asarray, jprm.materialize(jssm.ssm_defs(jcfg),
                                                     jax.random.key(seed),
                                                     "float32"))
    rng = np.random.default_rng(seed)
    pools = {k: rng.normal(0, 0.5, np.asarray(v).shape).astype(np.float32)
             for k, v in jssm.ssm_paged_init(jcfg, n_pages, jnp.float32).items()}
    for v in pools.values():
        v[0] = 0
    return jcfg, cfg, tree, pools, rng


def _sublayer_both(jcfg, cfg, tree, pools, x, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jout, jc = jssm.ssm_sublayer(jcfg, jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(x),
                                 cache={k: jnp.asarray(v) for k, v in pools.items()},
                                 page_tokens=PT, **jkw)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    tout, tc = tssm.ssm_sublayer(cfg, params_from_numpy(tree, device="cpu"),
                                 torch.from_numpy(x), cache=tcache,
                                 page_tokens=PT, **tkw)
    assert tc["state_pages"] is tcache["state_pages"]   # written in place
    return jout, jc, tout, tc


@pytest.mark.parametrize("offset,S", [(0, 8), (8, 6), (10, 5), (16, 1)])
def test_paged_sublayer_extend_matches_jax(offset, S):
    jcfg, cfg, tree, pools, rng = _layer_setup(seed=offset)
    x = rng.normal(0, 1, (1, S, cfg.d_model)).astype(np.float32)
    table = np.array([[1, 2, 3, 0]], np.int32)
    positions = (offset + np.arange(S)).astype(np.int32)
    jout, jc, tout, tc = _sublayer_both(jcfg, cfg, tree, pools, x,
                                        mode="extend", positions=positions,
                                        page_table=table)
    _close(tout.numpy(), jout)
    for k in pools:
        _close(tc[k].numpy(), jc[k])
        assert not tc[k][0].any()
    written = 1 + offset // PT
    untouched = [p for p in range(6) if p != written]
    for k in pools:
        np.testing.assert_array_equal(tc[k].numpy()[untouched], pools[k][untouched])


def test_paged_sublayer_decode_matches_jax_with_inactive_and_null_rows():
    """Row 0 decodes at position 13 (reads and writes its open page 2);
    row 1 is inactive (real table, writes nothing); row 2 has an all-null
    table (would write page 0: dropped); row 3 opens page 5 at 16."""
    jcfg, cfg, tree, pools, rng = _layer_setup(seed=4)
    x = rng.normal(0, 1, (4, 1, cfg.d_model)).astype(np.float32)
    table = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [0, 0, 0, 0], [1, 2, 5, 0]],
                     np.int32)
    cur = np.array([13, 9, 4, 16], np.int32)
    act = np.array([True, False, True, True])
    jout, jc, tout, tc = _sublayer_both(jcfg, cfg, tree, pools, x,
                                        mode="decode", cur_pos=cur,
                                        decode_active=act, page_table=table,
                                        positions=cur[:, None])
    _close(tout.numpy(), jout)
    for k in pools:
        _close(tc[k].numpy(), jc[k])
        assert not tc[k][0].any()
        np.testing.assert_array_equal(tc[k].numpy()[[1, 3, 4]],
                                      pools[k][[1, 3, 4]])
        assert not np.array_equal(tc[k].numpy()[[2, 5]], pools[k][[2, 5]])


def test_sublayer_refuses_ring_path_and_missing_page_size():
    jcfg, cfg, tree, pools, rng = _layer_setup()
    p = params_from_numpy(tree, device="cpu")
    x = torch.zeros((1, 2, cfg.d_model))
    cache = {k: torch.from_numpy(v) for k, v in pools.items()}
    tbl = torch.tensor([[1, 0]], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="A.10"):
        tssm.ssm_sublayer(cfg, p, x, cache=None, mode="extend",
                          positions=torch.arange(2))
    with pytest.raises(ValueError, match="page_tokens"):
        tssm.ssm_sublayer(cfg, p, x, cache=cache, mode="extend",
                          positions=torch.arange(2), page_table=tbl)


def test_paged_pools_keep_the_reference_layout():
    jcfg, cfg = _cfgs()
    jc = jtfm.init_paged_caches(jcfg, 5, PT, jnp.float32)
    tc = ttfm.init_paged_caches(cfg, 5, PT, torch.float32, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert len(jflat) == len(tree_leaves(tc))
    for (path, j), t in zip(jflat, tree_leaves(tc)):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype) == f"torch.{j.dtype.name}" and not t.any(), path
    assert tc[0][0]["state_pages"].shape == (
        cfg.num_layers, 5, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)


@pytest.mark.parametrize("init,lo,hi", [("a_log", math.log(1.0), math.log(16.0)),
                                        ("dt_bias", None, None)])
def test_ssm_initialisers_draw_the_reference_ranges(init, lo, hi):
    d = tprm.ParamDef((4096,), ("ssm_heads",), init=init, dtype="float32")
    t = tprm.materialize(d, jax_random.key(0), torch.device("cpu"))
    assert t.dtype == torch.float32 and t.shape == (4096,)
    if init == "a_log":
        assert lo <= float(t.min()) and float(t.max()) < hi
        a = torch.exp(t)   # A ~ U[1, 16): mean 8.5
        assert abs(float(a.mean()) - 8.5) < 0.3
    else:
        dt = torch.nn.functional.softplus(t)   # dt ~ U[1e-3, 1e-1]
        assert 1e-3 - 1e-6 <= float(dt.min()) and float(dt.max()) <= 1e-1 + 1e-6
        assert abs(float(dt.mean()) - 0.0505) < 0.003


def _paged_run(tfm, cfg, params, caches, to, tbl1, tbl2, act):
    """prefill 8 tokens (page 0), extend 6 (page 1), one batched decode
    (row 1 inactive)."""
    toks, ext, last, cur = to
    out = []
    lg, caches = tfm.paged_prefill(cfg, params, {"tokens": toks}, caches, tbl1,
                                   page_tokens=PT)
    out.append(lg)
    lg, caches = tfm.paged_extend(cfg, params, caches, ext, 8, tbl1,
                                  page_tokens=PT)
    out.append(lg)
    lg, caches = tfm.paged_decode(cfg, params, caches, last, cur, tbl2,
                                  active=act, page_tokens=PT)
    out.append(lg)
    return out, caches


def test_paged_steps_match_jax():
    jcfg, cfg = _cfgs()
    tree = jax.tree.map(np.asarray, jtfm.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(12)
    toks = rng.integers(2, cfg.vocab_size, (1, 8)).astype(np.int32)
    ext = rng.integers(2, cfg.vocab_size, (1, 6)).astype(np.int32)
    last = rng.integers(2, cfg.vocab_size, (2, 1)).astype(np.int32)
    cur = np.array([14, 0], np.int32)
    tbl1 = np.array([[1, 2, 3, 0]], np.int32)
    tbl2 = np.array([[1, 2, 3, 0], [0, 0, 0, 0]], np.int32)
    act = np.array([True, False])
    n_pages = 6

    jout, jc = _paged_run(
        jtfm, jcfg, jax.tree.map(jnp.asarray, tree),
        jtfm.init_paged_caches(jcfg, n_pages, PT, jnp.float32),
        [jnp.asarray(a) for a in (toks, ext, last, cur)],
        jnp.asarray(tbl1), jnp.asarray(tbl2), jnp.asarray(act))
    tout, tc = _paged_run(
        ttfm, cfg, params_from_numpy(tree, device="cpu"),
        ttfm.init_paged_caches(cfg, n_pages, PT, torch.float32, device="cpu"),
        [torch.from_numpy(a) for a in (toks, ext, last, cur)],
        torch.from_numpy(tbl1), torch.from_numpy(tbl2), torch.from_numpy(act))

    for j, t in zip(jout, tout):
        _close(t.numpy(), j)
    assert np.array_equal(np.argmax(np.asarray(jout[-1]), -1)[:1],
                          torch.argmax(tout[-1], -1).numpy()[:1])
    for j, t in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        _close(t.numpy(), j)
    # pages 1 and 2 hold the boundary and running states; the inactive
    # row wrote nothing: pages 3-5 and the null page stay zero
    for t in tree_leaves(tc):
        assert t[:, 1].any() and t[:, 2].any()
        assert not t[:, 0].any() and not t[:, 3:].any()


@pytest.mark.parametrize("offset,S", [(0, 9), (6, 3), (15, 2)])
def test_point_chunk_crossing_a_page_raises(offset, S):
    _, cfg = _cfgs()
    params = ttfm.init_params(cfg, 0, device="cpu")
    caches = ttfm.init_paged_caches(cfg, 4, PT, torch.float32, device="cpu")
    toks = torch.full((1, S), 3, dtype=torch.int32)
    tbl = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    with pytest.raises(ValueError, match="crosses"):
        if offset == 0:
            ttfm.paged_prefill(cfg, params, {"tokens": toks}, caches, tbl,
                               page_tokens=PT)
        else:
            ttfm.paged_extend(cfg, params, caches, toks, offset, tbl,
                              page_tokens=PT)
