"""The port's hybrid stack (repro_torch.models.hybrid and the transformer's
meta tokens and union page pools) against the JAX package on reduced
hymba-1.5b in fp32, weights from the reference's ``init_params``: the paged
``hybrid_sublayer`` in extend and decode modes (inactive and null rows write
nothing), the meta-token embedding, the union pool layout, and paged
prefill -> extend -> decode logits. Then what the port decides where the
reference's paged path is at fault (ROADMAP §C.5): a first chunk whose
meta prefix spans pages writes its end state into the page of its last
position, and later chunks that cross a page still raise. The engine on
this stack: ``tests/test_torch_engine_hybrid.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import hybrid as jhyb
from repro.models import init_params as jax_init_params
from repro.models import param as jprm
from repro.models import transformer as jtfm
from repro_torch.configs import get_config, reduced
from repro_torch.models import hybrid as thyb
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import params_from_numpy, tree_leaves
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

PT = 8    # page tokens of the layer tests: the 8 meta tokens fill page 0


def _close(t, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(t), ref, rtol=rel,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    jfull = jax_get_config("hymba-1.5b")
    jcfg = jax_reduced(jfull, dtype="float32", param_dtype="float32")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
    full = get_config("hymba-1.5b")
    cfg = reduced(full, dtype="float32", param_dtype="float32")
    assert cfg.n_meta_tokens == 8 and cfg.layer_specs()[0].kind == "hybrid"
    return jfull, jcfg, tree, full, cfg, params_from_numpy(tree, device="cpu")


# ---------------------------------------------------------------------------
# The sublayer
# ---------------------------------------------------------------------------


def _layer_setup(setup, seed=0, n_pages=6):
    """One hybrid layer's weights (JAX init, bridged) and random union
    pools whose null page 0 is zero."""
    jcfg, cfg = setup[1], setup[4]
    tree = jax.tree.map(np.asarray, jprm.materialize(
        jhyb.hybrid_defs(jcfg), jax.random.key(seed), "float32"))
    rng = np.random.default_rng(seed)
    spec = jcfg.layer_specs()[1]
    pools = jax.tree.map(
        lambda a: rng.normal(0, 0.5, a.shape).astype(np.float32),
        jtfm._paged_unit_cache(jcfg, spec, n_pages, PT, jnp.float32))
    for leaf in jax.tree.leaves(pools):
        leaf[0] = 0
    return jcfg, cfg, tree, pools, rng


def _sublayer_both(jcfg, cfg, tree, pools, x, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jout, jc = jhyb.hybrid_sublayer(jcfg, jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(x),
                                    cache=jax.tree.map(jnp.asarray, pools),
                                    page_tokens=PT, **jkw)
    tcache = jax.tree.map(lambda a: torch.from_numpy(a.copy()), pools)
    tout, tc = thyb.hybrid_sublayer(cfg, params_from_numpy(tree, device="cpu"),
                                    torch.from_numpy(x), cache=tcache,
                                    page_tokens=PT, **tkw)
    # written in place
    assert tc["attn"]["kv_pages"] is tcache["attn"]["kv_pages"]
    assert tc["ssm"]["state_pages"] is tcache["ssm"]["state_pages"]
    return jout, jc, tout, tc


def _pairs(jc, tc):
    """(path, jax leaf, torch leaf) over the union pool."""
    flat = jax.tree_util.tree_flatten_with_path(jc)[0]
    return [(jax.tree_util.keystr(p), np.asarray(j), t.numpy())
            for (p, j), t in zip(flat, tree_leaves(tc))]


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("offset,S", [(0, 8), (8, 6), (10, 5), (16, 1)])
def test_hybrid_sublayer_extend_matches_jax(setup, offset, S, window):
    jcfg, cfg, tree, pools, rng = _layer_setup(setup, seed=offset)
    x = rng.normal(0, 1, (1, S, cfg.d_model)).astype(np.float32)
    table = np.array([[1, 2, 3, 0]], np.int32)
    positions = (offset + np.arange(S)).astype(np.int32)
    jout, jc, tout, tc = _sublayer_both(jcfg, cfg, tree, pools, x,
                                        mode="extend", positions=positions,
                                        window=window, page_table=table)
    _close(tout.numpy(), jout)
    for path, j, t in _pairs(jc, tc):
        _close(t, j)
        assert not t[0].any(), path


def test_hybrid_sublayer_decode_matches_jax_with_inactive_and_null_rows(setup):
    """Row 0 decodes at 13 (its open page 2); row 1 is inactive (real
    table, writes nothing); row 2 has an all-null table (writes dropped);
    row 3 opens page 5 at 16."""
    jcfg, cfg, tree, pools, rng = _layer_setup(setup, seed=4)
    x = rng.normal(0, 1, (4, 1, cfg.d_model)).astype(np.float32)
    table = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [0, 0, 0, 0], [1, 2, 5, 0]],
                     np.int32)
    cur = np.array([13, 9, 4, 16], np.int32)
    act = np.array([True, False, True, True])
    jout, jc, tout, tc = _sublayer_both(jcfg, cfg, tree, pools, x,
                                        mode="decode", cur_pos=cur,
                                        decode_active=act, page_table=table,
                                        positions=cur[:, None], window=64)
    _close(tout.numpy(), jout)
    for (path, j, t), before in zip(_pairs(jc, tc), jax.tree.leaves(pools)):
        # the reference's KV write lands row 2's K/V in null page 0 (never
        # read: every reader masks page 0); the port writes nothing there
        _close(t[1:], j[1:])
        assert not t[0].any(), path
        # rows 0 and 3 write pages 2 and 5; the inactive row's pages 3-4
        # and page 1 (read only) stay as they were
        np.testing.assert_array_equal(t[[1, 3, 4]], before[[1, 3, 4]])
        assert not np.array_equal(t[[2, 5]], before[[2, 5]]), path


def test_first_chunk_spanning_pages_writes_its_last_page(setup):
    """A 12-row first chunk over pages 0-1 (8 meta rows + 4 prompt rows):
    the output, KV rows and end state equal the reference's, but the end
    state lands in slot 1, where the next chunk (q0 = 12) reads it; the
    reference writes it to slot 0 (ROADMAP §C.5)."""
    jcfg, cfg, tree, pools, rng = _layer_setup(setup, seed=7)
    x = rng.normal(0, 1, (1, 12, cfg.d_model)).astype(np.float32)
    table = np.array([[1, 2, 3, 0]], np.int32)
    jout, jc, tout, tc = _sublayer_both(
        jcfg, cfg, tree, pools, x, mode="extend",
        positions=np.arange(12, dtype=np.int32), window=None, page_table=table)
    _close(tout.numpy(), jout)
    _close(tc["attn"]["kv_pages"].numpy(), jc["attn"]["kv_pages"])
    for k in ("conv_pages", "state_pages"):
        t, j = tc["ssm"][k].numpy(), np.asarray(jc["ssm"][k])
        _close(t[2], j[1])             # the port's slot 1 = JAX's slot 0
        np.testing.assert_array_equal(t[1], pools["ssm"][k][1])
        np.testing.assert_array_equal(t[3:], pools["ssm"][k][3:])


def test_hybrid_training_raises(setup):
    """Hybrid training runs (ROADMAP A.11; held against JAX in
    tests/test_torch_train_ssm.py); its train mode refuses a cache."""
    cfg, params = setup[4], setup[5]
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    loss, _ = ttfm.loss_and_metrics(cfg, params, {"tokens": tokens, "labels": tokens})
    assert torch.isfinite(loss)
    p = ttfm._layers(params["groups"][0][0], 1)[0]["mixer"]
    out, cache = thyb.hybrid_sublayer(cfg, p, torch.zeros((1, 4, cfg.d_model)),
                                      positions=torch.arange(4), window=None,
                                      mode="train")
    assert out.shape == (1, 4, cfg.d_model) and cache is None
    with pytest.raises(ValueError, match="takes no cache"):
        thyb.hybrid_sublayer(cfg, p, torch.zeros((1, 4, cfg.d_model)),
                             positions=torch.arange(4), window=None,
                             mode="train", cache={"attn": {}, "ssm": {}})


# ---------------------------------------------------------------------------
# The stack: meta tokens, union pools, paged steps
# ---------------------------------------------------------------------------


def test_meta_tokens_embed_in_front_bit_equal(setup):
    jcfg, tree, cfg, params = setup[1], setup[2], setup[4], setup[5]
    toks = np.random.default_rng(1).integers(2, cfg.vocab_size, (2, 5)).astype(np.int32)
    jx, jpre = jtfm._embed_inputs(jcfg, jax.tree.map(jnp.asarray, tree),
                                  {"tokens": jnp.asarray(toks)})
    tx, tpre = ttfm._embed_inputs(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert tpre == jpre == 8 and tx.shape == (2, 13, cfg.d_model)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tx[1, :8].numpy(), tree["meta_tokens"])


def test_union_pools_keep_the_reference_layout(setup):
    jcfg, cfg = setup[1], setup[4]
    jc = jtfm.init_paged_caches(jcfg, 5, PT, jnp.float32)
    tc = ttfm.init_paged_caches(cfg, 5, PT, torch.float32, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert len(jflat) == len(tree_leaves(tc)) == 3 * sum(
        len(g.unit) for g in cfg.scan_groups())
    for (path, j), t in zip(jflat, tree_leaves(tc)):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype) == f"torch.{j.dtype.name}" and not t.any(), path
    assert sorted(tc[0][0]) == ["attn", "ssm"]
    assert sorted(tc[0][0]["ssm"]) == ["conv_pages", "state_pages"]


def _paged_run(tfm, cfg, params, caches, to, tbl1, tbl2, act, pt):
    """prefill 8 prompt tokens behind the 8 meta tokens (page 0), extend 6
    (page 1), one batched decode (row 1 inactive)."""
    toks, ext, last, cur = to
    out = []
    lg, caches = tfm.paged_prefill(cfg, params, {"tokens": toks}, caches, tbl1,
                                   page_tokens=pt)
    out.append(lg)
    lg, caches = tfm.paged_extend(cfg, params, caches, ext, 16, tbl1,
                                  page_tokens=pt)
    out.append(lg)
    lg, caches = tfm.paged_decode(cfg, params, caches, last, cur, tbl2,
                                  active=act, page_tokens=pt)
    out.append(lg)
    return out, caches


def test_paged_steps_match_jax(setup):
    """Logits within 1e-5 of the reference's (rtol, and atol 1e-5 of its
    largest |logit|). The pools, four layers deep, agree within 1e-4 of
    each leaf's largest |value|: fp32 sums in another order part by up to
    2e-5 there."""
    jcfg, tree, cfg, params = setup[1], setup[2], setup[4], setup[5]
    pt = 16
    rng = np.random.default_rng(12)
    toks = rng.integers(2, cfg.vocab_size, (1, 8)).astype(np.int32)
    ext = rng.integers(2, cfg.vocab_size, (1, 6)).astype(np.int32)
    last = rng.integers(2, cfg.vocab_size, (2, 1)).astype(np.int32)
    cur = np.array([22, 0], np.int32)
    tbl1 = np.array([[1, 2, 3, 0]], np.int32)
    tbl2 = np.array([[1, 2, 3, 0], [0, 0, 0, 0]], np.int32)
    act = np.array([True, False])
    jout, jc = _paged_run(
        jtfm, jcfg, jax.tree.map(jnp.asarray, tree),
        jtfm.init_paged_caches(jcfg, 6, pt, jnp.float32),
        [jnp.asarray(a) for a in (toks, ext, last, cur)],
        jnp.asarray(tbl1), jnp.asarray(tbl2), jnp.asarray(act), pt)
    tout, tc = _paged_run(
        ttfm, cfg, params, ttfm.init_paged_caches(cfg, 6, pt, torch.float32,
                                                  device="cpu"),
        [torch.from_numpy(a) for a in (toks, ext, last, cur)],
        torch.from_numpy(tbl1), torch.from_numpy(tbl2), torch.from_numpy(act),
        pt)
    for j, t in zip(jout, tout):
        _close(t.numpy(), j)
    assert np.array_equal(np.argmax(np.asarray(jout[-1]), -1)[:1],
                          torch.argmax(tout[-1], -1).numpy()[:1])
    for j, t in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        _close(t.numpy(), j, rel=1e-4)
        # pages 1 and 2 written, the inactive row wrote nothing
        assert t[:, 1].any() and t[:, 2].any()
        assert not t[:, 0].any() and not t[:, 3:].any()


@pytest.mark.parametrize("entry,offset,S", [("prefill", 0, 9),
                                            ("extend", 12, 6),
                                            ("extend", 15, 2)])
def test_chunk_crossing_a_page_raises(setup, entry, offset, S):
    """At page 8 the first chunk may span the meta page and the page of
    the first prompt token (9 rows of 8-token pages: no further); a later
    chunk must lie within one page."""
    cfg, params = setup[4], setup[5]
    caches = ttfm.init_paged_caches(cfg, 5, PT, torch.float32, device="cpu")
    tbl = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    ttfm.paged_prefill(cfg, params, {"tokens": torch.full((1, 8), 3, dtype=torch.int32)},
                       caches, tbl, page_tokens=PT)      # pages 0-1: allowed
    toks = torch.full((1, S), 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="crosses"):
        if entry == "prefill":
            ttfm.paged_prefill(cfg, params, {"tokens": toks}, caches, tbl,
                               page_tokens=PT)
        else:
            ttfm.paged_extend(cfg, params, caches, toks, offset, tbl,
                              page_tokens=PT)
