"""The port's MLA (repro_torch.models.mla) and the MLA + MoE stack against
the JAX package on reduced deepseek-v2-lite-16b in fp32 (r 64, dr 16: a
latent head of 80 shared by 4 query heads), weights from the reference's
initialiser:

- the paged ``mla_sublayer`` in extend and decode modes on the same
  pages: outputs and written pages within 1e-5 (inactive and null rows
  write nothing);
- the plain paged attention at Hq 4 / Hkv 1 / D 80 (the rows form and the
  ragged form the port calls) against the reference's
  ``paged_attention_rows`` within 1e-5;
- paged prefill -> extend -> decode logits of the whole reduced model
  (one dense layer, three MoE layers) within 1e-5, and its latent pools
  within 1e-5 or twice the reference's own drift under a one-ulp weight
  nudge, whichever is more (the fourth layer's pool drifts ~2e-5);
- the wrapper takes the latent head widths; train mode matches the
  reference's, ``loss_and_metrics`` trains the stack with its aux loss,
  and the ring mode gives the paged extend's output.
The engine on this stack: ``tests/test_torch_engine_mla.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.paged_attention import paged_attention_rows as jax_rows
from repro.models import mla as jmla
from repro.models import param as jprm
from repro.models import transformer as jtfm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import (paged_attention_rows,
                                                 ragged_paged_attention)
from repro_torch.models import mla as tmla
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import params_from_numpy, tree_leaves
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ARCH = "deepseek-v2-lite-16b"
PT = 8     # page tokens of the layer tests


def _close(t, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(t), ref, rtol=rel,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config(ARCH), dtype="float32", param_dtype="float32")
    cfg = reduced(get_config(ARCH), dtype="float32", param_dtype="float32")
    assert cfg.kv_lora_rank + cfg.qk_rope_dim == 80 and cfg.n_heads == 4
    return jcfg, cfg


# ---------------------------------------------------------------------------
# The sublayer
# ---------------------------------------------------------------------------


def _layer(setup, seed, n_pages=6):
    """One MLA layer's weights (JAX init, bridged) and a random latent pool
    (P, PT, 2, r + dr) whose null page 0 is zero."""
    jcfg, cfg = setup
    tree = jax.tree.map(np.asarray, jprm.materialize(
        jmla.mla_defs(jcfg), jax.random.key(seed), "float32"))
    rng = np.random.default_rng(seed)
    pool = rng.normal(0, 0.5, (n_pages, PT, 2, 80)).astype(np.float32)
    pool[0] = 0
    return tree, pool, rng


def _sublayer_both(setup, tree, pool, x, **kw):
    jcfg, cfg = setup
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jout, jc = jmla.mla_sublayer(jcfg, jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(x),
                                 cache={"kv_pages": jnp.asarray(pool)}, **jkw)
    tpool = torch.from_numpy(pool.copy())
    tout, tc = tmla.mla_sublayer(cfg, params_from_numpy(tree, device="cpu"),
                                 torch.from_numpy(x), cache={"kv_pages": tpool},
                                 **tkw)
    assert tc["kv_pages"] is tpool      # written in place
    return jout, np.asarray(jc["kv_pages"]), tout.numpy(), tpool.numpy()


@pytest.mark.parametrize("offset,S,B", [(0, 8, 1), (0, 13, 1), (8, 6, 1),
                                        (10, 5, 1), (16, 1, 1), (3, 9, 2)])
def test_mla_sublayer_extend_matches_jax(setup, offset, S, B):
    tree, pool, rng = _layer(setup, seed=offset + S)
    x = rng.normal(0, 1, (B, S, setup[1].d_model)).astype(np.float32)
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0]][:B], np.int32)
    positions = (offset + np.arange(S)).astype(np.int32)
    jout, jpool, tout, tpool = _sublayer_both(setup, tree, pool, x, mode="extend",
                                              positions=positions, page_table=table)
    _close(tout, jout)
    _close(tpool, jpool)
    assert not tpool[0].any()
    # V' = [c, 0]: the value row's rope lanes are zero where the chunk wrote
    pids = np.array([table[b, p // PT] for b in range(B) for p in positions])
    rows = np.tile(positions % PT, B)
    assert not tpool[pids, rows, 1, 64:].any()
    assert tpool[pids, rows, 0, 64:].any()


def test_mla_sublayer_decode_matches_jax_with_inactive_and_null_rows(setup):
    """Row 0 decodes at 13 (its open page 2); row 1 is inactive (real
    table, writes nothing); row 2 has an all-null table (writes dropped);
    row 3 opens page 5 at 16."""
    tree, pool, rng = _layer(setup, seed=4)
    x = rng.normal(0, 1, (4, 1, setup[1].d_model)).astype(np.float32)
    table = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [0, 0, 0, 0], [1, 2, 5, 0]],
                     np.int32)
    cur = np.array([13, 9, 4, 16], np.int32)
    act = np.array([True, False, True, True])
    jout, jpool, tout, tpool = _sublayer_both(
        setup, tree, pool, x, mode="decode", cur_pos=cur, decode_active=act,
        page_table=table, positions=cur[:, None])
    _close(tout, jout)
    # the reference's write lands row 2's row in null page 0 (never read:
    # every reader masks page 0); the port writes nothing there
    _close(tpool[1:], jpool[1:])
    assert not tpool[0].any()
    np.testing.assert_array_equal(tpool[[1, 3, 4]], pool[[1, 3, 4]])
    assert not np.array_equal(tpool[[2, 5]], pool[[2, 5]])


def test_mla_sublayer_refuses_what_is_not_ported(setup):
    """What MLA once refused now runs: train mode (ROADMAP A.4, un-absorbed
    through ``chunked_attention`` at Dk 48 != Dv 32) matches the
    reference's train-mode sublayer within 1e-5; the ring mode (A.6) gives
    the paged extend's output; ``loss_and_metrics`` trains the reduced
    MLA + MoE stack, its MoE aux loss in the loss."""
    jcfg, cfg = setup
    tree, pool, _ = _layer(setup, seed=1)
    p = params_from_numpy(tree, device="cpu")
    xs = np.random.default_rng(2).normal(0, 1, (2, 12, cfg.d_model)).astype(np.float32)
    want, _ = jmla.mla_sublayer(jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(xs),
                                positions=jnp.arange(12), mode="train")
    got, cache = tmla.mla_sublayer(cfg, p, torch.from_numpy(xs),
                                   positions=torch.arange(12), mode="train")
    assert cache is None
    _close(got.numpy(), want)
    # the ring mode (once ROADMAP A.6) serves: a chunk into an empty ring
    # gives the paged extend's output on empty pages
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 4, cfg.d_model)).astype(np.float32))
    ring_out, ring = tmla.mla_sublayer(cfg, p, x, positions=torch.arange(4),
                                       mode="extend", page_tokens=PT,
                                       cache=tmla.mla_cache_init(cfg, 1, 2 * PT,
                                                                 torch.float32))
    paged_out, _ = tmla.mla_sublayer(
        cfg, p, x, positions=torch.arange(4), mode="extend",
        cache={"kv_pages": torch.zeros(3, PT, 2, 80)},
        page_table=torch.tensor([[1, 2]], dtype=torch.int32))
    _close(ring_out.numpy(), paged_out.numpy())
    assert ring["pos"][0, :4].tolist() == [0, 1, 2, 3]
    loss, metrics = ttfm.loss_and_metrics(
        cfg, ttfm.init_params(cfg, 0, device="cpu"),
        {"tokens": torch.zeros(1, 8, dtype=torch.long),
         "labels": torch.zeros(1, 8, dtype=torch.long)})
    assert torch.isfinite(loss) and float(metrics["aux"]) > 0
    assert float(loss) == float(metrics["ce"] + metrics["z_loss"] + metrics["aux"])


# ---------------------------------------------------------------------------
# The plain paged attention at the reduced latent head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_paged_attention_at_the_latent_head_matches_jax(seed):
    """Hq 4 on one KV head of width 80 at scale (dn + dr)^-1/2: the rows
    form, and the ragged form the model calls (one query row per sequence
    and a 5-row chunk), against the reference's rows form."""
    rng = np.random.default_rng(seed)
    P, W = 9, 4
    pages = rng.normal(0, 1, (P, PT, 2, 80)).astype(np.float32)
    pages[0] = 0
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 0, 7, 8]], np.int32)
    kv_lens = np.array([20, 9, 30], np.int32)
    q_lens = np.array([1, 5, 1], np.int32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    seg = np.repeat(np.arange(3), q_lens)
    q_pos = (kv_lens[seg] - q_lens[seg] + np.arange(cu[-1]) - cu[seg]).astype(np.int32)
    q = rng.normal(0, 1, (cu[-1], 4, 80)).astype(np.float32)
    scale = (32 + 16) ** -0.5
    want = np.asarray(jax_rows(jnp.asarray(q), jnp.asarray(pages),
                               jnp.asarray(table[seg]), jnp.asarray(q_pos),
                               scale=scale))
    rows = paged_attention_rows(torch.from_numpy(q), torch.from_numpy(pages),
                                torch.from_numpy(table[seg]), torch.from_numpy(q_pos),
                                scale=scale)
    ragged = ragged_paged_attention(torch.from_numpy(q), torch.from_numpy(pages),
                                    torch.from_numpy(table), torch.from_numpy(cu),
                                    torch.from_numpy(kv_lens), scale=scale)
    assert W == table.shape[1]
    _close(rows.numpy(), want)
    _close(ragged.numpy(), want)


@pytest.mark.parametrize("D,ok", [(80, True), (576, True), (96, False), (512, False)])
def test_wrapper_takes_the_latent_head_widths(D, ok):
    """The CUDA wrapper's checks (run before any launch) take MLA's latent
    heads, reduced (80) and full (576), and refuse widths no kernel
    instantiates."""
    args = (torch.zeros(2, 16, D), torch.zeros(3, 16, 2, D),
            torch.zeros(2, 2, dtype=torch.int32), torch.tensor([0, 1, 2], dtype=torch.int32),
            torch.tensor([5, 9], dtype=torch.int32))
    if ok:
        pa_ops._check(*args)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            pa_ops._check(*args)


# ---------------------------------------------------------------------------
# The whole reduced stack
# ---------------------------------------------------------------------------


def _paged_run(tfm, cfg, params, caches, to, tbl1, tbl2, act):
    """prefill 13 tokens, extend 6, one batched decode (row 1 inactive)."""
    toks, ext, last, cur = to
    out = []
    lg, caches = tfm.paged_prefill(cfg, params, {"tokens": toks}, caches, tbl1)
    out.append(lg)
    lg, caches = tfm.paged_extend(cfg, params, caches, ext, 13, tbl1)
    out.append(lg)
    lg, caches = tfm.paged_decode(cfg, params, caches, last, cur, tbl2, active=act)
    out.append(lg)
    return out, caches


def _nudged(tree, seed=0):
    """Every fp32 weight moved by one ulp up or down at random."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a * (1 + rng.choice([-1.0, 1.0], a.shape) * 2.0 ** -24)
                   ).astype(np.float32), tree)


def test_paged_steps_match_jax(setup):
    """Prefill (13 tokens: MoE groups of one token), extend (6: three
    groups of two, capacity 2) and a batched decode with an inactive row.
    Logits within 1e-5. Each layer's latent pool within 1e-5, or twice
    what the reference's own pool moves when its weights move by one ulp,
    if that is more: the stack amplifies rounding with depth (the
    reference against itself reaches ~2e-5 in the fourth layer)."""
    jcfg, cfg = setup
    tree = jax.tree.map(np.asarray, jtfm.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(11)
    toks = rng.integers(2, cfg.vocab_size, (1, 13)).astype(np.int32)
    ext = rng.integers(2, cfg.vocab_size, (1, 6)).astype(np.int32)
    last = rng.integers(2, cfg.vocab_size, (2, 1)).astype(np.int32)
    cur = np.array([19, 0], np.int32)
    tbl1 = np.array([[1, 2, 3, 0]], np.int32)
    tbl2 = np.array([[1, 2, 3, 0], [0, 0, 0, 0]], np.int32)
    act = np.array([True, False])
    n_pages = 6

    def jax_run(tr):
        return _paged_run(
            jtfm, jcfg, jax.tree.map(jnp.asarray, tr),
            jtfm.init_paged_caches(jcfg, n_pages, PT, jnp.float32),
            [jnp.asarray(a) for a in (toks, ext, last, cur)],
            jnp.asarray(tbl1), jnp.asarray(tbl2), jnp.asarray(act))

    jout, jc = jax_run(tree)
    _, jc_nudged = jax_run(_nudged(tree))
    tout, tc = _paged_run(
        ttfm, cfg, params_from_numpy(tree, device="cpu"),
        ttfm.init_paged_caches(cfg, n_pages, PT, torch.float32, device="cpu"),
        [torch.from_numpy(a) for a in (toks, ext, last, cur)],
        torch.from_numpy(tbl1), torch.from_numpy(tbl2), torch.from_numpy(act))
    for j, t in zip(jout, tout):
        _close(t.numpy(), j)
    jl, tl = jax.tree.leaves(jc), tree_leaves(tc)
    assert [tuple(t.shape) for t in tl] == [j.shape for j in jl]
    assert tl[0].shape[-2:] == (2, 80)
    for j, jn, t in zip(jl, jax.tree.leaves(jc_nudged), tl):
        for layer in range(j.shape[0]):
            ref = np.asarray(j[layer])
            drift = np.abs(np.asarray(jn[layer]) - ref).max() / np.abs(ref).max()
            _close(t[layer].numpy(), ref, rel=max(1e-5, 2 * drift))
        assert not t[:, 0].any() and not t[:, 4:].any()
