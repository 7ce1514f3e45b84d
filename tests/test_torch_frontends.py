"""The port's modality frontends (repro_torch.models.frontends), the
multi-codebook embedding and heads, the image prefix, and the three stacks
they complete, against the JAX package in fp32:

- ``token_shape``, ``input_specs`` / ``decode_input_specs`` (shapes and
  dtypes, for every assigned shape) and ``sample_batch`` (the same
  integers and, in float32, the same normals) on musicgen-large,
  internvl2-76b and mixtral-8x22b;
- ``embed`` and ``lm_logits`` with 4 codebooks within 1e-5;
- ``_embed_inputs`` with image embeds and meta tokens: the order meta,
  image, text and the prefix length;
- paged prefill -> extend -> decode logits of reduced musicgen-large,
  internvl2-76b (8 patch embeddings) and mixtral-8x22b (8 experts top-2,
  window 64, reached by the decode) within 1e-5 of the reference's largest
  magnitude, and every layer's pool within 1e-5 (wq and wk conditioned,
  see ``test_paged_steps_match_jax``).
The engine on these stacks: ``tests/test_torch_engine_frontends.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import frontends as jfe
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.models import frontends as tfe
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import params_from_numpy, tree_leaves
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("musicgen-large", "internvl2-76b", "mixtral-8x22b")
PT = 8     # page tokens of the stack test


def _close(t, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(t), ref, rtol=rel,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def _configs(arch, **kw):
    f32 = dict(dtype="float32", param_dtype="float32", **kw)
    return (jax_reduced(jax_get_config(arch), **f32),
            reduced(get_config(arch), **f32))


# ---------------------------------------------------------------------------
# Input specs and sample batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch, shape):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert vars(SHAPES[shape]) == vars(JAX_SHAPES[shape])
    for jfn, tfn in ((jfe.input_specs, tfe.input_specs),
                     (jfe.decode_input_specs, tfe.decode_input_specs)):
        want = jfn(jcfg, JAX_SHAPES[shape])
        got = tfn(cfg, SHAPES[shape])
        assert sorted(got) == sorted(want)
        for k, spec in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == spec.shape, k
            assert str(got[k].dtype) == f"torch.{spec.dtype.name}", k


@pytest.mark.parametrize("arch", ARCHS)
def test_token_shape_matches_jax(arch):
    for B, S in ((1, 1), (3, 17)):
        assert tfe.token_shape(get_config(arch), B, S) == \
            jfe.token_shape(jax_get_config(arch), B, S)


@pytest.mark.parametrize("arch", ARCHS)
def test_sample_batch_matches_jax(arch):
    """The same seed gives the reference's integers and float32 normals."""
    jcfg, cfg = _configs(arch)
    for seed, labels in ((0, True), (5, False)):
        want = jfe.sample_batch(jcfg, 2, 24, seed=seed, with_labels=labels)
        got = tfe.sample_batch(cfg, 2, 24, seed=seed, with_labels=labels)
        assert sorted(got) == sorted(want)
        for k, a in want.items():
            a = np.asarray(a)
            assert got[k].device.type == "cpu"
            assert str(got[k].dtype) == f"torch.{a.dtype.name}", k
            np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
    if cfg.frontend == "vision":
        assert got["tokens"].shape[1] == 24 - cfg.n_frontend_tokens
    if cfg.n_codebooks > 1:
        assert got["tokens"].shape[2] == cfg.n_codebooks


# ---------------------------------------------------------------------------
# Codebook embedding and heads, the image prefix
# ---------------------------------------------------------------------------


def test_codebook_embed_and_heads_match_jax():
    """(K, V, D) tables: the embedding sums K rows, the head gives (.., K, V)."""
    jcfg, cfg = _configs("musicgen-large")
    assert cfg.n_codebooks == 4
    tree = jax.tree.map(np.asarray, jtfm.init_params(jcfg, jax.random.key(2)))["embed"]
    assert tree["embedding"].shape == (4, cfg.padded_vocab, cfg.d_model)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 5, 4)).astype(np.int32)
    x = rng.normal(0, 1, (2, 5, cfg.d_model)).astype(np.float32)
    p = params_from_numpy(tree, device="cpu")
    emb = tlayers.embed(cfg, p, torch.from_numpy(toks))
    _close(emb.numpy(), jlayers.embed(jcfg, jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(toks)))
    logits = tlayers.lm_logits(cfg, p, torch.from_numpy(x))
    assert tuple(logits.shape) == (2, 5, 4, cfg.padded_vocab)
    _close(logits.numpy(), jlayers.lm_logits(jcfg, jax.tree.map(jnp.asarray, tree),
                                             jnp.asarray(x)))


def test_embed_inputs_order_and_prefix():
    """A vision stack with meta tokens: meta, then image, then text."""
    jcfg, cfg = _configs("internvl2-76b", n_meta_tokens=4)
    tree = jax.tree.map(np.asarray, jtfm.init_params(jcfg, jax.random.key(1)))
    batch = jfe.sample_batch(jcfg, 2, 20, seed=3, with_labels=False)
    jx, jprefix = jtfm._embed_inputs(jcfg, tree, batch)
    p = params_from_numpy(tree, device="cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    x, prefix = ttfm._embed_inputs(cfg, p, tbatch)
    assert prefix == jprefix == 4 + 8
    assert tuple(x.shape) == (2, 20 + 4, cfg.d_model)
    _close(x.numpy(), jx)
    np.testing.assert_array_equal(x[:, :4].numpy(),
                                  np.broadcast_to(tree["meta_tokens"], (2, 4, cfg.d_model)))
    np.testing.assert_array_equal(x[:, 4:12].numpy(), np.asarray(batch["image_embeds"]))
    np.testing.assert_array_equal(
        x[:, 12:].numpy(), tlayers.embed(cfg, p["embed"], tbatch["tokens"]).numpy())
    # without image embeds a vision stack embeds the text alone
    x, prefix = ttfm._embed_inputs(cfg, p, {"tokens": tbatch["tokens"]})
    assert prefix == 4 and x.shape[1] == 12 + 4


# ---------------------------------------------------------------------------
# The whole reduced stacks on the paged plane
# ---------------------------------------------------------------------------


def _paged_run(tfm, cfg, params, caches, inputs, tbl1, tbl2, act, n_first):
    """The first chunk (image embeds in front for vision), a 6-token extend
    and one batched decode (row 1 inactive)."""
    batch, ext, last, cur = inputs
    out = []
    lg, caches = tfm.paged_prefill(cfg, params, batch, caches, tbl1)
    out.append(lg)
    lg, caches = tfm.paged_extend(cfg, params, caches, ext, n_first, tbl1)
    out.append(lg)
    lg, caches = tfm.paged_decode(cfg, params, caches, last, cur, tbl2, active=act)
    out.append(lg)
    return out, caches


def _conditioned(path, a, d_model):
    """``a``, rescaled to std d_model^-1/2 where ``path`` names wq or wk."""
    if jax.tree_util.keystr(path[-1:]) in ("['wq']", "['wk']"):
        return (a * (d_model ** -0.5 / a.std())).astype(a.dtype)
    return a


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_steps_match_jax(arch):
    """Logits of prefill, extend and decode within 1e-5, and every layer's
    KV pool within 1e-5. mixtral's decode sits at position 66, past its
    reduced window of 64.

    wq and wk are rescaled to std d_model^-1/2 on both sides, as
    ``tests/test_torch_train.py`` does: the reference's fan-in rule gives
    them std 0.5 on 4 heads, the scores then have std ~32 and saturate, and
    the reference's own prefill logits move by up to ~4e-5 (musicgen) and
    ~1e-5 (internvl2) relative when its weights move by one ulp. Rescaled,
    they move by ~6e-7 and the port agrees to ~5e-7."""
    kw = {"n_experts": 8} if arch == "mixtral-8x22b" else {}
    jcfg, cfg = _configs(arch, **kw)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: _conditioned(path, np.asarray(a), cfg.d_model),
        jtfm.init_params(jcfg, jax.random.key(0)))
    K = cfg.n_codebooks
    n_text = 60 if arch == "mixtral-8x22b" else 13
    batch = jfe.sample_batch(jcfg, 1, n_text + (cfg.n_frontend_tokens
                                                if cfg.frontend == "vision" else 0),
                             seed=4, with_labels=False)
    n_first = n_text + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
    rng = np.random.default_rng(11)
    tail = (K,) if K > 1 else ()
    ext = rng.integers(0, cfg.vocab_size, (1, 6) + tail).astype(np.int32)
    last = rng.integers(0, cfg.vocab_size, (2, 1) + tail).astype(np.int32)
    cur = np.array([n_first + 6, 0], np.int32)
    n_pages = -(-(n_first + 7) // PT)
    tbl1 = np.arange(1, n_pages + 1, dtype=np.int32)[None]
    tbl2 = np.concatenate([tbl1, np.zeros_like(tbl1)])
    act = np.array([True, False])
    if arch == "mixtral-8x22b":
        assert cfg.n_experts == 8 and cfg.moe_top_k == 2
        assert not cfg.n_shared_experts and cur[0] > 64
        assert all(s.window == 64 and s.mlp == "moe" for s in cfg.layer_specs())

    jout, jc = _paged_run(
        jtfm, jcfg, jax.tree.map(jnp.asarray, tree),
        jtfm.init_paged_caches(jcfg, n_pages + 1, PT, jnp.float32),
        ({k: jnp.asarray(v) for k, v in batch.items()},
         *[jnp.asarray(a) for a in (ext, last, cur)]),
        jnp.asarray(tbl1), jnp.asarray(tbl2), jnp.asarray(act), n_first)
    tout, tc = _paged_run(
        ttfm, cfg, params_from_numpy(tree, device="cpu"),
        ttfm.init_paged_caches(cfg, n_pages + 1, PT, torch.float32, device="cpu"),
        ({k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
         *[torch.from_numpy(a) for a in (ext, last, cur)]),
        torch.from_numpy(tbl1), torch.from_numpy(tbl2), torch.from_numpy(act),
        n_first)
    for j, t in zip(jout, tout):
        assert tuple(t.shape) == j.shape
        _close(t.numpy(), j)
    if K > 1:
        assert tout[0].shape[-2:] == (K, cfg.padded_vocab)
    jl, tl = jax.tree.leaves(jc), tree_leaves(tc)
    assert [tuple(t.shape) for t in tl] == [j.shape for j in jl]
    for j, t in zip(jl, tl):
        _close(t.numpy(), j)
