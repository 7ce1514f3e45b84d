"""The port's model (repro_torch.models) against the JAX package on
reduced qwen3-8b: the weight bridge keeps every parameter path, shape and
dtype (of reduced mamba2-2.7b and gemma-2b too); init_params draws the same shapes and scales; and the paged
prefill -> extend -> decode logits and page pools agree in fp32 within
1e-5 of the reference's largest magnitude — on reduced gemma-2b too
(GeGLU, tied and scaled embeddings, MQA at head_dim 256)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import transformer as jtfm
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import _fan_in_std, params_from_numpy, tree_leaves
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)


def _walk(tree, path):
    for k in path:
        tree = tree[k.key] if isinstance(k, jax.tree_util.DictKey) else tree[k.idx]
    return tree


def _np_params(dtype, arch="qwen3-8b", **kw):
    cfg = jax_reduced(jax_get_config(arch), dtype=dtype, param_dtype=dtype, **kw)
    return cfg, jax.tree.map(np.asarray, jtfm.init_params(cfg, jax.random.key(0)))


@pytest.mark.parametrize("arch,dtype", [
    pytest.param("qwen3-8b", "float32", id="float32"),
    pytest.param("qwen3-8b", "bfloat16", id="bfloat16"),
    pytest.param("mamba2-2.7b", "float32", id="mamba2-2.7b-float32"),
    pytest.param("mamba2-2.7b", "bfloat16", id="mamba2-2.7b-bfloat16"),
    pytest.param("gemma-2b", "bfloat16", id="gemma-2b-bfloat16"),
])
def test_params_from_numpy_keeps_paths_shapes_dtypes(arch, dtype):
    _, tree = _np_params(dtype, arch)
    port = params_from_numpy(tree, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(tree_leaves(port))
    for path, a in flat:
        t = _walk(port, path)
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype) == f"torch.{a.dtype.name}", path
        if dtype == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), a)


def test_init_params_matches_reference_layout_and_scale():
    """init_params draws the JAX package's shapes and dtypes, with norm
    gains at zero and the fan-in scale of ``_fan_in_std`` (H for wq, the
    vocabulary for lm_head, 1.0 for the untied embedding)."""
    _, tree = _np_params("bfloat16")
    cfg = reduced(get_config("qwen3-8b"))
    port = ttfm.init_params(cfg, 0, device="cpu")
    defs = ttfm.model_defs(cfg)
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        t, d = _walk(port, path), _walk(defs, path)
        assert tuple(t.shape) == a.shape and t.dtype == torch.bfloat16, path
        if d.init == "zeros":
            assert not t.any(), path
        else:
            std = float(t.float().std())
            assert abs(std / _fan_in_std(d) - 1) < 0.1, (path, std)
    assert defs["embed"]["embedding"].std == 1.0


def _paged_run(tfm, cfg, params, caches, to, tbl1, tbl2, act):
    """prefill 13 tokens, extend 6, one batched decode (row 1 inactive)."""
    toks, ext, last, cur = to
    out = []
    lg, caches = tfm.paged_prefill(cfg, params, {"tokens": toks}, caches, tbl1)
    out.append(lg)
    lg, caches = tfm.paged_extend(cfg, params, caches, ext, 13, tbl1)
    out.append(lg)
    lg, caches = tfm.paged_decode(cfg, params, caches, last, cur, tbl2,
                                  active=act)
    out.append(lg)
    return out, caches


def _check_paged_steps(arch, **kw):
    jcfg, tree = _np_params("float32", arch, **kw)
    cfg = reduced(get_config(arch), dtype="float32", param_dtype="float32", **kw)
    rng = np.random.default_rng(11)
    toks = rng.integers(2, cfg.vocab_size, (1, 13)).astype(np.int32)
    ext = rng.integers(2, cfg.vocab_size, (1, 6)).astype(np.int32)
    last = rng.integers(2, cfg.vocab_size, (2, 1)).astype(np.int32)
    cur = np.array([19, 0], np.int32)
    tbl1 = np.array([[1, 2, 3, 0]], np.int32)          # ps 8: 32 positions
    tbl2 = np.array([[1, 2, 3, 0], [0, 0, 0, 0]], np.int32)
    act = np.array([True, False])
    n_pages, ps = 6, 8

    jout, jc = _paged_run(
        jtfm, jcfg, jax.tree.map(jnp.asarray, tree),
        jtfm.init_paged_caches(jcfg, n_pages, ps, jnp.float32),
        [jnp.asarray(a) for a in (toks, ext, last, cur)],
        jnp.asarray(tbl1), jnp.asarray(tbl2), jnp.asarray(act))
    tout, tc = _paged_run(
        ttfm, cfg, params_from_numpy(tree, device="cpu"),
        ttfm.init_paged_caches(cfg, n_pages, ps, torch.float32, device="cpu"),
        [torch.from_numpy(a) for a in (toks, ext, last, cur)],
        torch.from_numpy(tbl1), torch.from_numpy(tbl2), torch.from_numpy(act))

    for j, t in zip(jout, tout):
        ref = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    assert np.array_equal(np.argmax(np.asarray(jout[-1]), -1)[:1],
                          torch.argmax(tout[-1], -1).numpy()[:1])
    for j, t in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        ref = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    # the inactive row wrote nothing: pages 4, 5 and the null page stay zero
    for t in tree_leaves(tc):
        assert not t[:, 0].any() and not t[:, 4:].any()


def test_paged_steps_match_jax():
    _check_paged_steps("qwen3-8b")


def test_gemma_2b_paged_steps_match_jax():
    """The logits gate on gemma-2b serving: GeGLU, tied and scaled
    embeddings, one KV head at head_dim 256."""
    _check_paged_steps("gemma-2b", head_dim=256)
