"""SSM and hybrid layers on ring caches: the port's ``ssm_sublayer`` on
reduced mamba2-2.7b and ``hybrid_sublayer`` on reduced hymba-1.5b in their
ring modes (``prefill``, ``extend``, ``decode``) against the JAX package in
fp32, the reference's own SSD tolerance (2e-4, ``tests/test_kernels.py``)
on outputs and on every ring leaf: the conv left-context and the SSD state,
and the hybrid's attention ring (K and V split out of the port's fused
ring, positions exactly). Rows where ``decode_active`` is False keep their
rings bit for bit. Inputs are made with numpy and handed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import hybrid as jhyb
from repro.models import param as jprm
from repro.models import ssm as jssm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.paged_attention import interleave_kv, split_kv
from repro_torch.models import hybrid as thyb
from repro_torch.models import ssm as tssm
from repro_torch.models.param import params_from_numpy
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-4
C, PT = 32, 8       # the hybrid's attention ring, and the page it is read as


def _close(t, ref, rel=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(t), ref, rtol=rel,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def _setup(arch, defs):
    jcfg = jax_reduced(jax_get_config(arch), dtype="float32", param_dtype="float32")
    cfg = reduced(get_config(arch), dtype="float32", param_dtype="float32")
    tree = jax.tree.map(np.asarray, jprm.materialize(defs(jcfg), jax.random.key(5),
                                                     "float32"))
    return jcfg, cfg, tree


@pytest.fixture(scope="module")
def mamba():
    return _setup("mamba2-2.7b", jssm.ssm_defs)


@pytest.fixture(scope="module")
def hymba():
    return _setup("hymba-1.5b", jhyb.hybrid_defs)


def _ssm_state(cfg, B, rng, fresh):
    """A ring's conv left-context and SSD state, zero (a fresh ring) or
    random (a carried history)."""
    ref = tssm.ssm_cache_init(cfg, B, torch.float32)
    if fresh:
        return {k: v.numpy() for k, v in ref.items()}
    return {k: rng.normal(0, 0.5, v.shape).astype(np.float32) for k, v in ref.items()}


def _run_ssm(setup, mode, x, ring, **kw):
    jcfg, cfg, tree = setup
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jout, jring = jssm.ssm_sublayer(jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                                    cache=jax.tree.map(jnp.asarray, ring), mode=mode, **jkw)
    tring = {k: torch.from_numpy(v.copy()) for k, v in ring.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tout, new = tssm.ssm_sublayer(cfg, params_from_numpy(tree, device="cpu"),
                                  torch.from_numpy(x), cache=tring, mode=mode, **tkw)
    assert new is tring                       # written in place
    return (np.asarray(jout), jax.tree.map(np.asarray, jring), tout.numpy(),
            {k: v.numpy() for k, v in tring.items()})


@pytest.mark.parametrize("mode,S,B,fresh", [("prefill", 40, 1, True),
                                            ("prefill", 9, 2, True),
                                            ("extend", 16, 1, False),
                                            ("extend", 5, 2, False)])
def test_ssm_ring_prefill_and_extend_match_jax(mamba, mode, S, B, fresh):
    """One path: the scan from the ring's state (zero for a first chunk),
    whose final conv and state replace the ring's."""
    cfg = mamba[1]
    rng = np.random.default_rng(S + B)
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    off = 0 if fresh else 24
    jout, jring, tout, tring = _run_ssm(mamba, mode, x, _ssm_state(cfg, B, rng, fresh),
                                        positions=np.arange(off, off + S, dtype=np.int32))
    _close(tout, jout)
    for k in ("conv", "state"):
        _close(tring[k], jring[k])


def test_ssm_ring_decode_matches_jax_with_an_inactive_row(mamba):
    cfg = mamba[1]
    rng = np.random.default_rng(11)
    ring = _ssm_state(cfg, 3, rng, fresh=False)
    x = rng.normal(0, 1, (3, 1, cfg.d_model)).astype(np.float32)
    cur = np.array([7, 30, 2], np.int32)
    act = np.array([True, False, True])
    jout, jring, tout, tring = _run_ssm(mamba, "decode", x, ring, cur_pos=cur,
                                        positions=cur[:, None], decode_active=act)
    _close(tout[act], jout[act])
    for k in ("conv", "state"):
        _close(tring[k], jring[k])
        np.testing.assert_array_equal(tring[k][1], ring[k][1])   # inactive: untouched
        assert not np.array_equal(tring[k][0], ring[k][0])


def test_ssm_ring_refuses_a_page_table_and_training(mamba):
    jcfg, cfg, tree = mamba
    p = params_from_numpy(tree, device="cpu")
    x = torch.zeros(1, 2, cfg.d_model)
    ring = tssm.ssm_cache_init(cfg, 1, torch.float32)
    with pytest.raises(ValueError, match="no page table"):
        tssm.ssm_sublayer(cfg, p, x, cache=ring, mode="extend", positions=torch.arange(2),
                          page_table=torch.zeros(1, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="takes no cache"):
        tssm.ssm_sublayer(cfg, p, x, cache=ring, mode="train")


# ---------------------------------------------------------------------------
# The hybrid: the attention ring and the SSM ring under one sublayer
# ---------------------------------------------------------------------------


def _hybrid_ring(cfg, B, rng, filled):
    """Both halves' rings: random K/V at positions ``range(*filled[b])``
    (slot p % C) and a random conv/state (zero where nothing is filled)."""
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    pos = np.full((B, C), -1, np.int32)
    for b, (lo, hi) in enumerate(filled):
        p = np.arange(max(lo, hi - C), hi)
        pos[b, p % C] = p
    k = rng.normal(0, 1, (B, C, hk, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, C, hk, hd)).astype(np.float32)
    return {"k": k, "v": v, "pos": pos}, _ssm_state(cfg, B, rng,
                                                    fresh=all(h == 0 for _, h in filled))


def _run_hybrid(setup, mode, x, attn, ssm, window, **kw):
    jcfg, cfg, tree = setup
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jout, jc = jhyb.hybrid_sublayer(
        jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(x), window=window,
        cache={"attn": jax.tree.map(jnp.asarray, attn), "ssm": jax.tree.map(jnp.asarray, ssm)},
        mode=mode, **jkw)
    tcache = {"attn": {"kv": interleave_kv(torch.from_numpy(attn["k"]),
                                           torch.from_numpy(attn["v"])),
                       "pos": torch.from_numpy(attn["pos"].copy())},
              "ssm": {k: torch.from_numpy(v.copy()) for k, v in ssm.items()}}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tout, tc = thyb.hybrid_sublayer(cfg, params_from_numpy(tree, device="cpu"),
                                    torch.from_numpy(x), window=window, cache=tcache,
                                    mode=mode, page_tokens=PT, **tkw)
    assert tc["attn"]["kv"] is tcache["attn"]["kv"]       # written in place
    assert tc["ssm"]["state"] is tcache["ssm"]["state"]
    return np.asarray(jout), jax.tree.map(np.asarray, jc), tout.numpy(), tcache


def _check_hybrid(jout, jc, tout, tc, rows=slice(None)):
    _close(tout[rows], jout[rows])
    k, v = split_kv(tc["attn"]["kv"])
    _close(k.numpy(), jc["attn"]["k"])
    _close(v.numpy(), jc["attn"]["v"])
    np.testing.assert_array_equal(tc["attn"]["pos"].numpy(), jc["attn"]["pos"])
    for key in ("conv", "state"):
        _close(tc["ssm"][key].numpy(), jc["ssm"][key])


@pytest.mark.parametrize("window", [None, C])
@pytest.mark.parametrize("mode,offset,S", [("prefill", 0, 20), ("extend", 20, 6),
                                           ("extend", 40, 8)])
def test_hybrid_ring_matches_jax(hymba, window, mode, offset, S):
    """A first chunk into fresh rings (the flash forward, the scan from
    zeros), and chunks after it: one that continues the ring and one that
    wraps it (positions 40..47 over a ring of 32)."""
    cfg = hymba[1]
    rng = np.random.default_rng(offset + S)
    x = rng.normal(0, 1, (1, S, cfg.d_model)).astype(np.float32)
    attn, ssm = _hybrid_ring(cfg, 1, rng, [(0, offset)])
    out = _run_hybrid(hymba, mode, x, attn, ssm, window,
                      positions=np.arange(offset, offset + S, dtype=np.int32))
    _check_hybrid(*out)


def test_hybrid_ring_decode_matches_jax_with_an_inactive_row(hymba):
    cfg = hymba[1]
    rng = np.random.default_rng(2)
    attn, ssm = _hybrid_ring(cfg, 3, rng, [(0, 13), (0, 30), (5, 45)])
    x = rng.normal(0, 1, (3, 1, cfg.d_model)).astype(np.float32)
    cur = np.array([13, 30, 45], np.int32)
    act = np.array([True, False, True])
    jout, jc, tout, tc = _run_hybrid(hymba, "decode", x, attn, ssm, C, cur_pos=cur,
                                     positions=cur[:, None], decode_active=act)
    _check_hybrid(jout, jc, tout, tc, rows=act)
    k, v = split_kv(tc["attn"]["kv"])
    np.testing.assert_array_equal(k[1].numpy(), attn["k"][1])
    np.testing.assert_array_equal(tc["attn"]["pos"][1].numpy(), attn["pos"][1])
    np.testing.assert_array_equal(tc["ssm"]["state"][1].numpy(), ssm["state"][1])
