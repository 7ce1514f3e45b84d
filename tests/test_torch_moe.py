"""The port's MoE MLP (repro_torch.models.moe) against the JAX package on
reduced deepseek-v2-lite-16b in fp32 (4 routed experts top-2, one shared
expert, expert d_ff 128), weights from the reference's initialiser:
``route`` (weights, expert ids, aux loss) and ``moe_sublayer`` at S 1, 16
and 40, B 1 and 4, within 1e-5 of the reference's largest magnitude; a
router biased toward one expert, which drops pairs at capacity; forced
ties, which go to the lower expert id as ``jax.lax.top_k`` sends them; and
the group size and capacity rules on the reduced and full configs. On
mixtral-8x22b (8 experts top-2, no shared experts): the group size and
capacity at expert d_ff 16384, where groups grow past 256 on sequences of
512 and more, route and the sublayer on the reduced config with 8 experts,
and the sublayer at d_ff 16384 on S 512 and 1024."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import moe as jmoe
from repro.models import param as jprm
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe as tmoe
from repro_torch.models.param import params_from_numpy
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ARCH = "deepseek-v2-lite-16b"


def _close(t, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(t), ref, rtol=rel,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config(ARCH), dtype="float32", param_dtype="float32")
    cfg = reduced(get_config(ARCH), dtype="float32", param_dtype="float32")
    assert (cfg.n_experts, cfg.moe_top_k, cfg.n_shared_experts) == (4, 2, 1)
    tree = jax.tree.map(np.asarray, jprm.materialize(
        jmoe.moe_defs(jcfg), jax.random.key(7), "float32"))
    return jcfg, cfg, tree


def _both(setup, x, tree=None):
    jcfg, cfg, base = setup
    tree = base if tree is None else tree
    jout, jaux = jmoe.moe_sublayer(jcfg, jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(x))
    tout, taux = tmoe.moe_sublayer(cfg, params_from_numpy(tree, device="cpu"),
                                   torch.from_numpy(x))
    return (np.asarray(jout), float(jaux)), (tout.numpy(), float(taux))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [1, 16, 40])
def test_route_matches_jax(setup, S, B):
    jcfg, cfg, tree = setup
    x = np.random.default_rng(S + B).normal(0, 1, (B * S, cfg.d_model)).astype(np.float32)
    jw, jidx, jaux = jmoe.route(jcfg, jnp.asarray(tree["router"]), jnp.asarray(x))
    tw, tidx, taux = tmoe.route(cfg, torch.from_numpy(tree["router"].copy()),
                                torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw.numpy(), jw)
    _close(float(taux), float(jaux))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [1, 16, 40])
def test_moe_sublayer_matches_jax(setup, S, B):
    x = np.random.default_rng(10 * S + B).normal(0, 1, (B, S, setup[1].d_model)
                                                 ).astype(np.float32)
    (jout, jaux), (tout, taux) = _both(setup, x)
    _close(tout, jout)
    _close(taux, jaux)


@pytest.mark.parametrize("S", [16, 40])
def test_capacity_drops_match_jax(setup, S):
    """A router biased toward expert 0 (a positive column against positive
    activations) sends every token's first choice there: in each group of g
    tokens, g - cap pairs are dropped, and the output still equals the
    reference's (the same kept set)."""
    jcfg, cfg, tree = setup
    biased = dict(tree, router=tree["router"].copy())
    biased["router"][:, 0] += 1.0
    x = np.abs(np.random.default_rng(S).normal(0, 1, (2, S, cfg.d_model))).astype(np.float32)
    g = tmoe._group_size(cfg, S)
    cap = tmoe._capacity(cfg, g)
    _, idx, _ = tmoe.route(cfg, torch.from_numpy(biased["router"]),
                           torch.from_numpy(x.reshape(-1, cfg.d_model)))
    assert (idx[:, 0] == 0).all()
    _, keep = tmoe.capacity_slots(idx.reshape(-1, g * cfg.moe_top_k), cfg.n_experts, cap)
    assert int((~keep).sum()) == 2 * (S // g) * (g - cap) > 0
    (jout, jaux), (tout, taux) = _both(setup, x, biased)
    _close(tout, jout)
    _close(taux, jaux)


@pytest.mark.parametrize("cols,want", [
    ((0, 0, 0, 0), (0, 1)),       # every probability equal
    ((0, 1, 0, 1), None),         # two equal pairs: the pair's lower id first
    ((1, 0, 1, 0), None),
])
def test_forced_ties_go_to_the_lower_expert(setup, cols, want):
    """Router columns copied from one another give bit-equal probabilities:
    the port picks jax.lax.top_k's experts in its order."""
    jcfg, cfg, tree = setup
    base = np.random.default_rng(3).normal(0, 0.1, (cfg.d_model, 2)).astype(np.float32)
    router = np.ascontiguousarray(base[:, list(cols)])
    x = np.random.default_rng(4).normal(0, 1, (12, cfg.d_model)).astype(np.float32)
    _, jidx, _ = jmoe.route(jcfg, jnp.asarray(router), jnp.asarray(x))
    tw, tidx, _ = tmoe.route(cfg, torch.from_numpy(router), torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    if want is not None:
        assert (tidx.numpy() == np.array(want)).all()
    else:
        assert set(map(tuple, tidx.numpy().tolist())) <= {(0, 2), (1, 3)}
    _close(tw.numpy(), np.full((12, 2), 0.5, np.float32))


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_group_size_and_capacity_follow_the_reference(full):
    jcfg = jax_get_config(ARCH) if full else jax_reduced(jax_get_config(ARCH))
    cfg = get_config(ARCH) if full else reduced(get_config(ARCH))
    for S in (1, 2, 3, 16, 32, 40, 48, 100, 256, 512, 2048, 4096, 8192):
        g = jmoe._group_size(jcfg, S)
        assert tmoe._group_size(cfg, S) == g, S
        # the reference computes the capacity inline in moe_sublayer
        cap = min(max(4, int(round(g / jcfg.n_experts * jcfg.moe_top_k
                                   * jcfg.capacity_factor))), g)
        assert tmoe._capacity(cfg, g) == cap, S


# ---------------------------------------------------------------------------
# mixtral-8x22b: 8 experts top-2, no shared experts, expert d_ff 16384
# ---------------------------------------------------------------------------

MIXTRAL = "mixtral-8x22b"


@pytest.mark.parametrize("S", [1, 40, 256, 512, 1024, 2048, 4096])
def test_mixtral_group_size_and_capacity_follow_the_reference(S):
    """At expert d_ff 16384 a group grows past 256 while 2g*1.25/(3*16384)
    < 0.03: to 512 on S 512 and to 1024 from S 1024 on."""
    jcfg, cfg = jax_get_config(MIXTRAL), get_config(MIXTRAL)
    assert (cfg.n_experts, cfg.moe_top_k, cfg.expert_d_ff) == (8, 2, 16384)
    g = jmoe._group_size(jcfg, S)
    assert tmoe._group_size(cfg, S) == g
    assert g == {1: 1, 40: 8, 256: 256, 512: 512}.get(S, 1024)
    cap = min(max(4, int(round(g / jcfg.n_experts * jcfg.moe_top_k
                               * jcfg.capacity_factor))), g)
    assert tmoe._capacity(cfg, g) == cap


def _mixtral(**kw):
    over = dict(dtype="float32", param_dtype="float32", n_experts=8, **kw)
    jcfg = jax_reduced(jax_get_config(MIXTRAL), **over)
    cfg = reduced(get_config(MIXTRAL), **over)
    assert (cfg.n_experts, cfg.moe_top_k, cfg.n_shared_experts) == (8, 2, 0)
    tree = jax.tree.map(np.asarray, jprm.materialize(
        jmoe.moe_defs(jcfg), jax.random.key(9), "float32"))
    assert not any(k.startswith("shared") for k in tree)
    return jcfg, cfg, tree


@pytest.fixture(scope="module")
def mixtral():
    return _mixtral()


@pytest.mark.parametrize("S", [1, 16, 40])
def test_mixtral_route_and_sublayer_match_jax(mixtral, S):
    """8 experts top-2, no shared experts: expert ids equal, weights, aux
    loss and output within 1e-5, B 2."""
    jcfg, cfg, tree = mixtral
    x = np.random.default_rng(20 + S).normal(0, 1, (2, S, cfg.d_model)).astype(np.float32)
    flat = x.reshape(-1, cfg.d_model)
    jw, jidx, jaux = jmoe.route(jcfg, jnp.asarray(tree["router"]), jnp.asarray(flat))
    tw, tidx, taux = tmoe.route(cfg, torch.from_numpy(tree["router"].copy()),
                                torch.from_numpy(flat))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw.numpy(), jw)
    _close(float(taux), float(jaux))
    (jout, jaux), (tout, taux) = _both(mixtral, x)
    _close(tout, jout)
    _close(taux, jaux)


@pytest.mark.parametrize("S", [512, 1024])
def test_mixtral_grown_groups_match_jax(S):
    """The sublayer at expert d_ff 16384 (d_model cut to 32), where groups
    grow past 256: one group of S tokens, capacity 1.25 S / 4."""
    setup = _mixtral(d_model=32, expert_d_ff=16384)
    cfg = setup[1]
    g = tmoe._group_size(cfg, S)
    assert g == S and tmoe._capacity(cfg, g) == round(S * 2 * 1.25 / 8)
    x = np.random.default_rng(S).normal(0, 1, (1, S, cfg.d_model)).astype(np.float32)
    (jout, jaux), (tout, taux) = _both(setup, x)
    _close(tout, jout)
    _close(taux, jaux)
