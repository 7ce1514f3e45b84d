"""The port's serving engine on the MLA + MoE stack: reduced
deepseek-v2-lite-16b in fp32 (latent pages of width 80, one dense layer and
three MoE layers) against the JAX engine with the same weights and prompts,
at the reference's paged-engine flags (page 16, 16-token chunks): the same
greedy tokens and the same report, memory plane and byte ledgers included.
A prefix hit decodes a cold start's tokens with zero copy bytes (cold and
hit cut prompts at the same 16-token boundaries, so MoE groups and
capacities are the same), and migrated latent pages serve a hit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.memclass import HBM3E as JAX_HBM3E
from repro.core.memclass import MRM_RRAM as JAX_MRM_RRAM
from repro.core.simulator import MemorySystem as JaxMemorySystem
from repro.models import init_params as jax_init_params
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.core.memclass import HBM3E, MRM_RRAM
from repro_torch.core.simulator import MemorySystem
from repro_torch.models.param import params_from_numpy, tree_leaves
from repro_torch.serving import ServeEngine, EngineConfig
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ARCH = "deepseek-v2-lite-16b"
# the reference's paged-engine flags (tests/test_paged_attention.py)
ECFG = dict(max_slots=2, max_cache_len=96, weight_tier="hbm", kv_tier="mrm",
            eos_token=-1, chunk_tokens=16, page_tokens=16,
            radix_hot_threshold=2, paged_kernel=True)


@pytest.fixture(scope="module")
def setup():
    jfull = jax_get_config(ARCH)
    jcfg = jax_reduced(jfull, dtype="float32", param_dtype="float32")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
    full = get_config(ARCH)
    cfg = reduced(full, dtype="float32", param_dtype="float32")
    return jfull, jcfg, tree, full, cfg, params_from_numpy(tree, device="cpu")


def _jax_engine(setup, **kw):
    jfull, jcfg, tree = setup[:3]
    mem = JaxMemorySystem({"mrm": (JAX_MRM_RRAM, 64 << 30),
                           "hbm": (JAX_HBM3E, 16 << 30)})
    return JaxServeEngine(jcfg, jax.tree.map(jnp.asarray, tree), mem,
                          JaxEngineConfig(**{**ECFG, **kw}), account_cfg=jfull)


def _engine(setup, **kw):
    full, cfg, params = setup[3:]
    mem = MemorySystem({"mrm": (MRM_RRAM, 64 << 30), "hbm": (HBM3E, 16 << 30)})
    return ServeEngine(cfg, params, mem, EngineConfig(**{**ECFG, **kw}),
                       account_cfg=full, device="cpu")


def _prompts():
    """A 32-token shared head (two pages) behind every prompt."""
    rng = np.random.default_rng(5)
    head = list(rng.integers(2, 400, 32))
    return [head + list(rng.integers(2, 400, n)) for n in (12, 9, 20)]


def _run(eng, max_new=5):
    """The first prompt alone (publishing the shared prefix), then the
    rest together: hits and a batched decode with two live slots."""
    prompts = _prompts()
    eng.submit(prompts[0], max_new)
    eng.run_until_idle()
    for p in prompts[1:]:
        eng.submit(p, max_new)
    rep = eng.run_until_idle()
    return {k: [int(t) for t in v] for k, v in eng.outputs.items()}, rep


@pytest.fixture(scope="module")
def port_run(setup):
    return _run(_engine(setup, audit_decode_masking=True))


def test_engine_matches_jax_tokens_and_report(setup, port_run):
    jout, jrep = _run(_jax_engine(setup))
    tout, trep = port_run
    assert tout == jout
    assert trep == jrep
    assert trep["finished"] == 3 and trep["prefix"]["compute_hits"] >= 1
    assert trep["prefix"]["snapshot_kind"] == "positional"
    assert trep["seed_copy_bytes"] == trep["snapshot_bytes"] == 0.0
    assert trep["kernel_read_bytes"] > 0


def test_prefix_hit_matches_cold_start(setup, port_run):
    hit_out, rep = port_run
    cold_out, cold = _run(_engine(setup, prefix_caching=False))
    assert hit_out == cold_out
    assert rep["prefix"]["compute_hits"] >= 1
    assert cold["prefix"]["compute_hits"] == 0
    assert rep["prefill_tokens_skipped"] > 0
    assert rep["prefill_tokens_computed"] < cold["prefill_tokens_computed"]
    assert rep["seed_copy_bytes"] == cold["seed_copy_bytes"] == 0.0


def test_latent_pool_layout(setup):
    """Every layer's pool is one latent head (P, ps, 2, r + dr), K' then V'
    for each token, stacked over the group's layers."""
    eng = _engine(setup)
    leaves = tree_leaves(eng.backend.paged_caches)
    cfg = setup[4]
    assert len(leaves) == sum(len(g.unit) for g in cfg.scan_groups())
    assert sum(a.shape[0] for a in leaves) == cfg.num_layers
    assert all(a.shape[2:] == (16, 2, cfg.kv_lora_rank + cfg.qk_rope_dim)
               for a in leaves)


def test_migrated_latent_pages_serve_a_hit(setup):
    """export_prefix/import_prefix carry every layer's latent pages: the
    receiver splices them and decodes the cold-start tokens."""
    prompts = _prompts()
    donor = _engine(setup)
    donor.submit(prompts[0], 5)
    donor.run_until_idle()
    exp = donor.export_prefix(donor.radix_key_for(prompts[1]))
    assert exp["n_tokens"] == 32
    recv = _engine(setup)
    imp = recv.import_prefix(exp["tokens"], hot=exp["hot"], hits=exp["hits"],
                             page_data=exp["page_data"],
                             page_tokens=exp["page_tokens"])
    assert imp["new_tokens"] == 32
    recv.submit(prompts[1], 5)
    rep = recv.run_until_idle()
    cold = _engine(setup, prefix_caching=False)
    cold.submit(prompts[1], 5)
    cold.run_until_idle()
    assert rep["prefix"]["compute_hits"] == 1 and rep["seed_copy_bytes"] == 0.0
    assert recv.outputs[0] == cold.outputs[0]
