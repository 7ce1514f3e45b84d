"""The port's serving engine on the three stacks that complete the
reference's model families, reduced and in fp32, against the JAX engine
with the same weights and prompts at the reference's paged-engine flags
(page 16, 16-token chunks):

- mixtral-8x22b: 8 experts top-2, no shared experts, a window of 64 in
  every layer, which the longest prompt (72 tokens) passes;
- musicgen-large: 4 codebooks, so a prompt is (L, 4), a decode token a
  4-tuple and the radix keys (L, 4);
- internvl2-76b: 8 zero patch embeddings in front of every prompt's first
  chunk, so hits resume behind a prefix of 8 positions.

Each gives the JAX engine's greedy tokens and report (memory plane and byte
ledgers included), and a prefix hit decodes a cold start's tokens with zero
copy bytes."""
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
from repro_torch.models.param import params_from_numpy
from repro_torch.serving import EngineConfig, ServeEngine
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("mixtral-8x22b", "musicgen-large", "internvl2-76b")
# the reference's paged-engine flags (tests/test_paged_attention.py)
ECFG = dict(max_slots=2, max_cache_len=96, weight_tier="hbm", kv_tier="mrm",
            eos_token=-1, chunk_tokens=16, page_tokens=16,
            radix_hot_threshold=2, paged_kernel=True)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jfull = jax_get_config(arch)
    jcfg = jax_reduced(jfull, dtype="float32", param_dtype="float32")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
    full = get_config(arch)
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


def _prompts(cfg):
    """A 32-token shared head (two pages) behind every prompt; the last
    prompt is 72 tokens long. Multi-codebook tokens are K-tuples."""
    rng = np.random.default_rng(5)
    tail = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    head = rng.integers(2, 400, (32,) + tail).tolist()
    return [head + rng.integers(2, 400, (n,) + tail).tolist() for n in (12, 9, 40)]


def _run(eng, cfg, max_new=5):
    """The first prompt alone (publishing the shared prefix), then the
    rest together: hits and a batched decode with two live slots."""
    prompts = _prompts(cfg)
    eng.submit(prompts[0], max_new)
    eng.run_until_idle()
    for p in prompts[1:]:
        eng.submit(p, max_new)
    rep = eng.run_until_idle()
    return {k: [int(t) for t in v] for k, v in eng.outputs.items()}, rep


@pytest.fixture(scope="module")
def port_run(setup):
    eng = _engine(setup, audit_decode_masking=True)
    return _run(eng, setup[4]) + (eng,)


def test_engine_matches_jax_tokens_and_report(setup, port_run):
    jout, jrep = _run(_jax_engine(setup), setup[1])
    tout, trep, _ = port_run
    assert tout == jout
    assert trep == jrep
    assert trep["finished"] == 3 and trep["tokens_generated"] == 3 * 5
    assert trep["prefix"]["compute_hits"] >= 1
    assert trep["prefix"]["snapshot_kind"] == "positional"
    assert trep["seed_copy_bytes"] == trep["snapshot_bytes"] == 0.0
    assert trep["kernel_read_bytes"] > 0


def test_prefix_hit_matches_cold_start(setup, port_run):
    hit_out, rep, _ = port_run
    cold_out, cold = _run(_engine(setup, prefix_caching=False), setup[4])
    assert hit_out == cold_out
    assert rep["prefix"]["compute_hits"] >= 1
    assert cold["prefix"]["compute_hits"] == 0
    assert rep["prefill_tokens_skipped"] > 0
    assert rep["prefill_tokens_computed"] < cold["prefill_tokens_computed"]
    assert rep["seed_copy_bytes"] == cold["seed_copy_bytes"] == 0.0


def test_frontend_shapes_in_the_engine(setup, port_run):
    """Codebooks: (B, 1, K) decode tokens and (L, K) radix keys; vision:
    every key starts with the patch prefix; mixtral: the longest prompt
    passes the window of every layer."""
    cfg = setup[4]
    eng = port_run[2]
    prompts = _prompts(cfg)
    key = eng.radix_key_for(prompts[2])
    plen = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    assert eng.backend.prefix_len() == plen
    assert key.shape[0] == plen + 72 and (key[:plen] == -1).all()
    if cfg.n_codebooks > 1:
        assert eng.last_tokens.shape == (ECFG["max_slots"], 1, cfg.n_codebooks)
        assert key.shape[1:] == (cfg.n_codebooks,)
    else:
        assert eng.last_tokens.shape == (ECFG["max_slots"], 1)
    if cfg.name == "mixtral-8x22b":
        assert {s.window for s in cfg.layer_specs()} == {64}
        assert (cfg.n_experts, cfg.moe_top_k, cfg.n_shared_experts) == (4, 2, 0)
