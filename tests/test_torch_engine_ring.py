"""The port's ring-cache serving path (``paged_kernel=False``, the JAX
package's default) against the JAX ring engine, reduced and in fp32, with
the same weights and prompts at the reference's engine flags (page 16,
16-token chunks, rings of 96 slots):

- qwen3-8b and gemma2-27b (windows of 64 on alternate layers, so prompts
  of 77-87 tokens wrap the local rings): the same greedy tokens and the
  same report — tier byte ledgers, ``seed_copy_bytes``, snapshots
  published and their bytes, the prefix counters — with a radix hit that
  seeds a slot from a donor's ring snapshot;
- one short case each on mixtral-8x22b (MoE under the window),
  musicgen-large (4 codebooks) and internvl2-76b (the vision prefix);
- within the port, ring and paged engines decode the same tokens on
  stacks with no window (deepseek-7b, qwen3-8b), a hit copying a ring
  snapshot on the ring path (``seed_copy_bytes`` > 0) and nothing on the
  paged plane;
- the decode-masking audit catches a ring write to an inactive slot;
- MLA, SSM and hybrid stacks build ring engines that serve (their whole
  suite: ``tests/test_torch_engine_ring_point.py`` and
  ``tests/test_torch_engine_ring_multiarch.py``), and the launcher serves
  ``--paged-kernel off`` on the CPU for every family.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro_torch.launch.serve as torch_serve
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
from repro_torch.models import attention as tattn
from repro_torch.models.param import params_from_numpy
from repro_torch.serving import EngineConfig, ServeEngine
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ECFG = dict(max_slots=2, max_cache_len=96, weight_tier="hbm", kv_tier="mrm",
            eos_token=-1, chunk_tokens=16, page_tokens=16,
            radix_hot_threshold=2, paged_kernel=False)


def _setup(arch):
    jfull = jax_get_config(arch)
    jcfg = jax_reduced(jfull, dtype="float32", param_dtype="float32")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
    full = get_config(arch)
    cfg = reduced(full, dtype="float32", param_dtype="float32")
    return jfull, jcfg, tree, full, cfg, params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def setups():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _setup(arch)
        return cache[arch]
    return get


def _mem(mod_system, mrm, hbm):
    return mod_system({"mrm": (mrm, 64 << 30), "hbm": (hbm, 16 << 30)})


def _jax_engine(setup, **kw):
    jfull, jcfg, tree = setup[:3]
    return JaxServeEngine(jcfg, jax.tree.map(jnp.asarray, tree),
                          _mem(JaxMemorySystem, JAX_MRM_RRAM, JAX_HBM3E),
                          JaxEngineConfig(**{**ECFG, **kw}), account_cfg=jfull)


def _engine(setup, **kw):
    full, cfg, params = setup[3:]
    return ServeEngine(cfg, params, _mem(MemorySystem, MRM_RRAM, HBM3E),
                       EngineConfig(**{**ECFG, **kw}), account_cfg=full,
                       device="cpu")


def _prompts(cfg, tails, head=37, seed=5):
    """A shared head (two 16-token pages and a 5-token tail) behind every
    prompt; multi-codebook tokens are K-tuples."""
    rng = np.random.default_rng(seed)
    k = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    shared = rng.integers(2, 400, (head,) + k).tolist()
    return [shared + rng.integers(2, 400, (n,) + k).tolist() for n in tails]


def _run(eng, prompts, max_new=4):
    """The first prompt alone (its finished prefill donates a snapshot),
    then the rest together: hits, chunked prefill interleaved with a
    batched decode over two slots."""
    eng.submit(prompts[0], max_new)
    eng.run_until_idle()
    for p in prompts[1:]:
        eng.submit(p, max_new)
    rep = eng.run_until_idle()
    return {k: [np.asarray(t).tolist() for t in v] for k, v in eng.outputs.items()}, rep


# arch: prompt tails behind the 37-token head (the first prompt, 49 tokens,
# fits the smallest ring and donates), new tokens per request
CASES = {
    "qwen3-8b": ((12, 40, 50), 5),
    "gemma2-27b": ((12, 40, 50), 5),
    "mixtral-8x22b": ((12, 30), 3),
    "musicgen-large": ((12, 9), 3),
    "internvl2-76b": ((12, 9), 3),
}


@pytest.mark.parametrize("arch", sorted(CASES))
def test_ring_engine_matches_jax(setups, arch):
    setup = setups(arch)
    tails, max_new = CASES[arch]
    prompts = _prompts(setup[4], tails)
    jout, jrep = _run(_jax_engine(setup), prompts, max_new)
    teng = _engine(setup, audit_decode_masking=True)
    tout, trep = _run(teng, prompts, max_new)
    assert tout == jout
    assert trep == jrep
    assert trep["finished"] == len(prompts)
    assert trep["prefix"]["compute_hits"] >= 1
    assert trep["seed_copy_bytes"] > 0 and trep["kernel_read_bytes"] == 0.0
    assert trep["prefix"]["snapshots_published"] >= 1
    if arch == "gemma2-27b":     # the local rings wrapped: 37 + 50 + 5 > 64
        assert max(map(len, prompts)) + max_new > tattn.cache_len_for(64, 96)


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-8b"])
def test_ring_and_paged_decode_the_same_tokens(setups, arch):
    """The counterpart of the reference's
    ``test_paged_hit_bit_equal_zero_copy_metered``: with no window, the
    ring path, the paged plane and a cold paged start decode the same
    tokens; the ring hit copies a whole snapshot, the paged hit nothing."""
    setup = setups(arch)
    rng = np.random.default_rng(5)
    base = rng.integers(2, 400, 40)
    prompts = [base.tolist(), np.concatenate([base[:32], rng.integers(2, 400, 9)]).tolist()]

    def run(**kw):
        eng = _engine(setup, **kw)
        for p in prompts:
            eng.submit(p, 6)
            eng.run_until_idle()
        return {k: list(v) for k, v in eng.outputs.items()}, eng.report()

    ring, rep_ring = run()
    paged, rep = run(paged_kernel=True)
    cold, _ = run(paged_kernel=True, prefix_caching=False)
    assert ring == paged == cold
    assert rep["prefix"]["compute_hits"] >= 1 and rep_ring["prefix"]["compute_hits"] >= 1
    assert rep_ring["seed_copy_bytes"] > 0 and rep["seed_copy_bytes"] == 0.0
    assert rep_ring["snapshot_bytes"] > 0 and rep["snapshot_bytes"] == 0.0


def test_decode_audit_catches_an_unmasked_ring_write(setups, monkeypatch):
    """With a decode round running beside a mid-prefill slot, an
    ``append_to_cache`` that ignores ``active`` writes the inactive slot's
    rings, and the audit says so."""
    setup = setups("qwen3-8b")
    prompts = _prompts(setup[4], (12, 40))
    real = tattn.append_to_cache
    monkeypatch.setattr(tattn, "append_to_cache",
                        lambda cache, k1, v1, pos, active=None: real(cache, k1, v1, pos))
    with pytest.raises(AssertionError, match="inactive slot"):
        _run(_engine(setup, audit_decode_masking=True), prompts)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-2.7b", "hymba-1.5b"])
def test_ring_path_refuses_mla_ssm_hybrid(setups, arch):
    """Once refused (ROADMAP A.6), now served: the same construction gives
    a ring engine whose rings are the family's, and it decodes the JAX
    ring engine's tokens on one short prompt."""
    setup = setups(arch)
    prompt = _prompts(setup[4], (5,))[0]
    jeng, teng = _jax_engine(setup), _engine(setup)
    leaf_names = {"deepseek-v2-lite-16b": {"ckr", "pos"}, "mamba2-2.7b": {"conv", "state"},
                  "hymba-1.5b": {"attn", "ssm"}}[arch]
    assert set(teng.backend.caches[0][0]) == leaf_names
    for eng in (jeng, teng):
        eng.submit(prompt, 3)
        eng.run_until_idle()
    assert [int(t) for t in teng.outputs[0]] == [int(t) for t in jeng.outputs[0]]


def test_ring_page_size_must_divide_every_ring(setups):
    with pytest.raises(ValueError, match="does not divide"):
        _engine(setups("qwen3-8b"), page_tokens=64)


def test_launcher_serves_ring_path_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rep = torch_serve.main(["--arch", "qwen3-8b", "--device", "cpu",
                                "--paged-kernel", "off", "--requests", "2",
                                "--max-new", "4"])
    assert json.loads(out.getvalue()) == json.loads(json.dumps(rep, default=float))
    assert rep["finished"] == 2 and rep["tokens_generated"] == 8
    assert rep["prefix"]["snapshots_published"] >= 1
    with contextlib.redirect_stdout(io.StringIO()):
        rep = torch_serve.main(["--arch", "mamba2-2.7b", "--device", "cpu",
                                "--paged-kernel", "off", "--requests", "1"])
    assert rep["finished"] == 1 and rep["prefix"]["snapshot_kind"] == "point"
