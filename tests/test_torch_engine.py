"""The port's serving engine (repro_torch.serving) against the JAX engine on
reduced qwen3-8b in fp32, on the paged plane, with the same weights and
prompts: the same greedy tokens and memory-plane report fields; within the
port, a prefix hit decodes the same tokens as a cold start with zero copy
bytes, the decode-masking audit passes, and migrated pages serve a hit.
The engine's entry points refuse to run without a device that exists, and
the ring path serves an SSM stack."""
import jax
import numpy as np
import pytest
import torch

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

ECFG = dict(max_slots=2, max_cache_len=96, weight_tier="hbm", kv_tier="mrm",
            eos_token=-1, chunk_tokens=16, page_tokens=16,
            radix_hot_threshold=2, paged_kernel=True)


@pytest.fixture(scope="module")
def setup():
    jfull = jax_get_config("qwen3-8b")
    jcfg = jax_reduced(jfull, dtype="float32", param_dtype="float32")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
    full = get_config("qwen3-8b")
    cfg = reduced(full, dtype="float32", param_dtype="float32")
    return jfull, jcfg, tree, full, cfg, params_from_numpy(tree, device="cpu")


def _jax_engine(setup, **kw):
    jfull, jcfg, tree = setup[:3]
    mem = JaxMemorySystem({"mrm": (JAX_MRM_RRAM, 64 << 30),
                           "hbm": (JAX_HBM3E, 16 << 30)})
    return JaxServeEngine(jcfg, jax.tree.map(jax.numpy.asarray, tree), mem,
                          JaxEngineConfig(**{**ECFG, **kw}), account_cfg=jfull)


def _engine(setup, **kw):
    full, cfg, params = setup[3:]
    mem = MemorySystem({"mrm": (MRM_RRAM, 64 << 30), "hbm": (HBM3E, 16 << 30)})
    return ServeEngine(cfg, params, mem, EngineConfig(**{**ECFG, **kw}),
                       account_cfg=full, device="cpu")


def _prompts():
    """A 37-token shared head (two 16-token pages plus a 5-token sub-page
    tail) behind every prompt."""
    rng = np.random.default_rng(5)
    head = list(rng.integers(2, 400, 37))
    return [head + list(rng.integers(2, 400, n)) for n in (12, 9, 4)]


def _run(eng, prompts, max_new=5):
    """The first prompt alone (publishing the shared prefix), then the
    rest together: hits and a batched decode with two live slots."""
    eng.submit(prompts[0], max_new)
    eng.run_until_idle()
    for p in prompts[1:]:
        eng.submit(p, max_new)
    rep = eng.run_until_idle()
    return {k: list(v) for k, v in eng.outputs.items()}, rep


def _tier_bytes(eng):
    return {n: (d.stats.read_bytes, d.stats.write_bytes)
            for n, d in eng.mem.devices.items()}


def test_engine_matches_jax_tokens_and_report(setup):
    prompts = _prompts()
    jeng = _jax_engine(setup)
    jout, jrep = _run(jeng, prompts)
    teng = _engine(setup, audit_decode_masking=True)
    tout, trep = _run(teng, prompts)

    assert tout == jout
    assert trep["finished"] == jrep["finished"] == 3
    assert trep["kernel_read_bytes"] == jrep["kernel_read_bytes"] > 0
    assert _tier_bytes(teng) == _tier_bytes(jeng)
    assert trep["prefix"]["compute_hits"] == jrep["prefix"]["compute_hits"] >= 1
    assert trep["prefill_tokens_skipped"] == jrep["prefill_tokens_skipped"] > 0
    assert teng.kv.tail_copy_bytes == jeng.kv.tail_copy_bytes > 0
    assert trep["seed_copy_bytes"] == jrep["seed_copy_bytes"] == 0.0
    assert trep["snapshot_bytes"] == jrep["snapshot_bytes"] == 0.0
    assert trep["prefix"]["snapshot_bytes"] == 0.0


def test_prefix_hit_matches_cold_start(setup):
    prompts = _prompts()
    hit_out, rep = _run(_engine(setup), prompts)
    cold_out, cold = _run(_engine(setup, prefix_caching=False), prompts)
    assert hit_out == cold_out
    assert rep["prefix"]["compute_hits"] >= 1 and cold["prefix"]["compute_hits"] == 0
    assert rep["prefill_tokens_computed"] < cold["prefill_tokens_computed"]


def test_migrated_pages_serve_a_hit(setup):
    """export_prefix/import_prefix between two port engines: the receiver
    splices the migrated pages and decodes the cold-start tokens."""
    prompts = _prompts()
    donor = _engine(setup)
    donor.submit(prompts[0], 5)
    donor.run_until_idle()
    exp = donor.export_prefix(donor.radix_key_for(prompts[1]))
    assert exp["page_data"] and exp["n_tokens"] == 32
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
    assert rep["prefix"]["compute_hits"] == 1
    assert recv.outputs[0] == cold.outputs[0]


def test_engine_refuses_missing_device_and_unported_paths(setup, monkeypatch):
    full, cfg, params = setup[3:]
    mem = MemorySystem({"mrm": (MRM_RRAM, 64 << 30), "hbm": (HBM3E, 16 << 30)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, params, mem, EngineConfig(**ECFG), account_cfg=full)
    # the ring path serves an SSM stack too: it decodes the paged plane's tokens
    from repro_torch.models import init_params
    ssm = reduced(get_config("mamba2-2.7b"), dtype="float32", param_dtype="float32")
    ssm_params = init_params(ssm, 0, device="cpu")
    outs = []
    for paged in (False, True):
        eng = ServeEngine(ssm, ssm_params, MemorySystem({"mrm": (MRM_RRAM, 64 << 30),
                                                         "hbm": (HBM3E, 16 << 30)}),
                          EngineConfig(**{**ECFG, "paged_kernel": paged}),
                          device="cpu")
        eng.submit(list(range(2, 40)), 4)
        eng.run_until_idle()
        outs.append(eng.outputs[0])
    assert outs[0] == outs[1] and len(outs[0]) == 4
    with pytest.raises(NotImplementedError, match="A.8"):
        _engine(setup, inject_rber=1e-6)
