"""The port's serving engine on an SSM stack: reduced mamba2-2.7b in fp32
on the paged plane (point-state pages), against the JAX engine with the
same weights and prompts — the same greedy tokens, tier byte ledgers,
``kernel_read_bytes``, prefix counters and zero seed-copy / snapshot
bytes — and, within the port, a prefix hit decoding bit-equal to a cold
start and migrated state pages serving a hit."""
import jax
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
from repro_torch.models.param import params_from_numpy, tree_map
from repro_torch.serving import EngineConfig, ServeEngine
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ECFG = dict(max_slots=2, max_cache_len=96, weight_tier="hbm", kv_tier="mrm",
            eos_token=-1, chunk_tokens=24, page_tokens=16,
            radix_hot_threshold=2, paged_kernel=True)


@pytest.fixture(scope="module")
def setup():
    jfull = jax_get_config("mamba2-2.7b")
    jcfg = jax_reduced(jfull, dtype="float32", param_dtype="float32")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
    full = get_config("mamba2-2.7b")
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
    tail, which a point stack cannot reuse) behind every prompt."""
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
    assert trep["prefill_chunks"] == jrep["prefill_chunks"]
    assert trep["kernel_read_bytes"] == jrep["kernel_read_bytes"] > 0
    assert _tier_bytes(teng) == _tier_bytes(jeng)
    assert trep["prefix"]["compute_hits"] == jrep["prefix"]["compute_hits"] >= 1
    # resumption is clamped down to the 32-token page boundary
    assert trep["prefill_tokens_skipped"] == jrep["prefill_tokens_skipped"] == 64
    assert trep["prefix"]["snapshot_kind"] == jrep["prefix"]["snapshot_kind"] == "point"
    assert teng.kv.tail_copy_bytes == jeng.kv.tail_copy_bytes == 0
    assert trep["seed_copy_bytes"] == jrep["seed_copy_bytes"] == 0.0
    assert trep["snapshot_bytes"] == jrep["snapshot_bytes"] == 0.0
    assert teng.kv.state_bytes_page == jeng.kv.state_bytes_page > 0


def test_chunks_lie_on_the_page_grid(setup):
    """Every prefill chunk of a point stack lies within one page, and a
    hit resumes at a page boundary."""
    eng = _engine(setup)
    seen = []
    run = eng.backend.run_prefill_chunk

    def spy(ck, page_table):
        seen.append((ck.offset, len(ck.tokens)))
        return run(ck, page_table)

    eng.backend.run_prefill_chunk = spy
    _run(eng, _prompts())
    pt = ECFG["page_tokens"]
    assert all(o // pt == (o + n - 1) // pt for o, n in seen)
    assert (0, 16) in seen and (32, 16) in seen and (32, 14) in seen


def test_prefix_hit_matches_cold_start(setup):
    prompts = _prompts()
    hit_out, rep = _run(_engine(setup), prompts)
    cold_out, cold = _run(_engine(setup, prefix_caching=False), prompts)
    assert hit_out == cold_out
    assert rep["prefix"]["compute_hits"] >= 1 and cold["prefix"]["compute_hits"] == 0
    assert rep["prefill_tokens_computed"] < cold["prefill_tokens_computed"]


def test_migrated_state_pages_serve_a_hit(setup):
    """export_prefix/import_prefix between two port engines carry conv and
    state pages: the receiver splices them and decodes the cold-start
    tokens; foreign page geometry or mangled state leaves are refused
    before adoption."""
    prompts = _prompts()
    donor = _engine(setup)
    donor.submit(prompts[0], 5)
    donor.run_until_idle()
    key = donor.radix_key_for(prompts[1])
    exp = donor.export_prefix(key)
    assert exp["page_data"] and exp["n_tokens"] == 32
    assert exp["kv_bytes"] == 2 * donor.kv.state_bytes_page > 0
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
    assert rep["seed_copy_bytes"] == 0.0
    assert recv.outputs[0] == cold.outputs[0]

    other = _engine(setup)
    bad = other.import_prefix(exp["tokens"], page_data=exp["page_data"],
                              page_tokens=exp["page_tokens"] * 2)
    assert bad["total_tokens"] == 0
    mangled = tree_map(lambda a: a[..., :-1], exp["page_data"])
    bad = other.import_prefix(exp["tokens"], page_data=mangled,
                              page_tokens=exp["page_tokens"])
    assert bad["total_tokens"] == 0
    assert other.kv.radix.match(key, other.mem.now).tokens == 0
