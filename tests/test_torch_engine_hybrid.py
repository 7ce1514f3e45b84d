"""The port's serving engine on a hybrid stack: reduced hymba-1.5b in fp32
(8 meta tokens; attention and SSD halves in every layer, KV and state pages
under one table) against the JAX engine with the same weights and prompts.
At page 16 the meta tokens and every first chunk fit in page 0 and the port
equals the JAX paged engine: tokens and the whole report. At pages 4 and 8
the first chunk spans pages, where the reference's paged path drops the SSM
state (ROADMAP §C.5): the port decodes the JAX ring engine's tokens. Within
the port, a prefix hit decodes a cold start's tokens, chunked prefill the
whole prompt's, hits never read a meta page's unwritten state slot, and
migrated union pages serve a hit."""
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
from repro_torch.serving import EngineConfig, ServeEngine
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

# chunk_tokens None: one maximal chunk per prompt, cut on the page grid
ECFG = dict(max_slots=2, max_cache_len=96, weight_tier="hbm", kv_tier="mrm",
            eos_token=-1, chunk_tokens=None, page_tokens=16,
            radix_hot_threshold=2, paged_kernel=True)


@pytest.fixture(scope="module")
def setup():
    jfull = jax_get_config("hymba-1.5b")
    jcfg = jax_reduced(jfull, dtype="float32", param_dtype="float32")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
    full = get_config("hymba-1.5b")
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
    """A 37-token shared head behind every prompt: in position space (8
    meta tokens first) it ends at 45, so hits resume from the state page
    at a page boundary."""
    rng = np.random.default_rng(5)
    head = list(rng.integers(2, 400, 37))
    return [head + list(rng.integers(2, 400, n)) for n in (12, 9, 4)]


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
def port_runs(setup):
    """The port's runs that several tests read: (tokens, report) by name."""
    return {"page16": _run(_engine(setup, audit_decode_masking=True)),
            "page4": _run(_engine(setup, page_tokens=4,
                                  audit_decode_masking=True))}


def test_engine_matches_jax_tokens_and_report(setup, port_runs):
    """At page 16 the 8 meta tokens and every first chunk fit in page 0,
    where the reference's paged path is sound: the same tokens and the
    same report, memory plane and byte ledgers included."""
    jout, jrep = _run(_jax_engine(setup))
    tout, trep = port_runs["page16"]
    assert tout == jout
    assert trep == jrep
    assert trep["finished"] == 3 and trep["prefix"]["compute_hits"] >= 1
    assert trep["prefix"]["snapshot_kind"] == "point"
    assert trep["seed_copy_bytes"] == trep["snapshot_bytes"] == 0.0
    assert trep["kernel_read_bytes"] > 0


@pytest.mark.parametrize("page", [4, 8])
def test_first_chunk_across_pages_matches_jax_ring_engine(setup, port_runs,
                                                          page):
    """At page <= 8 the first chunk (8 meta tokens + the prompt to the next
    page boundary) spans pages. The port decodes the tokens of the
    reference's ring path (``paged_kernel=False``), which keeps the SSM
    state in a per-slot cache; the reference's paged path drops it
    (ROADMAP §C.5)."""
    tout = (port_runs["page4"] if page == 4
            else _run(_engine(setup, page_tokens=page)))[0]
    ring, _ = _run(_jax_engine(setup, page_tokens=page, paged_kernel=False))
    assert tout == ring
    assert tout == port_runs["page16"][0]


@pytest.mark.parametrize("page", [16, 4])
def test_prefix_hit_matches_cold_start(setup, port_runs, page):
    hit_out, rep = port_runs[f"page{page}"]
    cold_out, cold = _run(_engine(setup, page_tokens=page,
                                  prefix_caching=False))
    assert hit_out == cold_out
    assert rep["prefix"]["compute_hits"] >= 1
    assert cold["prefix"]["compute_hits"] == 0
    assert rep["prefill_tokens_computed"] < cold["prefill_tokens_computed"]


def test_chunked_equals_whole(setup, port_runs):
    """5-token chunks decode the tokens of one maximal chunk per prompt."""
    small, rep = _run(_engine(setup, chunk_tokens=5))
    assert small == port_runs["page16"][0]
    assert rep["prefill_chunks"] > port_runs["page16"][1]["prefill_chunks"]


def test_hits_resume_past_the_meta_pages(setup):
    """At page 4 the meta prefix fills pages 0-1 and no chunk writes their
    state slots. Every first chunk covers positions [0, 12) and writes slot
    2; every later chunk, a hit's first included, starts at or past 12, so
    it reads slot 2 or later, never a meta page's slot."""
    eng = _engine(setup, page_tokens=4)
    seen = []
    run = eng.backend.run_prefill_chunk

    def spy(ck, page_table):
        seen.append((ck.first, ck.offset, len(ck.tokens)))
        return run(ck, page_table)

    eng.backend.run_prefill_chunk = spy
    _, rep = _run(eng)
    assert rep["prefix"]["compute_hits"] >= 1
    firsts = [s for s in seen if s[0]]
    assert firsts and all(o == 8 and n == 4 for _, o, n in firsts)
    later = [(o, n) for first, o, n in seen if not first]
    assert later and all(o >= 12 and o // 4 == (o + n - 1) // 4 for o, n in later)
    # the hits' first chunks: resumed on a page boundary past the meta pages
    assert any(o % 4 == 0 and o > 12 for o, _ in later)


def test_migrated_union_pages_serve_a_hit(setup):
    """export_prefix/import_prefix between two port engines carry the
    union pool (KV, conv and state pages of every layer) as one tree: the
    receiver splices them and decodes the cold-start tokens."""
    prompts = _prompts()
    donor = _engine(setup)
    donor.submit(prompts[0], 5)
    donor.run_until_idle()
    exp = donor.export_prefix(donor.radix_key_for(prompts[1]))
    assert exp["n_tokens"] == 32
    assert len(tree_leaves(exp["page_data"])) == len(
        tree_leaves(donor.backend.paged_caches))
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
