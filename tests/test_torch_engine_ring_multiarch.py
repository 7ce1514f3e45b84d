"""Within the port, on the ring path (``paged_kernel=False``), the
invariants the reference holds for its own ring engine
(``tests/test_prefix_compute_multiarch.py``) on the stacks this path newly
serves — mamba2-2.7b (SSM, point snapshots), hymba-1.5b (hybrid, point)
and deepseek-v2-lite-16b (MLA + MoE, positional) — reduced, fp32, at the
reference's engine flags (2 slots, rings of 96, page 16, 16-token chunks):

- ``extend`` after a head prefill equals the whole prompt's prefill, last
  logits and the next decode step within 2e-4 (MoE routing flips on fp32
  reassociation, so deepseek runs with dense MLPs there, as the reference
  does);
- a chunked engine decodes a whole-prompt engine's tokens (point stacks:
  both cut on the page grid);
- a prefix hit decodes a cold start's tokens with compute skipped, and a
  point stack holds a point capture at the shared page boundary;
- a shared head straddling a page boundary decodes the same with tail
  copies on, off, and without prefix caching (positional stacks copy the
  tail; point stacks copy nothing);
- the decode audit runs hot with prefill interleaved, and catches a decode
  that writes an inactive slot's cache in every family (MLA latents, conv
  and SSD state, the hybrid union);
- ring and paged engines decode the same tokens: deepseek (no window) and
  hymba at pages 4, 8 and 16, where the port's paged plane writes a first
  chunk's state to the page of its last position (ROADMAP §C.5).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.memclass import HBM3E, MRM_RRAM
from repro_torch.core.simulator import MemorySystem
from repro_torch.models import transformer as ttfm
from repro_torch.serving import EngineConfig, ServeEngine
from repro_torch.serving.engine import SnapshotHandle
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["mamba2-2.7b", "hymba-1.5b", "deepseek-v2-lite-16b"]
KIND = {"mamba2-2.7b": "point", "hymba-1.5b": "point",
        "deepseek-v2-lite-16b": "positional"}
ECFG = dict(max_slots=2, max_cache_len=96, weight_tier="hbm", kv_tier="mrm",
            eos_token=-1, chunk_tokens=16, page_tokens=16, paged_kernel=False)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    full = get_config(arch)
    cfg = reduced(full, dtype="float32", param_dtype="float32")
    return arch, full, cfg, ttfm.init_params(cfg, 0, device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def arch_setup(request):
    return _setup(request.param)


def _engine(full, cfg, params, **kw):
    mem = MemorySystem({"mrm": (MRM_RRAM, 64 << 30), "hbm": (HBM3E, 16 << 30)})
    return ServeEngine(cfg, params, mem, EngineConfig(**{**ECFG, **kw}),
                       account_cfg=full, device="cpu")


def _outputs(eng):
    return {k: [int(t) for t in v] for k, v in eng.outputs.items()}


def _sequential(eng, prompts, max_new=6):
    for p in prompts:
        eng.submit(list(p), max_new)
        eng.run_until_idle()
    return _outputs(eng)


def test_extend_matches_whole_prompt_logits(arch_setup):
    arch, full, cfg, params = arch_setup
    if cfg.n_experts:
        cfg = reduced(full, dtype="float32", param_dtype="float32", n_experts=0,
                      n_shared_experts=0, moe_top_k=0, expert_d_ff=0,
                      first_dense_layers=0)
        params = ttfm.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(5)
    L, split = 40, 24
    toks = torch.from_numpy(rng.integers(2, 400, (1, L)).astype(np.int64))
    plen = cfg.n_meta_tokens
    kw = dict(max_cache_len=96, page_tokens=16)
    whole, caches_whole = ttfm.prefill(cfg, params, {"tokens": toks}, **kw)
    _, caches = ttfm.prefill(cfg, params, {"tokens": toks[:, :split]}, **kw)
    ext, caches = ttfm.extend(cfg, params, caches, toks[:, split:], plen + split,
                              page_tokens=16)
    np.testing.assert_allclose(ext.numpy(), whole.numpy(), atol=2e-4, rtol=2e-4)
    tok = whole.argmax(-1)[:, None]
    cur = torch.tensor([plen + L])
    d_whole, _ = ttfm.decode(cfg, params, caches_whole, tok, cur, page_tokens=16)
    d_ext, _ = ttfm.decode(cfg, params, caches, tok, cur, page_tokens=16)
    np.testing.assert_allclose(d_ext.numpy(), d_whole.numpy(), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_chunked_engine_equals_whole_prompt_engine(arch):
    """Point stacks only: positional stacks cut prompts differently in the
    two modes, and reassociate the softmax."""
    arch, full, cfg, params = _setup(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 400, n).tolist() for n in (41, 70, 23)]
    outs = []
    for chunk in (16, None):
        eng = _engine(full, cfg, params, chunk_tokens=chunk)
        for p in prompts:
            eng.submit(p, 6)
        assert eng.run_until_idle()["finished"] == len(prompts)
        outs.append(_outputs(eng))
    assert outs[0] == outs[1]


def test_prefix_hit_decodes_identically_to_cold_start(arch_setup):
    arch, full, cfg, params = arch_setup
    rng = np.random.default_rng(21)
    shared = rng.integers(2, 400, 48).tolist()
    prompts = [shared + rng.integers(2, 400, 8).tolist() for _ in range(4)]
    warm = _engine(full, cfg, params)
    hit = _sequential(warm, prompts)
    assert warm.kv.prefix_hits >= 2 and warm.prefill_tokens_skipped > 0
    assert warm.prefix_compute_hits >= 1
    if KIND[arch] == "point":
        plen = warm.backend.prefix_len()
        bounds = {n.payload.tokens for n in warm.kv.radix.nodes()
                  if isinstance(n.payload, SnapshotHandle) and n.payload.live
                  and n.payload.kind == "point"}
        assert ((plen + len(shared)) // 16) * 16 in bounds, bounds
    cold = _engine(full, cfg, params, prefix_caching=False)
    assert _sequential(cold, prompts) == hit
    assert cold.prefill_tokens_skipped == 0


def test_tail_hit_equals_cold_start(arch_setup):
    arch, full, cfg, params = arch_setup
    rng = np.random.default_rng(41)
    head = rng.integers(2, 400, 55).tolist()      # straddles a page boundary
    prompts = [head + rng.integers(2, 400, 9).tolist() for _ in range(4)]
    engines = {name: _engine(full, cfg, params, **kw) for name, kw in (
        ("tail", dict(tail_copy=True)), ("aligned", dict(tail_copy=False)),
        ("cold", dict(prefix_caching=False)))}
    outs = {name: _sequential(eng, prompts) for name, eng in engines.items()}
    assert outs["tail"] == outs["aligned"] == outs["cold"]
    warm, aligned = engines["tail"], engines["aligned"]
    if KIND[arch] == "positional":
        assert warm.kv.tail_hits > 0 and warm.kv.tail_copy_bytes > 0
        assert warm.prefill_tokens_computed < aligned.prefill_tokens_computed
    else:
        assert warm.kv.tail_hits == 0
        assert warm.prefill_tokens_computed == aligned.prefill_tokens_computed


def _interleaved(eng):
    eng.submit(list(range(2, 14)), 20)      # short: decoding soon
    eng.submit(list(range(2, 80)), 4)       # long: its chunks interleave
    saw = False
    while not eng.sched.idle and eng.steps < 200:
        out = eng.step()
        saw |= out["prefill_tokens"] > 0 and out["decode_tokens"] > 0
    return saw


def test_decode_audit_every_family(arch_setup, monkeypatch):
    """The audit runs hot beside an interleaved prefill; a mixer that
    ignores ``decode_active`` writes the mid-prefill slot's rings (MLA
    latents, or conv and SSD state, or both halves of the hybrid union)
    and the audit raises."""
    arch, full, cfg, params = arch_setup
    eng = _engine(full, cfg, params, max_prefills_per_step=1, audit_decode_masking=True)
    assert _interleaved(eng) and eng.sched.stats.finished == 2
    name = {"mamba2-2.7b": "ssm_sublayer", "hymba-1.5b": "hybrid_sublayer",
            "deepseek-v2-lite-16b": "mla_sublayer"}[arch]
    real = getattr(ttfm, name)
    monkeypatch.setattr(ttfm, name,
                        lambda *a, decode_active=None, **kw: real(*a, **kw))
    eng = _engine(full, cfg, params, max_prefills_per_step=1, audit_decode_masking=True)
    with pytest.raises(AssertionError, match="inactive slot"):
        _interleaved(eng)


@pytest.mark.parametrize("arch,page", [("deepseek-v2-lite-16b", 16), ("hymba-1.5b", 16),
                                       ("hymba-1.5b", 8), ("hymba-1.5b", 4)])
def test_ring_and_paged_decode_the_same_tokens(arch, page):
    """A 37-token head behind four prompts (for hymba 8 meta tokens come
    first; at pages 4 and 8 every first chunk spans pages), one maximal
    chunk per prompt for hymba and 16-token chunks for deepseek (no
    window): the first two alone (the second leaves a point capture at its
    match boundary), the last two together. The ring's hits seed from a
    snapshot, the paged ones splice pages."""
    arch, full, cfg, params = _setup(arch)
    rng = np.random.default_rng(5)
    head = rng.integers(2, 400, 37).tolist()
    prompts = [head + rng.integers(2, 400, n).tolist() for n in (12, 9, 4, 7)]
    kw = dict(page_tokens=page, radix_hot_threshold=2)
    if arch == "hymba-1.5b":
        kw["chunk_tokens"] = None
    outs, reps = {}, {}
    for paged in (False, True):
        eng = _engine(full, cfg, params, paged_kernel=paged, **kw)
        _sequential(eng, prompts[:2], 5)
        for p in prompts[2:]:
            eng.submit(p, 5)
        reps[paged] = eng.run_until_idle()
        outs[paged] = _outputs(eng)
    assert outs[False] == outs[True]
    assert reps[False]["prefix"]["compute_hits"] >= 1 <= reps[True]["prefix"]["compute_hits"]
    assert reps[False]["seed_copy_bytes"] > 0 and reps[True]["seed_copy_bytes"] == 0.0
