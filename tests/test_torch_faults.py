"""The port's reliability plane (``repro_torch.core.faults`` and the
engine's ``inject_rber`` path) against the JAX package's:

- ``flip_bits`` and ``FaultInjector.corrupt`` on the same seed flip the
  same bits, float32 and bfloat16 (the reference's bfloat16 array is
  ``np.asarray`` of a ``jnp.bfloat16`` array; the port's a torch
  bfloat16 tensor, flipped through its ``int16`` view), with the same
  counters; duplicate flips of one bit cancel as ``np.bitwise_xor.at``
  has them cancel;
- the folded flips written into a pool page in place (the engine's
  device path) equal the reference's copy-out / flip / write-back;
- the three arms of ``benchmarks/serving_sim.py::reliability`` (clean,
  protected with the scrub-threshold clock jump, over-aged without
  refresh) on reduced deepseek-7b in float32, page 16: the port's engine
  decodes the reference engine's tokens and reports the same
  ``reliability`` section in each arm, and the arms keep the
  benchmark's gates.

Every comparison is exact (bits, tokens, counters).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.faults as jax_faults
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.memclass import HBM3E as JAX_HBM3E
from repro.core.memclass import MRM_RRAM as JAX_MRM_RRAM
from repro.core.simulator import MemorySystem as JaxMemorySystem
from repro.models import init_params as jax_init_params
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeEngine as JaxServeEngine
import repro_torch.core.faults as faults
from repro_torch.configs import get_config, reduced
from repro_torch.core.memclass import HBM3E, MRM_RRAM
from repro_torch.core.simulator import MemorySystem
from repro_torch.models.param import params_from_numpy
from repro_torch.serving import EngineConfig, ServeEngine
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)


def _bits_np(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _bits_torch(t):
    iv = t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()
    return iv.view(np.uint16 if t.element_size() == 2 else np.uint32)


def _pair(dtype, shape=(3, 1, 16, 4, 8), seed=0):
    """The same values as a reference array and a port tensor."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        ref = np.asarray(jnp.asarray(x, jnp.bfloat16))
        return ref, torch.from_numpy(x).to(torch.bfloat16)
    return x, torch.from_numpy(x.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_crit,n_bulk", [(5, 9), (0, 40), (40, 0), (3000, 3000)])
def test_flip_bits_equals_reference(dtype, n_crit, n_bulk):
    """Same seed, same flips: the port flips a torch tensor to the
    reference's bits; (3000, 3000) on 1536 words draws many words twice,
    some bits twice."""
    ref_in, tin = _pair(dtype)
    assert np.array_equal(_bits_np(ref_in), _bits_torch(tin))
    ref = jax_faults.flip_bits(ref_in, n_crit, n_bulk, np.random.default_rng(7))
    got = faults.flip_bits(tin, n_crit, n_bulk, np.random.default_rng(7))
    assert got.dtype == tin.dtype and got.shape == tin.shape
    assert np.array_equal(_bits_torch(got), _bits_np(ref))
    assert np.array_equal(_bits_torch(tin), _bits_np(ref_in))   # input untouched


def test_flip_bits_zero_flips_and_duplicates():
    t = torch.arange(16, dtype=torch.float32)
    assert faults.flip_bits(t, 0, 0, np.random.default_rng(0)) is t
    # two flips of one bit cancel: the folded mask of a word is the XOR
    fl = faults.draw_flips(1, 4, "float32", 0, 64, np.random.default_rng(1))
    assert fl.idx.tolist() == [0]
    bits = np.random.default_rng(1)
    bits.integers(0, 1, 64)
    expect = np.bitwise_xor.reduce(np.ones(1, np.uint32)
                                   << bits.integers(0, 23, 64).astype(np.uint32))
    assert int(fl.mask[0]) == int(expect)


def _mems(ecc_profile="domain"):
    out = []
    for MS, M in ((JaxMemorySystem, JAX_MRM_RRAM), (MemorySystem, MRM_RRAM)):
        mem = MS({"mrm": (M, 1 << 30)}, ecc_profile=ecc_profile)
        rid = mem.write_region("mrm", "kv:test", 1 << 20, expected_lifetime_s=600.0)
        out.append((mem, mem.region(rid)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("age,protected,ecc", [
    (0.0, True, "domain"),        # fresh, protected: nothing lands
    (0.9, True, "domain"),        # aged inside protection
    (10.0, True, "domain"),       # over-aged: uncorrectable blocks
    (1.0, False, "off"),          # unprotected: every flip lands
])
def test_injector_corrupt_equals_reference(dtype, age, protected, ecc):
    (jmem, jr), (tmem, tr) = _mems(ecc)
    jinj = jax_faults.FaultInjector(jmem, 1e-2, seed=3)
    tinj = faults.FaultInjector(tmem, 1e-2, seed=3)
    for mem, r in ((jmem, jr), (tmem, tr)):
        mem.now = r.written_at + age * r.retention_s
    for visit in range(3):
        ref_in, tin = _pair(dtype, seed=visit)
        ref, jbad = jinj.corrupt(ref_in, jr, protected)
        got, tbad = tinj.corrupt(tin, tr, protected)
        assert tbad == jbad
        assert (got is None) == (ref is None)
        if ref is not None:
            assert np.array_equal(_bits_torch(got), _bits_np(ref))
    assert tinj.stats.as_dict() == jinj.stats.as_dict()
    assert tinj.page_rber(tr) == jinj.page_rber(jr)


def test_injector_skips_unfloatable_dtypes():
    (_, _), (tmem, tr) = _mems()
    inj = faults.FaultInjector(tmem, 1e-3, seed=0)
    assert inj.corrupt(torch.zeros(8, dtype=torch.int8), tr, False) == (None, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flips_scattered_into_a_pool_page_equal_a_flipped_copy(dtype):
    """The engine's path: one page ``pid`` of a (R, P, ...) pool, flips
    drawn from its geometry and XORed into only the flipped words in
    place, equals flipping the exported (R, 1, ...) page copy; the other
    pages stay as they were."""
    pool = torch.randn(3, 6, 16, 4, 8).to(dtype)
    before = pool.clone()
    pid = 4
    name = str(dtype).removeprefix("torch.")
    fl = faults.draw_flips(pool[:, pid].numel(), pool.element_size(), name, 200,
                           900, np.random.default_rng(5))
    expect = faults.apply_flips(pool[:, pid:pid + 1].clone(), fl)
    faults.xor_words_(pool[:, pid], fl)
    assert torch.equal(_as_bits(pool[:, pid:pid + 1]), _as_bits(expect))
    keep = [p for p in range(6) if p != pid]
    assert torch.equal(_as_bits(pool[:, keep]), _as_bits(before[:, keep]))
    assert not torch.equal(_as_bits(pool), _as_bits(before))


def _as_bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


# ---------------------------------------------------------------------------
# the three reliability arms, port engine against reference engine
# ---------------------------------------------------------------------------

RBER, SESSION_S, MAX_NEW = 1e-3, 600.0, 6
RETENTION_S = 2.0 * SESSION_S            # pages are programmed at 2x session
DEADLINE_S = RETENTION_S / 2.0
ARMS = {"clean": (None, True, 0.8 * DEADLINE_S),
        "protected": (RBER, True, 0.8 * DEADLINE_S),
        "overaged": (RBER, False, 4.0 * RETENTION_S)}


def _run_arm(make_engine, prompts, arm):
    inject, refresh, age_jump = ARMS[arm]
    eng = make_engine(inject, refresh)
    for p in prompts:
        eng.submit(list(p), MAX_NEW)
    steps = 0
    while not eng.sched.idle and eng.tokens_generated < 2 and steps < 500:
        eng.step()
        steps += 1
    eng.mem.advance(age_jump)
    rep = eng.run_until_idle()
    return eng, rep, {k: [int(t) for t in v] for k, v in eng.outputs.items()}


@pytest.fixture(scope="module")
def arms():
    """Each arm run on the reference engine and the port's: the
    benchmark's prompts (3 x (32-token head + 8)), engine settings and
    clock jumps."""
    jfull = jax_get_config("deepseek-7b")
    jcfg = jax_reduced(jfull, dtype="float32", param_dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))
    full = get_config("deepseek-7b")
    cfg = reduced(full, dtype="float32", param_dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    head = list(rng.integers(2, cfg.vocab_size, 32))
    prompts = [head + list(rng.integers(2, cfg.vocab_size, 8)) for _ in range(3)]
    ecfg = dict(max_slots=2, max_cache_len=96, weight_tier="hbm", kv_tier="mrm",
                eos_token=-1, chunk_tokens=16, page_tokens=16, tail_copy=False,
                paged_kernel=True, expected_session_s=SESSION_S, inject_seed=0)

    def jax_engine(inject, refresh):
        mem = JaxMemorySystem({"mrm": (JAX_MRM_RRAM, 1 << 40), "hbm": (JAX_HBM3E, 1 << 37)},
                              ecc_profile="domain", service_refresh=refresh)
        return JaxServeEngine(jcfg, jparams, mem,
                              JaxEngineConfig(**ecfg, inject_rber=inject),
                              account_cfg=jfull)

    def torch_engine(inject, refresh):
        mem = MemorySystem({"mrm": (MRM_RRAM, 1 << 40), "hbm": (HBM3E, 1 << 37)},
                           ecc_profile="domain", service_refresh=refresh)
        return ServeEngine(cfg, params, mem, EngineConfig(**ecfg, inject_rber=inject),
                           account_cfg=full, device="cpu")

    return {arm: {"jax": _run_arm(jax_engine, prompts, arm),
                  "torch": _run_arm(torch_engine, prompts, arm)} for arm in ARMS}


def _match(a, b):
    total = hits = 0
    for k, toks in a.items():
        other = b.get(k, [])
        total += max(len(toks), len(other))
        hits += sum(1 for x, y in zip(toks, other) if x == y)
    return hits / max(total, 1)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_reliability_arm_equals_reference(arms, arm):
    (jeng, jrep, jout), (teng, trep, tout) = arms[arm]["jax"], arms[arm]["torch"]
    assert tout == jout
    assert trep["reliability"] == jrep["reliability"]
    assert trep["tokens_generated"] == jrep["tokens_generated"] == 3 * MAX_NEW
    assert (teng.kv.lifecycle.stats.scrubbed_pages
            == jeng.kv.lifecycle.stats.scrubbed_pages)
    if arm != "clean":
        assert trep["reliability"]["injection"]["pages_visited"] > 0
    else:
        assert "injection" not in trep["reliability"]


def test_reliability_arms_keep_the_benchmark_gates(arms):
    clean = arms["clean"]["torch"][2]
    eng_p, prot, prot_out = arms["protected"]["torch"]
    _, over, over_out = arms["overaged"]["torch"]
    prot_match, over_match = _match(clean, prot_out), _match(clean, over_out)
    assert prot_match >= 0.95
    assert prot["reliability"]["injection"]["uncorrectable_blocks"] == 0
    assert eng_p.kv.lifecycle.stats.scrubbed_pages > 0
    assert prot["reliability"]["tiers"]["mrm"]["scrub_read_bytes"] > 0
    assert over["reliability"]["injection"]["uncorrectable_blocks"] > 0
    assert over_match < prot_match and over_match <= 0.9
