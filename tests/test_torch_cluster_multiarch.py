"""Cross-replica migration of the non-attention payloads on port engines:
the port's counterpart of ``tests/test_prefix_compute_multiarch.py::
test_migrated_hit_decodes_identically_non_attention`` for reduced
mamba2-2.7b (SSM: point snapshots on the ring path, state pages on the
paged plane) and deepseek-v2-lite-16b (MLA: positional latent rings,
latent pages), float32, page and chunk 16, on the ring path and the paged
plane (hymba-1.5b, the hybrid, in ``test_torch_cluster_hybrid.py``: one
file of all three takes ~95 s, and the suite runs a file on one worker).

A 48-token shared head alone, then three prompts behind it, each on its
own session key, through a two-replica ``ClusterFrontend`` with
``migrate_prefixes=True`` and ``migrate_load_gap=-1``: the fan-out crosses
replicas as migrated hits, a replica other than the head's skips prefill
tokens, and the port's fleet decodes exactly the JAX fleet's tokens (with
its report and trace digest) and a cold port engine's tokens.
"""
import jax
import numpy as np
import pytest

import repro.serving as jax_serving
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.memclass import HBM3E as JAX_HBM3E
from repro.core.memclass import MRM_RRAM as JAX_MRM_RRAM
from repro.core.simulator import MemorySystem as JaxMemorySystem
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.memclass import HBM3E, MRM_RRAM
from repro_torch.core.simulator import MemorySystem
from repro_torch.models.param import params_from_numpy
from repro_torch.serving import ClusterFrontend, EngineConfig, ServeEngine
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

NON_ATTENTION = ["mamba2-2.7b", "deepseek-v2-lite-16b"]
ECFG = dict(max_slots=2, max_cache_len=96, weight_tier="hbm", kv_tier="mrm",
            eos_token=-1, chunk_tokens=16, page_tokens=16)


def setup_for(arch):
    """The JAX package's reduced float32 config and weights, and the port's
    on the same weights."""
    jfull = jax_get_config(arch)
    jcfg = jax_reduced(jfull, dtype="float32", param_dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))
    full = get_config(arch)
    cfg = reduced(full, dtype="float32", param_dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return {"jax": (jfull, jcfg, jparams), "torch": (full, cfg, params)}


@pytest.fixture(scope="module", params=NON_ATTENTION)
def arch_setup(request):
    return setup_for(request.param)


def _engine(side, setup, **kw):
    full, cfg, params = setup[side]
    if side == "jax":
        mem = JaxMemorySystem({"mrm": (JAX_MRM_RRAM, 64 << 30),
                               "hbm": (JAX_HBM3E, 16 << 30)})
        return jax_serving.ServeEngine(cfg, params, mem,
                                       jax_serving.EngineConfig(**{**ECFG, **kw}),
                                       account_cfg=full)
    mem = MemorySystem({"mrm": (MRM_RRAM, 64 << 30), "hbm": (HBM3E, 16 << 30)})
    return ServeEngine(cfg, params, mem, EngineConfig(**{**ECFG, **kw}),
                       account_cfg=full, device="cpu")


def _prompts():
    rng = np.random.default_rng(17)
    shared = list(rng.integers(2, 400, 48))
    # the seed prompt IS the shared head: its end-boundary snapshot then
    # sits exactly where the fan-out matches — required for point stacks
    return [list(shared)] + [shared + list(rng.integers(2, 400, 8)) for _ in range(3)]


def _fleet(side, setup, paged):
    FE = jax_serving.ClusterFrontend if side == "jax" else ClusterFrontend
    fe = FE([_engine(side, setup, paged_kernel=paged) for _ in range(2)],
            migrate_prefixes=True, migrate_load_gap=-1, record_trace=True)
    rids = []
    for i, p in enumerate(_prompts()):
        rids.append(fe.submit(list(p), 6, session_key=f"u{i}"))
        fe.run_until_idle()
    return fe, rids, fe.run_until_idle()


def check_migrated_hit(arch_setup, paged):
    """The fan-out crossed replicas as migrated hits that skipped prefill;
    the port's fleet equals the JAX fleet and a cold port engine."""
    fe, rids, rep = _fleet("torch", arch_setup, paged)
    assert len({fe.replica_of(r) for r in rids}) == 2
    assert sum(e.kv.prefix_hits_migrated for e in fe.engines) >= 1
    home = fe.replica_of(rids[0])
    assert fe.engines[1 - home].prefill_tokens_skipped > 0
    tokens = [[int(t) for t in fe.output(r)] for r in rids]

    jfe, jrids, jrep = _fleet("jax", arch_setup, paged)
    assert tokens == [[int(t) for t in jfe.output(r)] for r in jrids]
    assert rep == jrep
    assert fe.trace.digest() == jfe.trace.digest()

    cold = _engine("torch", arch_setup, paged_kernel=paged, prefix_caching=False)
    for p in _prompts():
        cold.submit(list(p), 6)
        cold.run_until_idle()
    assert tokens == [[int(t) for t in cold.outputs[i]] for i in range(4)]


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_migrated_hit_decodes_identically_non_attention(arch_setup, paged):
    check_migrated_hit(arch_setup, paged)
