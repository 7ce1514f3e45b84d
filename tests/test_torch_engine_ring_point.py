"""The port's ring engine (``paged_kernel=False``) against the JAX ring
engine on the stacks this path newly serves, reduced and in fp32 with the
same weights and prompts at the reference's flags for them
(``tests/test_prefix_compute_multiarch.py``: 2 slots, rings of 96, page
16, 16-token chunks): mamba2-2.7b (SSM), hymba-1.5b (hybrid: 8 meta
tokens, windows of 64) and deepseek-v2-lite-16b (MLA with MoE routing,
the port absorbed where the reference's default expands).

Behind a 48-token shared head, the donor prompt alone, then the first
borrower alone (a point stack recomputes the head once and hangs a point
snapshot on the matched node), then two more together (hits seeded from
that snapshot, chunked prefill interleaved with a batched decode): the
same greedy tokens and the same whole report — tier ledgers,
``seed_copy_bytes``, snapshots published and their bytes, the prefix
counters — with a hit seeded from a point snapshot (SSM, hybrid) or a
positional one (MLA), and the decode audit on.
"""
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
from repro_torch.serving.engine import SnapshotHandle
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ECFG = dict(max_slots=2, max_cache_len=96, weight_tier="hbm", kv_tier="mrm",
            eos_token=-1, chunk_tokens=16, page_tokens=16, paged_kernel=False)
KIND = {"mamba2-2.7b": "point", "hymba-1.5b": "point",
        "deepseek-v2-lite-16b": "positional"}


def _prompts():
    rng = np.random.default_rng(21)
    shared = rng.integers(2, 400, 48).tolist()
    return [shared + rng.integers(2, 400, 8).tolist() for _ in range(4)]


def _run(eng):
    prompts = _prompts()
    for p in prompts[:2]:
        eng.submit(p, 6)
        eng.run_until_idle()
    for p in prompts[2:]:
        eng.submit(p, 6)
    rep = eng.run_until_idle()
    return {k: [int(t) for t in v] for k, v in eng.outputs.items()}, rep


@pytest.mark.parametrize("arch", sorted(KIND))
def test_ring_engine_matches_jax(arch):
    jfull = jax_get_config(arch)
    jcfg = jax_reduced(jfull, dtype="float32", param_dtype="float32")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
    jmem = JaxMemorySystem({"mrm": (JAX_MRM_RRAM, 64 << 30), "hbm": (JAX_HBM3E, 16 << 30)})
    jout, jrep = _run(JaxServeEngine(jcfg, jax.tree.map(jnp.asarray, tree), jmem,
                                     JaxEngineConfig(**ECFG), account_cfg=jfull))
    full = get_config(arch)
    mem = MemorySystem({"mrm": (MRM_RRAM, 64 << 30), "hbm": (HBM3E, 16 << 30)})
    eng = ServeEngine(reduced(full, dtype="float32", param_dtype="float32"),
                      params_from_numpy(tree, device="cpu"), mem,
                      EngineConfig(**ECFG, audit_decode_masking=True),
                      account_cfg=full, device="cpu")
    tout, trep = _run(eng)
    assert tout == jout
    assert trep == jrep
    assert trep["finished"] == 4 and trep["prefix"]["snapshot_kind"] == KIND[arch]
    assert trep["prefix"]["compute_hits"] >= 1 and trep["seed_copy_bytes"] > 0
    assert trep["kernel_read_bytes"] == 0.0 and trep["snapshot_bytes"] > 0
    kinds = {n.payload.kind for n in eng.kv.radix.nodes()
             if isinstance(n.payload, SnapshotHandle) and n.payload.live}
    assert kinds == {KIND[arch]}
