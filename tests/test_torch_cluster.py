"""The port's cluster frontend (``repro_torch.serving.cluster``) over port
engines against the JAX package's over JAX engines, on the CPU:

- the fleet: reduced deepseek-7b on the ring path and reduced qwen3-8b on
  the paged plane, float32, two replicas, ``migrate_prefixes=True`` with
  ``migrate_load_gap=-1`` (any queued owner loses the request), under
  the lockstep and the event clock — the same tokens, the same fleet
  report and the same event-trace digest;
- the port's counterparts of ``tests/test_cluster_directory.py``'s
  migration ledger, predictive replication and event-mode replication
  tests, and of its directory unit tests;
- the page wire: pages a JAX replica exports, imported into a torch
  replica, and the reverse (float32 arrays of the reference's layout
  ``(repeats, P, ps, 2*Hkv, D)``), with the receiver decoding a cold
  engine's tokens.

Every comparison is exact: tokens, reports and digests.
"""
import jax
import numpy as np
import pytest
import torch

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
from repro_torch.models.param import params_from_numpy, tree_map
from repro_torch.serving import (ClusterFrontend, EngineConfig, PrefixDirectory,
                                 ServeEngine)
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ECFG = dict(max_slots=2, max_cache_len=96, weight_tier="hbm", kv_tier="mrm",
            eos_token=-1, chunk_tokens=16, page_tokens=16)


def _setup(arch, dtype="float32"):
    jfull = jax_get_config(arch)
    jcfg = jax_reduced(jfull, dtype=dtype, param_dtype=dtype)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    full = get_config(arch)
    cfg = reduced(full, dtype=dtype, param_dtype=dtype)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return {"jax": (jfull, jcfg, jparams), "torch": (full, cfg, params)}


@pytest.fixture(scope="module")
def models():
    return {"deepseek-7b": _setup("deepseek-7b"), "qwen3-8b": _setup("qwen3-8b")}


@pytest.fixture(scope="module")
def bf16_setup():
    full = get_config("deepseek-7b")
    cfg = reduced(full)
    from repro_torch.models import init_params
    return full, cfg, init_params(cfg, 0, device="cpu")


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


def _fanout():
    """A 48-token shared head alone (it publishes the prefix), then three
    prompts behind it, each run to quiescence before the next."""
    rng = np.random.default_rng(17)
    shared = list(rng.integers(2, 400, 48))
    return [list(shared)] + [shared + list(rng.integers(2, 400, 8)) for _ in range(3)]


def _run_fleet(side, setup, clock, paged):
    FE = jax_serving.ClusterFrontend if side == "jax" else ClusterFrontend
    fe = FE([_engine(side, setup, paged_kernel=paged) for _ in range(2)],
            migrate_prefixes=True, migrate_load_gap=-1, clock_mode=clock,
            record_trace=True)
    rids = []
    for i, p in enumerate(_fanout()):
        rids.append(fe.submit(list(p), 6, session_key=f"u{i}"))
        fe.run_until_idle()
    rep = fe.run_until_idle()
    return fe, rep, [[int(t) for t in fe.output(r)] for r in rids], rids


@pytest.mark.parametrize("clock", ["lockstep", "event"])
@pytest.mark.parametrize("arch,paged", [("deepseek-7b", False), ("qwen3-8b", True)])
def test_fleet_equals_jax_fleet(models, arch, paged, clock):
    setup = models[arch]
    jfe, jrep, jtok, _ = _run_fleet("jax", setup, clock, paged)
    tfe, trep, ttok, rids = _run_fleet("torch", setup, clock, paged)
    assert ttok == jtok
    assert tfe.trace.digest() == jfe.trace.digest()
    assert trep == jrep
    # a migrated hit: the receiver skipped prefill, and decoded a cold
    # engine's tokens
    assert trep["prefix_hits_migrated"] >= 1
    home = tfe.replica_of(rids[0])
    assert tfe.engines[1 - home].prefill_tokens_skipped > 0
    cold = _engine("torch", setup, paged_kernel=paged, prefix_caching=False)
    for p in _fanout():
        cold.submit(list(p), 6)
        cold.run_until_idle()
    assert ttok == [[int(t) for t in cold.outputs[i]] for i in range(4)]
    # ring snapshots ship as host copies: nothing on the receiver aliases
    # the donor's tensors
    if not paged:
        donor_ptrs = {a.data_ptr() for n in tfe.engines[home].kv.radix.nodes()
                      if getattr(n.payload, "live", False)
                      for a in jax.tree.leaves(n.payload.caches)}
        recv_ptrs = {a.data_ptr() for n in tfe.engines[1 - home].kv.radix.nodes()
                     if getattr(n.payload, "live", False)
                     for a in jax.tree.leaves(n.payload.caches)}
        assert recv_ptrs and donor_ptrs.isdisjoint(recv_ptrs)


# ---------------------------------------------------------------------------
# the reference's cluster invariants on port engines
# ---------------------------------------------------------------------------


def _mk(setup, **kw):
    full, cfg, params = setup
    mem = MemorySystem({"mrm": (MRM_RRAM, 64 << 30), "hbm": (HBM3E, 16 << 30)})
    return ServeEngine(cfg, params, mem, EngineConfig(**{**ECFG, **kw}),
                       account_cfg=full, device="cpu")


def test_migration_conserves_pages_and_refcounts(bf16_setup):
    """A forced migration grafts the prefix on the receiver with both
    replicas' ledgers intact: donor pages untouched, receiver pages
    tree-owned, every region released when both trees drain."""
    engines = [_mk(bf16_setup) for _ in range(2)]
    fe = ClusterFrontend(engines, migrate_prefixes=True, migrate_load_gap=-1)
    prompt = list(range(2, 66))
    r0 = fe.submit(list(prompt), 4, session_key="a")
    fe.run_until_idle()
    home = fe.replica_of(r0)
    other = 1 - home
    donor_pages = {id(p) for n in engines[home].kv.radix.nodes() for p in n.pages}
    r1 = fe.submit(list(prompt) + [400], 4, session_key="b")
    assert fe.replica_of(r1) == other
    assert fe.migrations == 1
    assert fe.migration_bytes > 0 and fe.migration_s > 0
    assert engines[other].kv.radix_stats.adopted_pages > 0
    assert {id(p) for n in engines[home].kv.radix.nodes()
            for p in n.pages} == donor_pages
    assert all(p.refcount >= 1 for n in engines[home].kv.radix.nodes()
               for p in n.pages)
    adopted = [p for n in engines[other].kv.radix.nodes() for p in n.pages]
    assert donor_pages.isdisjoint({id(p) for p in adopted})
    fe.run_until_idle()
    assert engines[other].kv.prefix_hits_migrated >= 1
    assert engines[other].sched.stats.migrated_admissions >= 1
    for e in engines:
        e.kv.evict_prefixes()
        assert e.kv.radix.n_nodes() == 0
        assert e.kv.live_pages() == 0
        assert e.mem.devices["mrm"].alloc.utilization == 0.0
    assert fe.directory.lookup(engines[0].radix_key_for(prompt)) == (0, None)


def _replication_sequence(fe, prompt):
    fe.submit(list(prompt), 4, session_key="seed")
    fe.run_until_idle()
    for i, key in enumerate(("h1", "h2", "h3")):
        fe.submit(prompt + [301 + i], 4, session_key=key)
        rep = fe.run_until_idle()
    return rep


def test_predictive_replication_accounting_zero_imbalance(bf16_setup):
    """A speculative push meters its bytes once on the fabric and once
    into the receiver's tier: the fabric ledger equals demand plus
    replication bytes exactly, and the page ledgers still drain."""
    engines = [_mk(bf16_setup) for _ in range(3)]
    fe = ClusterFrontend(engines, migrate_prefixes=True, migrate_load_gap=100,
                         replicate_threshold=2, replicate_copies=2)
    prompt = list(range(2, 66))
    rep = _replication_sequence(fe, prompt)
    home = fe.replica_of(min(fe.requests))
    inter = rep["interconnect"]
    assert fe.replications == inter["replications"] == 2
    assert inter["replication_bytes"] > 0
    assert inter["replicated_tokens"] == 2 * 64
    assert inter["migrations"] == 0
    assert fe.fabric.bytes_total - (fe.migration_bytes
                                    + fe.replication_bytes) == pytest.approx(0.0)
    assert rep["fabric"]["bytes"] == fe.fabric.bytes_total
    key = engines[0].radix_key_for(prompt)
    assert fe.directory.lookup(key) == (64, {0, 1, 2})
    for i, e in enumerate(engines):
        if i != home:
            assert e.kv.radix_stats.adopted_pages > 0
    for e in engines:
        e.kv.evict_prefixes()
        assert e.kv.live_pages() == 0
        assert e.mem.devices["mrm"].alloc.utilization == 0.0
    assert fe.directory.lookup(key) == (0, None)


def test_event_mode_replication_matches_lockstep(bf16_setup):
    """The REPLICATION_PUSH event path delivers the lockstep path's
    copies: the same count, decoded tokens and balanced fabric ledger."""
    def run_one(clock_mode):
        fe = ClusterFrontend([_mk(bf16_setup) for _ in range(3)],
                             migrate_prefixes=True, migrate_load_gap=100,
                             clock_mode=clock_mode, record_trace=True,
                             replicate_threshold=2, replicate_copies=2)
        rep = _replication_sequence(fe, list(range(2, 66)))
        outs = {k: list(fe.output(r)) for k, r in
                zip(("seed", "h1", "h2", "h3"), sorted(fe.requests))}
        return fe, rep, outs

    fe_l, rep_l, outs_l = run_one("lockstep")
    fe_e, rep_e, outs_e = run_one("event")
    assert outs_l == outs_e
    assert fe_e.replications == fe_l.replications == 2
    assert rep_e["interconnect"]["replication_bytes"] == pytest.approx(
        rep_l["interconnect"]["replication_bytes"])
    for fe in (fe_l, fe_e):
        assert fe.fabric.bytes_total == pytest.approx(
            fe.migration_bytes + fe.replication_bytes)
    assert fe_e.trace.n_events > 0


@pytest.mark.parametrize("n_shards", [1, 8])
def test_directory_equals_reference(n_shards):
    """The port's PrefixDirectory and its sharded store answer the
    reference's lookups, counters included, over the same register /
    lookup / invalidate sequence."""
    out = []
    for D in (jax_serving.PrefixDirectory, PrefixDirectory):
        d = D(page_tokens=4, n_shards=n_shards)
        rng = np.random.default_rng(0)
        paths = [list(rng.integers(0, 1000, 16)) for _ in range(60)]
        seen = []
        for i, path in enumerate(paths):
            d.register(i % 4, path)
            seen.append(d.lookup(path[:9]))
        for i, path in enumerate(paths[::2]):
            d.invalidate((2 * i) % 4, path, tail_tokens=8)
            seen.append(d.lookup(path))
        out.append((seen, d.n_entries(), d.shards.shard_counters()))
    assert out[1] == out[0]
    assert out[1][1] > 0


# ---------------------------------------------------------------------------
# the page wire between frameworks
# ---------------------------------------------------------------------------


def _to_torch(data):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), data)


def _to_numpy(data):
    return jax.tree.map(lambda a: a.numpy(), data)


@pytest.mark.parametrize("donor", ["jax", "torch"])
def test_page_wire_between_jax_and_torch_replicas(models, donor):
    """Pages a replica of one framework exports, imported into a replica
    of the other, serve a hit there that decodes a cold engine's tokens;
    the payload is the reference's layout."""
    setup = models["qwen3-8b"]
    recv_side = "torch" if donor == "jax" else "jax"
    prompts = _fanout()
    d = _engine(donor, setup, paged_kernel=True)
    d.submit(prompts[0], 6)
    d.run_until_idle()
    exp = d.export_prefix(d.radix_key_for(prompts[1]))
    assert exp["n_tokens"] == 48
    leaves = jax.tree.leaves(exp["page_data"])
    cfg = setup["torch"][1]
    assert all(tuple(a.shape[1:]) == (3, 16, 2 * cfg.n_kv_heads, cfg.resolved_head_dim)
               for a in leaves)
    page_data = _to_torch(exp["page_data"]) if recv_side == "torch" \
        else _to_numpy(exp["page_data"])
    r = _engine(recv_side, setup, paged_kernel=True)
    imp = r.import_prefix(exp["tokens"], hot=exp["hot"], hits=exp["hits"],
                          page_data=page_data, page_tokens=exp["page_tokens"])
    assert imp["new_tokens"] == 48
    r.submit(prompts[1], 6)
    rep = r.run_until_idle()
    assert rep["prefix"]["compute_hits"] == 1 and rep["prefill_tokens_skipped"] > 0
    cold = _engine(recv_side, setup, paged_kernel=True, prefix_caching=False)
    cold.submit(prompts[1], 6)
    cold.run_until_idle()
    assert [int(t) for t in r.outputs[0]] == [int(t) for t in cold.outputs[0]]
