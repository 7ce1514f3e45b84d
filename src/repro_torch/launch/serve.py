"""Serving driver for the PyTorch port: a reduced model computes real
tokens on the device (default ``cuda``) while the MRM control plane
meters the deployment-size memory system. Same flags and the same JSON
report as ``repro.launch.serve``, plus ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --requests 8 --max-new 16 --shared-prefix-tokens 32

``--arch`` takes the architectures the port registers: ``qwen3-8b``,
``gemma-2b``, ``deepseek-7b``, ``gemma2-27b`` (4096/global windows
alternating, softcaps 50/30, post-norms) and ``llama2-70b`` (dense
attention on KV pages), ``mamba2-2.7b`` (SSM on
point-state pages), ``hymba-1.5b`` (hybrid: attention and SSM heads in
every layer, KV and state pages under one table, 128 meta tokens),
``deepseek-v2-lite-16b`` (MLA on latent pages, MoE routing),
``mixtral-8x22b`` (MoE of 8 experts top-2, a 4096 window in every layer),
``musicgen-large`` (4 codebooks: a token is a 4-tuple) and
``internvl2-76b`` (256 patch embeddings in front of every prompt).
``--paged-kernel off`` serves every one of them on per-slot ring caches
instead, reading each attention or MLA ring through the paged kernel's
explicit-position mode at ``--page-tokens``-slot pages and carrying SSM
state per slot, with point snapshots for SSM and hybrid prefixes.
With ``--replicas N`` a :class:`~repro_torch.serving.ClusterFrontend`
fans the requests across N engine replicas that share one weight draw
(fleet prefix-directory routing, ``--clock lockstep`` or ``event``, an
aggregated fleet report); ``--migrate-prefixes`` lets the directory move a
hot prefix (pages, or a ring snapshot) to a less-loaded replica.
``--inject-rber`` flips bits in live paged KV/state pages before each
decode round, corrected or not as ``--ecc-profile`` and ``--no-refresh``
say (DESIGN.md §11).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --replicas 2 --migrate-prefixes --clock event --shared-prefix-tokens 32

``--kernel-block-q/--kernel-block-kv/--kernel-buffers`` pin the paged
kernels' launch plan for the page geometry (``kernels/paged_attention/
tune.py``): rows a CTA (16 or 32), page slots a split, cp.async stages;
the plain version on the CPU ignores them.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def build_engine(args, cfg, full, params, device=None, max_cache_len=128):
    """The engine ``main`` serves with: the tiers, the memory system and the
    engine flags from ``args``; ``max_cache_len`` (the JAX launcher's 128)
    bounds a request's positions, and on the ring path sizes the rings."""
    from repro_torch.core.memclass import get_technology
    from repro_torch.core.simulator import MemorySystem
    from repro_torch.serving import EngineConfig, ServeEngine

    tiers = {"hbm": (get_technology("hbm3e"), int(args.hbm_gb * 2**30))}
    for t in {args.weight_tier, args.kv_tier} - {"hbm"}:
        tiers[t] = (get_technology(t), int(args.mrm_gb * 2**30))
    if args.spill_tier and args.spill_tier not in tiers:
        tiers[args.spill_tier] = (get_technology(args.spill_tier),
                                  int(args.mrm_gb * 2**30))
    mem = MemorySystem(tiers, ecc_profile=args.ecc_profile,
                       service_refresh=not args.no_refresh)
    return ServeEngine(
        cfg, params, mem,
        EngineConfig(max_slots=args.slots, max_cache_len=max_cache_len,
                     weight_tier=args.weight_tier, kv_tier=args.kv_tier,
                     page_tokens=args.page_tokens,
                     expected_session_s=args.session_s,
                     chunk_tokens=args.chunk_tokens,
                     kv_pressure_policy=args.kv_policy,
                     kv_spill_tier=args.spill_tier,
                     prefix_caching=not args.no_prefix_caching,
                     tail_copy=args.tail_copy == "on",
                     paged_kernel=args.paged_kernel == "on",
                     kernel_block_q=args.kernel_block_q,
                     kernel_block_kv=args.kernel_block_kv,
                     kernel_buffers=args.kernel_buffers,
                     radix_hot_threshold=args.radix_hot_threshold,
                     radix_hot_tier=args.radix_hot_tier,
                     radix_cold_ttl_s=args.radix_cold_ttl,
                     demote_on_pressure=args.demote_on_pressure,
                     inject_rber=args.inject_rber,
                     inject_seed=args.seed,
                     abandon_after_s=args.abandon_after),
        account_cfg=full, device=device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    help="architecture: qwen3-8b, gemma-2b, deepseek-7b, "
                         "gemma2-27b, llama2-70b, mamba2-2.7b, hymba-1.5b, "
                         "deepseek-v2-lite-16b, mixtral-8x22b, musicgen-large "
                         "or internvl2-76b")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model computes on ('cuda' raises "
                         "without a card; 'cpu' runs the kernels' plain "
                         "versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--weight-tier", default="mrm_rram")
    ap.add_argument("--kv-tier", default="mrm_rram")
    ap.add_argument("--hbm-gb", type=float, default=64)
    ap.add_argument("--mrm-gb", type=float, default=512)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--session-s", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind a cluster frontend, all on "
                         "one weight draw")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="chunked prefill piece size (None = one maximal "
                         "chunk per prompt on the same unpadded path)")
    ap.add_argument("--kv-policy", default="evict-lru",
                    choices=("none", "evict-lru", "spill", "recompute"))
    ap.add_argument("--spill-tier", default=None,
                    help="colder tier for the 'spill' pressure policy")
    ap.add_argument("--sessions", type=int, default=3,
                    help="distinct session keys for affinity routing")
    ap.add_argument("--page-tokens", type=int, default=32,
                    help="KV page size in tokens (radix match granularity)")
    ap.add_argument("--no-prefix-caching", action="store_true",
                    help="disable the radix prefix tree (cold baseline)")
    ap.add_argument("--paged-kernel", choices=("on", "off"), default="on",
                    help="run extend+decode in place on the paged compute "
                         "plane (DESIGN.md §10); 'off' runs per-slot ring "
                         "caches (attention-only stacks)")
    ap.add_argument("--kernel-block-q", type=int, default=None,
                    help="paged kernel: (token, group-head) rows a CTA holds, "
                         "16 or 32 (fp32: a quarter); default the tuned or "
                         "default plan; ignored on the CPU")
    ap.add_argument("--kernel-block-kv", type=int, default=None,
                    help="paged kernel: page slots a warp's split holds, at "
                         "most (1-32); ignored on the CPU")
    ap.add_argument("--kernel-buffers", type=int, default=None,
                    help="paged kernel: cp.async stages a warp keeps (2-4, as "
                         "shared memory allows); ignored on the CPU")
    ap.add_argument("--tail-copy", choices=("on", "off"), default="on",
                    help="sub-page tail reuse: copy the shared mid-page "
                         "tail into the borrower's page and resume prefill "
                         "from the exact token boundary (DESIGN.md §9)")
    ap.add_argument("--demote-on-pressure", action="store_true",
                    help="under eviction pressure, demote hot prefixes "
                         "back to short retention before leaf eviction")
    ap.add_argument("--shared-prefix-tokens", type=int, default=0,
                    help="generated prompts share a head of this many "
                         "tokens (shared system prompt traffic)")
    ap.add_argument("--radix-hot-threshold", type=int, default=4,
                    help="reuse count promoting a prefix to long retention")
    ap.add_argument("--radix-hot-tier", default=None,
                    help="tier for hot prefixes ('auto' = placement solve)")
    ap.add_argument("--radix-cold-ttl", type=float, default=None,
                    help="idle seconds before a cold prefix leaf decays")
    ap.add_argument("--migrate-prefixes", action="store_true",
                    help="fleet prefix directory migrates a hot prefix to "
                         "a less-loaded replica instead of queueing on the "
                         "owner (metered inter-replica transfer)")
    ap.add_argument("--ecc-profile", choices=("off", "uniform", "domain"),
                    default="off",
                    help="reliability plane (DESIGN.md §11): meter ECC "
                         "check bits per tier")
    ap.add_argument("--inject-rber", type=float, default=None,
                    help="inject age-driven bit flips into paged KV/state "
                         "pages: a page exactly at its programmed retention "
                         "sees this raw bit error rate; correction/scrub "
                         "behavior follows --ecc-profile (DESIGN.md §11)")
    ap.add_argument("--no-refresh", action="store_true",
                    help="disable retention-deadline servicing")
    ap.add_argument("--clock", choices=("lockstep", "event"),
                    default="lockstep",
                    help="cluster clock discipline (DESIGN.md §12): "
                         "'lockstep' advances every replica together each "
                         "frontend step; 'event' drains a priority event "
                         "queue so replicas advance independently")
    ap.add_argument("--abandon-after", type=float, default=None,
                    help="seconds a request may wait queued before the "
                         "scheduler abandons it (None = wait forever)")
    ap.add_argument("--interconnect-gbps", type=float, default=50.0,
                    help="per-replica NIC link bandwidth in GBYTES/s (the "
                         "prefix-migration cost model)")
    ap.add_argument("--fabric-gbps", type=float, default=None,
                    help="shared-fabric bisection bandwidth in GBYTES/s "
                         "(DESIGN.md §13; default: half-bisection, link * "
                         "replicas//2)")
    ap.add_argument("--replicate-threshold", type=int, default=None,
                    help="fleet-wide directory hits after which a prefix "
                         "is speculatively pushed to the least-loaded "
                         "non-owners (default: demand migration only)")
    ap.add_argument("--replicate-copies", type=int, default=1,
                    help="extra owners the predictive replicator maintains "
                         "for a hot prefix")
    ap.add_argument("--directory-shards", type=int, default=8,
                    help="hash shards the fleet prefix directory spreads "
                         "its digest keys across")
    return ap


def make_prompts(cfg, n: int, shared_prefix_tokens: int, seed: int) -> list:
    """``n`` prompts of 8-48 random tokens behind a shared head of
    ``shared_prefix_tokens`` tokens, drawn as ``repro.launch.serve`` draws
    them. With K codebooks a token is a list of K ids in [0, vocab)."""
    rng = np.random.default_rng(seed)
    K = cfg.n_codebooks

    def tokens(m):
        if K > 1:
            return [list(rng.integers(0, cfg.vocab_size, K)) for _ in range(m)]
        return list(rng.integers(2, cfg.vocab_size, m))

    shared_head = tokens(shared_prefix_tokens)
    return [shared_head + tokens(rng.integers(8, 48)) for _ in range(n)]


def build_cluster(args, engines):
    """The cluster frontend ``main`` puts ``engines`` behind, with every
    cluster flag from ``args``."""
    from repro_torch.serving import ClusterFrontend
    return ClusterFrontend(engines,
                           migrate_prefixes=args.migrate_prefixes,
                           interconnect_gbps=args.interconnect_gbps,
                           clock_mode=args.clock,
                           fabric_bisection_gbps=args.fabric_gbps,
                           replicate_threshold=args.replicate_threshold,
                           replicate_copies=args.replicate_copies,
                           directory_shards=args.directory_shards)


def main(argv=None):
    args = parser().parse_args(argv)

    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params

    device = resolve_device(args.device)
    full = get_config(args.arch)
    cfg = reduced(full)
    # one weight draw: every replica computes on the same tensors, which an
    # engine reads and never writes
    params = init_params(cfg, args.seed, device=device)
    engines = [build_engine(args, cfg, full, params, device=device)
               for _ in range(max(args.replicas, 1))]
    prompts = make_prompts(cfg, args.requests, args.shared_prefix_tokens,
                           args.seed)
    if len(engines) == 1:
        eng = engines[0]
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=args.max_new)
        rep = eng.run_until_idle()
    else:
        fe = build_cluster(args, engines)
        for i, prompt in enumerate(prompts):
            fe.submit(prompt, max_new_tokens=args.max_new,
                      session_key=f"session-{i % max(args.sessions, 1)}")
        rep = fe.run_until_idle()
    print(json.dumps(rep, indent=1, default=float))
    return rep


if __name__ == "__main__":
    main()
