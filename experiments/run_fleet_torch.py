"""Run a fleet scenario on the PyTorch port's event-driven simulator and
gate its SLOs: ``experiments/run_fleet.py`` over ``repro_torch``, the same
flags and gates. ``FleetSim`` is analytic (no tensors), so nothing runs on
a device.

Usage (from the repo root)::

    PYTHONPATH=src python -m experiments.run_fleet_torch --scenario bursty
    PYTHONPATH=src python -m experiments.run_fleet_torch --scenario rag_storm \
        --preset default --seed 3 --json /tmp/fleet.json
    PYTHONPATH=src python -m experiments.run_fleet_torch --all --preset smoke
    PYTHONPATH=src python -m experiments.run_fleet_torch --list

Every run drains the scenario to quiescence (or fails loudly with
``NonQuiescentError``), checks the conservation invariants, enforces the
CI gates — TTFT/ITL p99 present over a non-empty finished population and
a zero pressure-ledger imbalance — and appends the result to
``BENCH_fleet_torch.json`` at the repo root (deduplicated per
scenario+preset), never to the reference's ``BENCH_fleet.json``.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time

from repro_torch.core.trajectory import persist_trajectory
from repro_torch.serving.fleet_sim import FleetSim

from experiments.scenarios_torch import SCENARIOS, build

TRAJECTORY_FILE = "BENCH_fleet_torch.json"


def run_scenario(name: str, preset: str = "smoke", seed: int = 0,
                 max_events: int = 20_000_000) -> dict:
    """Build, run and gate one scenario; returns the trajectory entry."""
    sc = build(name, preset)
    sim = FleetSim(sc.fleet())
    rng = random.Random(seed if seed else sc.seed)
    t0 = time.perf_counter()
    # submit_all lets closed-loop families chain follow-ups off
    # completion times; open-loop families pre-schedule every arrival
    sc.submit_all(sim, rng)
    report = sim.run(max_events=max_events)
    sim.check()
    wall = time.perf_counter() - t0
    entry = {
        "scenario": f"{name}/{preset}",
        "seed": seed if seed else sc.seed,
        "submitted": sim.stats["submitted"],
        "wall_s": round(wall, 3),
        "events_per_s": round(report["trace"]["n_events"] / max(wall, 1e-9)),
        **{k: report[k] for k in ("quiesced", "n_replicas", "sessions",
                                  "slo", "fleet", "replication", "directory",
                                  "fabric", "retention", "pressure",
                                  "trace")},
    }
    gate(entry)
    return entry


def gate(entry: dict) -> None:
    """The fleet-scenarios CI gates: the run must quiesce, report tail
    SLOs over a non-empty finished population, and balance the pressure
    ledger with nothing unresolved."""
    assert entry["quiesced"], f"{entry['scenario']}: did not quiesce"
    slo = entry["slo"]
    for metric in ("ttft", "itl"):
        assert slo[metric]["n"] > 0, \
            f"{entry['scenario']}: no finished sessions for {metric}"
        p99 = slo[metric]["p99"]
        assert p99 == p99 and p99 >= 0.0, \
            f"{entry['scenario']}: bad {metric} p99 {p99!r}"
    assert entry["pressure"]["ledger_imbalance"] == 0, \
        f"{entry['scenario']}: pressure ledger imbalance"
    assert entry["pressure"]["unresolved"] == 0, \
        f"{entry['scenario']}: unresolved pressure events"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=sorted(SCENARIOS),
                    help="scenario family to run")
    ap.add_argument("--preset", default="smoke",
                    help="scenario preset (smoke/default/...; see --list)")
    ap.add_argument("--seed", type=int, default=0,
                    help="scenario RNG seed (0 = the preset's own seed)")
    ap.add_argument("--all", action="store_true",
                    help="run every scenario family at --preset")
    ap.add_argument("--list", action="store_true",
                    help="list scenario families and their presets")
    ap.add_argument("--json", default=None,
                    help="also write the entries to this path")
    ap.add_argument("--max-events", type=int, default=20_000_000,
                    help="event budget before declaring non-quiescence")
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(SCENARIOS):
            presets = SCENARIOS[name].presets()
            print(f"{name}: {', '.join(sorted(presets))}")
        return 0
    if not args.scenario and not args.all:
        ap.error("--scenario, --all or --list required")

    names = sorted(SCENARIOS) if args.all else [args.scenario]
    entries = []
    for name in names:
        entry = run_scenario(name, args.preset, args.seed,
                             max_events=args.max_events)
        entries.append(entry)
        persist_trajectory(TRAJECTORY_FILE, entry, key="scenario",
                           ignore=("at", "wall_s", "events_per_s"))
        s = entry["sessions"]
        print(f"{entry['scenario']}: {s['finished']} finished / "
              f"{s['abandoned']} abandoned of {entry['submitted']} "
              f"({entry['trace']['n_events']} events, {entry['wall_s']}s, "
              f"reuse {entry['fleet']['reuse_frac']:.3f}, "
              f"ttft p99 {entry['slo']['ttft']['p99'] * 1e3:.2f} ms, "
              f"itl p99 {entry['slo']['itl']['p99'] * 1e3:.2f} ms, "
              f"trace {entry['trace']['digest'][:12]})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"entries": entries}, f, indent=1, default=float)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
