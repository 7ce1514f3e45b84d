#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on this machine's card.

    python3 bench/run.py --workload mamba2.chat --seed 12345 --seconds 50 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` (and
with ``--trace 1`` the device ``breakdown``), and last ``check``: each
number compared with its limit, also the last lines of standard error.
Exits non-zero, printing no result, without a CUDA card (or with fewer
cards than the cell asks for), without the program's sources, or if
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` was loaded.
Every cache the run writes lies under ``build/`` in this checkout. The
process starts itself again with ``PYTHONHASHSEED=0``, so that every run
iterates its sets of strings in one order; set-up counts from the first
start.
"""
import os
import sys
import time

T_START = time.perf_counter()      # CLOCK_MONOTONIC: it holds across exec
if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    os.environ["PYTHONHASHSEED"] = "0"
    os.environ["BENCH_PROCESS_START"] = repr(T_START)
    os.execv(sys.executable, [sys.executable, *sys.argv])
T_START = float(os.environ.pop("BENCH_PROCESS_START", T_START))

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
        (cache / sub).mkdir(parents=True, exist_ok=True)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from bench import harness
    cell = harness.load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip() or torch.cuda.get_device_name(0)}", flush=True)

    run, check, dev, _, _ = harness.run_cell(cell, args.seed, args.seconds,
                                             bool(args.trace), "cuda", T_START, log=log)
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {', '.join(bad)}: the benchmark may load neither "
            "JAX nor the JAX package")
        return 3

    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = harness.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = {"max_logit_gap": {"value": check["max_logit_gap"], "limit": check["limit"]}}
    out = {"correct": check["correct"], "attempted": len(run.finished),
           "failed": check.get("failed_requests", 0) if run.finished else 0,
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        out["breakdown"] = run.trace["breakdown"]
    out["check"] = compared
    log(f"window {run.window_s:.3f} s, {run.counters['steps']} steps, "
        f"{run.tokens_out} tokens out, {len(run.finished)} requests finished; "
        f"set-up {run.setup_s:.3f} s; reference {check.get('reference_s', 0):.1f} s "
        f"over {check['requests']} requests on {check.get('slots', 0)} slots, "
        f"{check['served_tokens']} served tokens")
    log(f"check max_logit_gap {check['max_logit_gap']} limit {check['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
