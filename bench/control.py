#!/usr/bin/env python3
"""The readings a cell's correctness limit is set from, for many seeds in
one process (the benchmark's own runs do not run this):

    python3 bench/control.py --workload mamba2.chat --seconds 20 --seeds 11 12 13
    python3 bench/control.py --workload mamba2.chat --seconds 10 --seeds 14 --fault half_batch

For each seed: a run of the cell (set-up, warm-up, a window of
``--seconds`` at the cell's own load) and its check, whose widest gap of a
served token below the fp32 reference's best logit is the program's
reading; then the control, put in the program's place on the same sampled
prompts and tokens and judged by the same ``harness.compare``: the
reference itself with every matrix product's operands rounded to fp8 e4m3
(per row and per column scales), the precision below the bf16 the
configuration states, serving at each scored position the token it puts
first. Its ``correct`` has to come out false. With ``--fault`` the run
has that fault of ``bench/faults.py`` planted underneath its timed path
(no control then). One JSON line a seed; ``bench/tests`` calls
``readings`` on a tiny configuration on the CPU.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def control_seqs(seqs, control_logits) -> list:
    """The sampled sequences with the control's first choice at each scored
    position as the served tokens (the context stays the program's)."""
    return [dict(s, served=c.argmax(dim=-1).tolist()) for s, c in zip(seqs, control_logits)]


def readings(cell, seed: int, seconds: float, device, port_cfg=None,
             fault: str = None) -> dict:
    from bench import faults, harness
    patch = faults.Patch()
    if fault:
        faults.FAULTS[fault](patch)
    try:
        t0 = time.perf_counter()
        run, check, dev, seqs, params = harness.run_cell(cell, seed, seconds, False, device,
                                                         t0, port_cfg=port_cfg,
                                                         log=lambda *a: None)
    finally:
        patch.undo()
    out = {"seed": seed, "fault": fault, "correct": check["correct"],
           "program_gap": check["max_logit_gap"], "limit": check["limit"],
           "served_tokens": check["served_tokens"], "requests": check["requests"],
           "slots": check.get("slots", 0), "finished": len(run.finished),
           "output_tok_s": run.tokens_out / run.window_s,
           "setup_s": run.setup_s, "memory_peak_bytes": dev["memory_peak_bytes"]}
    if seqs and not fault:
        from repro_torch.configs import get_config
        cfg = port_cfg or get_config(cell.config["arch"])
        lg = harness.reference_logits(cell, cfg, params, seqs, "fp32")
        lg8 = harness.reference_logits(cell, cfg, params, seqs, "fp8")
        ctrl = harness.compare(cell, cfg, params, control_seqs(seqs, lg8), ref_logits=lg)
        out["control_correct"], out["control_gap"] = ctrl["correct"], ctrl["max_logit_gap"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", help="plant this fault of bench/faults.py (FAULTS) "
                                    "underneath the timed path")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import gc

    from bench import faults
    if args.fault and args.fault not in faults.FAULTS:
        ap.error(f"--fault: one of {', '.join(faults.FAULTS)}")

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from bench import harness
    cell = harness.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload,
                          **readings(cell, seed, args.seconds, "cuda", fault=args.fault)}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
