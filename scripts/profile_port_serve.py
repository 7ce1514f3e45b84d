#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time on the card.

    python3 scripts/profile_port_serve.py                  # qwen3-8b, mamba2-2.7b
    python3 scripts/profile_port_serve.py deepseek-v2-lite-16b mixtral-8x22b

For each serving path named (by default qwen3-8b, then mamba2-2.7b; any
``--arch`` of ``chip_smoke.py``'s serve phases), each at full width and
the depth ``chip_smoke.py`` serves it at (mixtral-8x22b and internvl2-76b
cut to their first layers, ``SERVE_LAYERS``; the memory plane meters the
published config), with the serve defaults and random weights from a
seed — serves its 8 requests once to warm up, then
serves them again under ``torch.profiler`` and prints one JSON line: wall
time, device-busy time and idle share, time per model call, launch and
host-sync counts, and the top operators by device time and by host time,
with the card's name and power limit. The device-busy time is the union of
the device activities' intervals (``device_busy_s``). Needs one card.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

REQUESTS = 8
TOP = 15
ARCHS = ("qwen3-8b", "mamba2-2.7b")


def device_busy_s(prof) -> float:
    """Seconds in which the card ran anything (kernel, copy, memset): the
    union of the device activities' intervals. Summing ``key_averages()``'
    self device times would count a kernel twice — once under its own name
    and once under the operator (or autograd node) that launched it."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("Command Buffer"))
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    return busy_us / 1e6


def profile_arch(arch: str, smi: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SERVE_LAYERS
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=SERVE_LAYERS.get(arch, full.num_layers))
    args = serve.parser().parse_args(["--arch", arch])
    params = tfm.init_params(cfg, args.seed, device="cuda")

    def run(eng):
        prompts = serve.make_prompts(cfg, REQUESTS, 32, args.seed)
        eng.submit(prompts[0], max_new_tokens=args.max_new)
        eng.run_until_idle()
        for p in prompts[1:]:
            eng.submit(p, max_new_tokens=args.max_new)
        return eng.run_until_idle()

    def engine():
        eng = serve.build_engine(args, cfg, full, params, device="cuda")
        eng.ecfg.eos_token = -1     # random weights: never end early
        return eng

    run(engine())                   # warm-up: library build, cuBLAS plans
    torch.cuda.synchronize()
    eng = engine()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = run(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_s = device_busy_s(prof)
    by_dev = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    by_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)

    def row(e):
        return {"name": e.key[:80], "calls": e.count,
                "self_device_ms": e.self_device_time_total / 1e3,
                "self_host_ms": e.self_cpu_time_total / 1e3}

    print(json.dumps({
        "nvidia_smi": smi, "arch": arch, "layers": cfg.num_layers,
        "published_layers": full.num_layers,
        "requests": REQUESTS, "tokens_generated": rep["tokens_generated"],
        "model_calls": eng.backend.model_calls, "wall_s": wall,
        "ms_per_model_call": wall * 1e3 / eng.backend.model_calls,
        "device_busy_s": busy_s,
        "device_idle_share": 1 - busy_s / wall,
        "calls": {e.key: e.count for e in events
                  if e.key in ("cudaLaunchKernel", "aten::nonzero",
                               "aten::item", "aten::_local_scalar_dense")},
        "top_by_device": [row(e) for e in by_dev[:TOP]],
        "top_by_host": [row(e) for e in by_cpu[:TOP]],
    }), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for arch in sys.argv[1:] or ARCHS:
        profile_arch(arch, smi)
        gc.collect()                # free one model before the next
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
