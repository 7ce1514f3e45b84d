#!/usr/bin/env python3
"""Where the PyTorch port's training step spends its time on the card.

    python3 scripts/profile_port_train.py

gemma-2b at full width and depth (18 layers, d 2048, MQA 8/1 at head_dim
256, vocab 256000, bf16, ``remat="full"``, AdamW) on 4 x 2048 tokens of the
synthetic pipeline, random weights from a seed: one warm-up step, then 2
steps under ``torch.profiler``. Prints one JSON line: wall time per step,
device-busy time and idle share, kernel launches per step, the device time
of the flash-attention kernels and of the matrix products
(``aten::mm``/``aten::bmm``/``aten::addmm``), and the top device kernels
by time, with the card's name and power limit. The device-busy time is
the union of the device activities' intervals (``bench/trace.py``'s
``device_busy_s``). Needs one card.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARCH, BATCH, SEQ, STEPS, TOP = "gemma-2b", 4, 2048, 2, 15
# bf16 training runs the tensor-core forward, dK/dV (with its partial-sum
# launch) and dQ kernels
FLASH = ("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel", "flash_bwd_dkdv_reduce_kernel",
         "flash_bwd_dq_tc_kernel")
MATMULS = ("aten::mm", "aten::bmm", "aten::addmm")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import make_train_step
    from bench import trace

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = get_config(ARCH)
    params = init_params(cfg, 0, device="cuda")
    opt_state = init_opt_state(params)
    step = make_train_step(cfg, OptConfig(warmup_steps=1, total_steps=STEPS + 1))
    pipe = SyntheticPipeline(cfg, DataConfig(seq_len=SEQ, global_batch=BATCH, seed=0))

    def batch(s):
        return {k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(s).items()}

    params, opt_state, _ = step(params, opt_state, batch(0))   # warm-up
    torch.cuda.synchronize()
    batches = [batch(s) for s in range(1, STEPS + 1)]
    losses = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            params, opt_state, m = step(params, opt_state, b)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    (_, starts, ends), _ = trace.device_events(prof)
    busy_s = trace.device_busy_s(starts, ends)
    by_dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)

    def dev_ms(match):
        return sum(e.self_device_time_total for e in events if match(e.key)) / 1e3

    print(json.dumps({
        "nvidia_smi": smi, "arch": ARCH, "layers": cfg.num_layers,
        "batch": BATCH, "seq_len": SEQ, "steps": STEPS, "remat": cfg.remat,
        "losses": [float(x) for x in losses],
        "wall_s": wall, "ms_per_step": wall * 1e3 / STEPS,
        "tokens_per_s": BATCH * SEQ * STEPS / wall,
        "device_busy_s": busy_s,
        "device_idle_share": 1 - busy_s / wall,
        "launches_per_step": {e.key: e.count / STEPS for e in events
                              if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                           "cuLaunchKernelEx")},
        "flash_device_ms_per_step": {k: dev_ms(lambda key, k=k: k in key) / STEPS
                                     for k in FLASH},
        "flash_calls_per_step": {k: sum(e.count for e in events if k in e.key) / STEPS
                                 for k in FLASH},
        "matmul_device_ms_per_step": dev_ms(lambda key: key in MATMULS) / STEPS,
        "top_by_device": [{"name": e.key[:90], "calls": e.count,
                           "self_device_ms": e.self_device_time_total / 1e3}
                          for e in by_dev[:TOP]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
