#!/usr/bin/env python3
"""Device times of the ragged paged-attention kernel of one checkout, for
comparing two commits on one card.

    python3 scripts/compare_paged_kernel.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a directory holding a copy of the repository (for
example one unpacked by ``git archive``); each is measured in a process of
its own, which builds that checkout's kernel library into its own
``build/`` and imports its ``chip_smoke.py`` for the cases and the timer.
Name the checkouts in turns (parent, change, change, parent) and compare
only within one run. For each checkout it prints one JSON line of the
kernel's mean device milliseconds (``torch.profiler``, the L2 cache
flushed before each call), bf16, at the serving paths' decode shapes —
qwen3-8b (short and 4 x 4096), hymba-1.5b, deepseek-v2-lite-16b's latent
head (slot mode), mixtral-8x22b — internvl2-76b's 320-row first chunk and
gemma2-27b's position-mode decode on wrapped 4096-slot rings, with the
card's name and power limit. Needs one card.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def measure(checkout: pathlib.Path) -> dict:
    sys.path[:0] = [str(checkout / "src"), str(checkout)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import ops

    _build.build_all([ops.SOURCE])
    rpa = ops.ragged_paged_attention
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    keep = lambda key: "ragged_paged_attention" in key  # noqa: E731
    out = {"checkout": checkout.name, "nvidia_smi": cs.nvidia_smi()}
    for name, geo, (ql, kl) in (
            ("decode", (cs.HQ, cs.HKV, cs.D), ([1] * 4, [72, 80, 88, 96])),
            ("long_decode", (cs.HQ, cs.HKV, cs.D), ([1] * 4, [4096] * 4)),
            ("hymba_decode", cs.HYMBA, ([1] * 4, [170, 190, 210, 230])),
            ("mla_decode", cs.MLA, ([1] * 4, [72, 80, 88, 96])),
            ("mixtral_decode", cs.MIXTRAL, ([1] * 4, [72, 80, 88, 96])),
            ("internvl2_first_chunk", cs.INTERNVL2, ([320], [320]))):
        case = cs.make_case(torch, ql, kl, torch.bfloat16, geo=geo, seed=5)
        scale = cs.scale_of(geo)
        out[name] = cs.device_ms(torch, lambda: rpa(*case, scale=scale, max_q_len=max(ql)),
                                 flush, keep)
    case, q_pos, kv_pos = cs.ring_case(torch, [(600, 4696)] * 4, [1] * 4, 4096,
                                       torch.bfloat16, ahead=[0, 40, 80, 120], seed=5)
    kw = dict(scale=cs.scale_of(cs.GEMMA2), cap=cs.GEMMA2_CAP, window=cs.GEMMA2_WINDOW,
              q_pos=q_pos, kv_pos_pages=kv_pos)
    out["gemma2_position_decode"] = cs.device_ms(
        torch, lambda: rpa(*case, max_q_len=1, **kw), flush, keep)
    return out


def main(argv) -> int:
    if argv and argv[0] == "--one":
        print(json.dumps(measure(pathlib.Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for checkout in argv:   # a process each: every checkout imports its own package
        rc = subprocess.run([sys.executable, __file__, "--one", checkout]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
