"""Print the port's dry-run cells as a markdown table, one row per arch
and one column per shape; each cell gives the single-pod / multi-pod
mesh's per-device GB (``!`` where it exceeds 80 GB), dominant roofline
term (C compute, M memory, X collective), bound in seconds and useful
FLOP ratio — from the JSON files ``python -m repro_torch.launch.dryrun
--all --mesh both`` writes. Exits 1 unless every cell came back ok.

    PYTHONPATH=src python scripts/dryrun_table.py [artifacts/dryrun_torch]
"""
from __future__ import annotations

import json
import pathlib
import sys

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _one(res) -> str:
    if res is None:
        return "—"
    if not res.get("ok"):
        return "failed"
    mem, rt = res["memory"], res["roofline"]
    gb = mem["per_device_gib"] * 2 ** 30 / 1e9
    return (f"{gb:.2f}{'' if mem['fits_80gb'] else '!'} {rt['dominant'][0].upper()} "
            f"{rt['bound_s']:.3g} {res['model_flops']['useful_ratio']:.2f}")


def main(argv) -> int:
    root = pathlib.Path(argv[1] if len(argv) > 1 else "artifacts/dryrun_torch")
    cells = {}
    for path in sorted(root.glob("*__base.json")):
        res = json.loads(path.read_text())
        cells[(res["arch"], res["shape"], res["mesh"])] = res
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("| --- |" + " --- |" * len(SHAPES))
    for arch in sorted({a for a, _, _ in cells}):
        row = []
        for shape in SHAPES:
            single, multi = (cells.get((arch, shape, m)) for m in ("single", "multi"))
            row.append("—" if single is None and multi is None
                       else f"{_one(single)} / {_one(multi)}")
        print(f"| {arch} | " + " | ".join(row) + " |")
    ok = sum(bool(r.get("ok")) for r in cells.values())
    print(f"\n{ok} of {len(cells)} cells ok")
    return 0 if ok == len(cells) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
