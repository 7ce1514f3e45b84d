"""Benchmark trajectory persistence shared by the bench suites (the port's
copy of ``repro.core.trajectory``, which it may not import).

Every gated sweep appends its result to a ``BENCH_*.json`` file at the
repo root — the trajectory CI uploads as an artifact and later sessions
diff against. The sweeps are deterministic, so re-runs of identical code
must not grow the file: an entry whose metric fields match the last
persisted entry for the same key is dropped instead of appended (``at``
is tiebreak metadata, not a metric). Extracted from
``benchmarks/serving_sim.py`` when the fleet scenario zoo
(``experiments/``) became the third writer of this format.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


def persist_trajectory(filename: str, entry: dict, key: str = "arch",
                       root: Optional[str] = None,
                       ignore: tuple = ("at",)) -> bool:
    """Append ``entry`` to ``<repo root>/<filename>`` unless it duplicates
    the last entry with the same ``entry[key]`` on every field outside
    ``ignore`` (wall-clock fields like ``at`` or ``wall_s`` are metadata,
    not metrics). Returns True if the entry was written, False if
    deduplicated away."""
    if root is None:
        # src/repro_torch/core/trajectory.py -> repo root is four levels up
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
    path = os.path.join(root, filename)
    data = {"entries": []}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {"entries": []}
    entries = data.setdefault("entries", [])
    tag = entry.get(key)
    last = next((e for e in reversed(entries) if e.get(key) == tag), None)
    new = json.loads(json.dumps(entry, default=float))
    drop = set(ignore) | {"at"}
    if last is not None and \
            {k: v for k, v in last.items() if k not in drop} == \
            {k: v for k, v in new.items() if k not in drop}:
        return False
    entries.append({"at": time.time(), **new})
    with open(path, "w") as f:
        json.dump(data, f, indent=1, default=float)
        f.write("\n")
    return True
