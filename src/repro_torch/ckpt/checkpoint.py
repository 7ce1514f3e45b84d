"""Atomic, optionally asynchronous checkpoints in the JAX package's
on-disk format (port of ``repro.ckpt.checkpoint``), so a checkpoint moves
between the two packages either way.

Layout: <dir>/step_<N>/ arrays.npz (leaves ``a0``, ``a1``, ... in tree
order) + manifest.json (step, leaf paths, dtypes, shapes, extra). Paths
are spelled as ``jax.tree_util.keystr`` spells them — ``"[0]['embed']
['embedding']"``, ``"[1]"`` for a tuple index — and trees flatten as JAX
flattens them (dict keys sorted). bf16 leaves are stored as their uint16
bits with the dtype name ``"bfloat16"``; other dtypes by numpy's name.
Writes go to a tmp dir + atomic rename, so a crash mid-save never corrupts
the latest checkpoint; ``save_async`` copies to host memory first and
writes in a background thread.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.param import tree_map


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree) for x in _flatten(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """Host array as npz stores it, and its dtype name."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:   # numpy has no bfloat16: keep the bits
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
         keep_last: int = 3) -> str:
    """Synchronous atomic save. Returns the checkpoint path."""
    base = pathlib.Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves = [(p, *_to_numpy(leaf)) for p, leaf in _flatten(tree)]
    np.savez(tmp / "arrays.npz", **{f"a{i}": a for i, (_, a, _) in enumerate(leaves)})
    manifest = {
        "step": step,
        "paths": [p for p, _, _ in leaves],
        "dtypes": [d for _, _, d in leaves],
        "shapes": [list(a.shape) for _, a, _ in leaves],
        "extra": extra or {},
        "saved_at": time.time(),
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(base, keep_last)
    return str(final)


def save_async(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
               keep_last: int = 3) -> threading.Thread:
    """Snapshot to host memory now; write in a background thread."""
    host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
    t = threading.Thread(target=save, args=(ckpt_dir, step, host_tree, extra,
                                            keep_last), daemon=True)
    t.start()
    return t


def _gc(base: pathlib.Path, keep_last: int) -> None:
    steps = sorted(p for p in base.iterdir() if p.name.startswith("step_"))
    for p in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in base.iterdir()
                   if p.name.startswith("step_"))
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like, shardings=None,
            mesh=None) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (a tree of tensors): every
    leaf takes its ``like`` leaf's dtype and device. ``shardings``: an
    optional tree of DTensor placements (``runtime.sharding.
    param_shardings``) on the DeviceMesh ``mesh``: each leaf is then
    distributed with its placements, every device keeping its own shard (a
    resharding restore: the format on disk is the unsharded arrays, so it
    works across mesh shapes). Returns (tree, extra)."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as z:
        arrays = {p: _from_numpy(z[f"a{i}"], manifest["dtypes"][i])
                  for i, p in enumerate(manifest["paths"])}
    leaves = []
    for key, leaf in _flatten(like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        a = arrays[key]
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(a.shape)} != {tuple(leaf.shape)}")
        leaves.append(a.to(device=leaf.device, dtype=leaf.dtype))
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), like)
    if shardings is not None:
        from torch.distributed.tensor import distribute_tensor
        tree = tree_map(lambda a, pl: distribute_tensor(a, mesh, pl, src_data_rank=None),
                        tree, shardings)
    return tree, manifest["extra"]
