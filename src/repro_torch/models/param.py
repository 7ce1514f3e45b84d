"""Parameter definition trees.

Modules describe their parameters as trees (dicts and tuples) of
:class:`ParamDef` (shape + logical axes + initializer), exactly as
``repro.models.param`` does, so a parameter's path and shape are the same
in both packages. ``materialize`` turns a definition tree into tensors on
a device; ``params_from_numpy`` carries the JAX package's parameter tree
across leaf for leaf (the weight bridge the parity tests use).

The small tree helpers here replace ``jax.tree``: dict keys are visited in
sorted order, as JAX flattens them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import jax_random


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | a_log | dt_bias
    std: Optional[float] = None  # None => fan-in 1/sqrt(shape[-2 or -1])
    dtype: Optional[str] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.logical_axes), (self.shape, self.logical_axes)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def torch_dtype(name) -> torch.dtype:
    """'bfloat16' / 'float32' / ... -> the torch dtype of that name."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Tree helpers (dicts with sorted keys, tuples, lists)
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves of
    ``rest``, which must share its structure), keeping the containers."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


def tree_same_structure(a, b) -> bool:
    """True when ``a`` and ``b`` have the same containers and keys."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and sorted(a) == sorted(b)
                and all(tree_same_structure(a[k], b[k]) for k in a))
    if isinstance(a, (tuple, list)) or isinstance(b, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(tree_same_structure(x, y) for x, y in zip(a, b)))
    return True


# ---------------------------------------------------------------------------
# Definitions -> tensors
# ---------------------------------------------------------------------------


def stack_defs(defs, repeats: int):
    """Add a leading scanned-layers axis to every ParamDef in a tree."""
    def add(d: ParamDef) -> ParamDef:
        return dataclasses.replace(
            d, shape=(repeats,) + d.shape, logical_axes=("layers",) + d.logical_axes)
    return tree_map(add, defs, is_leaf=is_def)


def _fan_in_std(d: ParamDef) -> float:
    if d.std is not None:
        return d.std
    if len(d.shape) >= 2:
        fan_in = d.shape[-2]
    else:
        fan_in = d.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def materialize(defs, key, device: torch.device, default_dtype: str = "bfloat16"):
    """Initialize real parameter tensors on ``device`` from a def tree as
    ``repro.models.param.materialize`` does with the same JAX key (a pair
    of 32-bit words, ``jax_random.key(seed)``): one key per leaf from
    ``split`` in ``jax.tree.flatten`` order, each leaf drawn in float32 by
    the port's copy of ``jax.random`` and cast to the leaf's dtype."""
    leaves = tree_leaves(defs, is_leaf=is_def)
    keys = iter(jax_random.split(key, max(len(leaves), 1)))

    def one(d: ParamDef):
        k = next(keys)
        dt = torch_dtype(d.dtype or default_dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        # the logs in plain arithmetic (XLA's float32 log), so the CPU and
        # the card draw the same bits
        if d.init == "a_log":    # mamba2: A ~ U[1, 16), stored as a log
            return jax_random.log_f32(jax_random.uniform(k, d.shape, 1.0, 16.0, device)).to(dt)
        if d.init == "dt_bias":  # softplus^-1 of dt ~ U[1e-3, 1e-1]
            u = jax_random.uniform(k, d.shape, 1e-3, 1e-1, device)
            return jax_random.log_f32(jax_random.expm1_f32(u)).to(dt)
        if d.init != "normal":
            raise ValueError(f"unknown init {d.init!r}")
        return jax_random.normal(k, d.shape, device, scale=_fan_in_std(d), dtype=dt)

    return tree_map(one, defs, is_leaf=is_def)


def abstract(defs, default_dtype: str = "bfloat16", shardings=None, mesh=None):
    """Tensors on the ``meta`` device (shape and dtype, nothing allocated)
    for a def tree; with ``shardings`` (a tree of DTensor placements,
    ``runtime.sharding.param_shardings``) and ``mesh``, meta DTensors whose
    local shards are each device's."""
    def dtype(d):
        return torch_dtype(d.dtype or default_dtype)
    if shardings is None:
        return tree_map(lambda d: torch.empty(d.shape, dtype=dtype(d), device="meta"),
                        defs, is_leaf=is_def)
    from repro_torch.runtime.sharding import abstract_tensor
    return tree_map(lambda d, pl: abstract_tensor(d.shape, dtype(d), mesh, pl),
                    defs, shardings, is_leaf=is_def)


def count_params(defs) -> int:
    leaves = tree_leaves(defs, is_leaf=is_def)
    return int(sum(int(np.prod(d.shape)) for d in leaves))


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a, order="C")   # keeps 0-d leaves (the optimizer step) 0-d
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX hands out ml_dtypes'):
        # carry the bits across as uint16 and reinterpret them
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(tree, device=None):
    """The weight bridge: the JAX parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, init_params(cfg, key))``) -> the port's
    tree of tensors on ``device``, with the same paths, shapes (stacked
    repeats axis and the (d, H, hd) / (H, hd, d) projection layouts
    included) and dtypes. ``device`` defaults to ``cuda``."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor_from_numpy(a).to(dev), tree)
