"""Weights drawn on the device from ``--seed``, in the dtype they are
served in, one generator call a leaf.

The shapes, dtypes and init kinds come from the port's parameter-definition
tree (``repro_torch.models.transformer.model_defs``); the rules that turn a
definition into numbers are this file's own copy of
``repro_torch/models/param.py``'s (``normal`` at the definition's std or
the fan-in std 1/sqrt(shape[-2]) of the stacked shape, ``zeros``, ``ones``,
``a_log`` = log U[1, 16), ``dt_bias`` = log(expm1(U[1e-3, 1e-1])), the
inverse softplus of dt). The draw is ``torch.Generator``'s, not the port's
copy of JAX's generator (``init_params``, which takes seconds to a minute
a model): the same seed gives the same weights on the same card, and the
engine and the reference are handed the same tensors.
"""
from __future__ import annotations

import math


def _fan_in_std(shape, std):
    if std is not None:
        return std
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def draw(defs, seed: int, device, default_dtype: str = "bfloat16"):
    """A tree of tensors on ``device`` for the definition tree ``defs``
    (dicts visited in sorted key order, tuples in order; a leaf has
    ``shape``, ``init``, ``std`` and ``dtype``)."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))

    def one(d):
        dt = getattr(torch, d.dtype or default_dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        if d.init == "a_log":
            u = torch.empty(d.shape, dtype=torch.float32, device=device)
            return torch.log(u.uniform_(1.0, 16.0, generator=gen)).to(dt)
        if d.init == "dt_bias":
            u = torch.empty(d.shape, dtype=torch.float32, device=device)
            return torch.log(torch.expm1(u.uniform_(1e-3, 1e-1, generator=gen))).to(dt)
        if d.init != "normal":
            raise ValueError(f"unknown init {d.init!r}")
        t = torch.empty(d.shape, dtype=dt, device=device)
        return t.normal_(0.0, _fan_in_std(d.shape, d.std), generator=gen)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return one(node)

    return walk(defs)


def per_layer(params, groups) -> dict:
    """The reference's view of a parameter tree: ``{"embed", "final_norm",
    "layers": [one dict of views a layer, in layer order]}``. ``groups`` is
    ``[(units, repeats)]`` in stack order, each unit's leaves stacked over
    its repeats (``params["groups"][g][u]``)."""
    def index(tree, i):
        if isinstance(tree, dict):
            return {k: index(v, i) for k, v in tree.items()}
        return tree[i]

    layers = []
    for gi, (units, repeats) in enumerate(groups):
        for i in range(repeats):
            for u in range(units):
                layers.append(index(params["groups"][gi][u], i))
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers": layers}
