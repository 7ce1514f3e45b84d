"""Logical-axis sharding rules with divisibility fallback, over DTensor
(the port of ``repro.runtime.sharding``).

Sharding is expressed per tensor as logical axis names; the rules map a
logical name to mesh axes. A dim is only sharded when its size divides the
mapped mesh-axis product, else the rule falls back to replication for that
dim (``explain_specs`` lists every fallback, DESIGN.md §4). This one
mechanism shards a 76B dense model, a 64-expert MoE, an MQA model whose 8
query heads do not divide the 16-way model axis and a batch-1 long-context
decode over the same (16, 16) / (2, 16, 16) meshes.

A spec (``spec_for``) is a tuple with one entry per tensor dim: None, a
mesh axis name or a tuple of names — the entries of the reference's
``PartitionSpec``. ``placements_for`` turns it into DTensor placements,
one per mesh dim. Every function that takes a mesh takes a
``torch.distributed.device_mesh.DeviceMesh`` or a plain ``{axis name:
size}`` mapping, so the rules are usable without a process group.

Activations are constrained at the reference's ``sh.c`` / ``sh.kv``
sites through a ``ShardCtx`` entered as a context manager:
``constrain_active(x, axes)`` redistributes a DTensor ``x`` to the rules'
placements and returns anything else as it is, so outside a dry run each
site costs one check.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.models.param import ParamDef, is_def, tree_map

MeshAxes = Union[None, str, Tuple[str, ...]]

# Logical axis -> mesh axes. "model" is tensor/expert parallel; batch-like
# activation axes map to ("pod", "data") which collapses to just "data" on
# the single-pod mesh.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    # parameter axes
    "layers": None,
    "embed": None,             # d_model (kept replicated; residual stream)
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "experts": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "lora": None,
    "conv": None,
    "codebooks": None,
    # activation axes
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_seq_res": None,     # residual stream between blocks (SP variant: "model")
    "act_kv_seq": "model",     # flash-decoding style KV-seq sharding
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_ff": "model",
    "act_vocab": "model",
    "act_embed": None,
    "act_experts": "model",
}

# Variant rule-sets used by the perf hillclimb (EXPERIMENTS.md §Perf).
SEQUENCE_PARALLEL_RULES = dict(DEFAULT_RULES, act_seq_res="model")

Spec = Tuple[MeshAxes, ...]


def _axes_tuple(spec: MeshAxes) -> Tuple[str, ...]:
    if spec is None:
        return ()
    if isinstance(spec, str):
        return (spec,)
    return tuple(spec)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_axis_size(mesh, axes: Tuple[str, ...]) -> int:
    shape = mesh_sizes(mesh)
    size = 1
    for a in axes:
        if a in shape:
            size *= shape[a]
    return size


def spec_for(
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: Optional[Dict[str, MeshAxes]] = None,
) -> Spec:
    """One entry per dim, dropping mesh axes that don't divide the dim or
    that don't exist in this mesh, and never using a mesh axis twice."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_sizes(mesh)
    used: set = set()
    out = []
    for name, dim in zip(logical_axes, shape):
        entry: MeshAxes = rules.get(name) if name else None
        axes = tuple(a for a in _axes_tuple(entry) if a in sizes and a not in used)
        while axes and dim % mesh_axis_size(sizes, axes) != 0:
            axes = axes[:-1]  # drop trailing axes until divisible
        if axes:
            used.update(axes)
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return tuple(out)


def placements_for(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)`` where
    that mesh axis shards tensor dim d, else ``Replicate()``. A dim sharded
    over ("pod", "data") is ``Shard(d)`` on both, the outer mesh dim
    first, which is the reference's device order."""
    from torch.distributed.tensor import Replicate, Shard
    where = {a: d for d, entry in enumerate(spec) for a in _axes_tuple(entry)}
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh_sizes(mesh))


def param_partition_specs(defs, mesh, rules=None):
    """Spec tree for a ParamDef tree."""
    return tree_map(lambda d: spec_for(d.logical_axes, d.shape, mesh, rules),
                    defs, is_leaf=is_def)


def param_shardings(defs, mesh, rules=None):
    """Placements tree for a ParamDef tree."""
    return tree_map(lambda d: placements_for(
        spec_for(d.logical_axes, d.shape, mesh, rules), mesh), defs, is_leaf=is_def)


def tree_paths(tree, path: str = "", is_leaf=None):
    """[(path, leaf)] in flattening order, paths as ``jax.tree_util.keystr``
    writes them: ``['groups'][0][1]['mixer']['wq']``."""
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_paths(tree[k], f"{path}[{k!r}]", is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree)
                for x in tree_paths(t, f"{path}[{i}]", is_leaf)]
    return [(path, tree)]


def explain_specs(defs, mesh, rules=None):
    """List (path, shape, logical_axes, spec, fallbacks) for auditing."""
    rules = rules or DEFAULT_RULES
    rows = []
    for path, d in tree_paths(defs, is_leaf=is_def):
        spec = spec_for(d.logical_axes, d.shape, mesh, rules)
        fallbacks = []
        for name, dim, got in zip(d.logical_axes, d.shape, spec):
            want = _axes_tuple(rules.get(name) if name else None)
            if want and got is None:
                fallbacks.append(f"{name}({dim})!~{'x'.join(want)}")
        rows.append((path, d.shape, d.logical_axes, spec, fallbacks))
    return rows


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, logical_axes, mesh, rules=None):
    """``x`` redistributed to the placements of its logical axes on
    ``mesh`` (a DeviceMesh): the counterpart of
    ``with_sharding_constraint``. A plain tensor comes back as it is."""
    if not is_dtensor(x):
        return x
    placements = placements_for(spec_for(logical_axes, x.shape, mesh, rules), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


_ACTIVE: list = []     # the ShardCtx stack; the innermost is last


class ShardCtx:
    """Activation sharding at the reference's ``sh.c`` / ``sh.kv`` sites.

    ``ShardCtx(None)`` makes every constraint a no-op. Entered as a
    context manager (``with ShardCtx(mesh, rules):``) it becomes the
    context that ``constrain_active`` and ``kv_active`` consult, so the
    model code carries no sharding argument.
    """

    def __init__(self, mesh, rules: Optional[Dict[str, MeshAxes]] = None):
        self.mesh = mesh
        self.rules = dict(rules or DEFAULT_RULES)

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)

    def c(self, x, logical_axes):
        if self.mesh is None:
            return x
        return constrain(x, logical_axes, self.mesh, self.rules)

    def kv_axes(self, cfg) -> Tuple[Optional[str], ...]:
        """KV-cache sharding policy: shard kv-heads over the model axis when
        divisible, else fall back to sharding the cache *sequence* dim
        (flash-decoding style: the partial softmax statistics are merged
        across the model axis)."""
        if self.mesh is None:
            return ("act_batch", None, None, None)
        size = mesh_axis_size(self.mesh, _axes_tuple(self.rules.get("act_kv_heads")))
        if size > 1 and cfg.n_kv_heads % size == 0:
            return ("act_batch", None, "act_kv_heads", None)
        return ("act_batch", "act_kv_seq", None, None)

    def cache_axes(self, cfg, name: str, ndim: int) -> Tuple[Optional[str], ...]:
        """Logical axes of one unstacked ring-cache leaf, by its name in the
        port's layout: ``kv`` (B, C, 2*Hkv, D) as the reference's ``k`` and
        ``v`` (an even split of the 2*Hkv axis keeps each head's K and V
        rows together), ``pos`` (B, C) as the reference's, ``ckr`` (B, C,
        1, r + dr) as its ``c`` and ``kr``, ``conv`` and ``state`` as its
        SSM leaves."""
        kvx = self.kv_axes(cfg)
        axes = {"kv": kvx, "pos": kvx[:2],
                "ckr": ("act_batch", "act_kv_seq", None, None),
                "conv": ("act_batch", None, "ssm_inner"),
                "state": ("act_batch", "act_heads", None, None)}.get(name)
        return axes if axes is not None else (None,) * ndim

    def kv(self, cfg, cache: dict) -> dict:
        """An attention ring ``{"kv", "pos"}`` with its leaves constrained."""
        if self.mesh is None:
            return cache
        out = dict(cache)
        for name in ("kv", "pos"):
            if name in out:
                out[name] = self.c(out[name], self.cache_axes(cfg, name, out[name].dim()))
        return out


def place_caches(ctx: ShardCtx, cfg, caches):
    """Ring caches (``init_caches``' tree, leaves stacked over layers) as
    meta DTensors placed by ``ctx``'s rules (``ShardCtx.cache_axes``);
    the leaves carry shapes only."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(walk(v, name) for v in tree)
        axes = ("layers",) + ctx.cache_axes(cfg, name, tree.dim() - 1)
        spec = spec_for(axes, tree.shape, ctx.mesh, ctx.rules)
        return abstract_tensor(tuple(tree.shape), tree.dtype, ctx.mesh,
                               placements_for(spec, ctx.mesh))
    return walk(caches)


def active() -> Optional[ShardCtx]:
    return _ACTIVE[-1] if _ACTIVE else None


def constrain_active(x, logical_axes):
    """``x`` constrained by the active ``ShardCtx``; ``x`` itself when no
    context is active or ``x`` is not a DTensor."""
    if not _ACTIVE or not is_dtensor(x):
        return x
    return _ACTIVE[-1].c(x, logical_axes)


def kv_active(cfg, cache: dict) -> dict:
    """``ShardCtx.kv`` of the active context, in place in ``cache``; the
    cache as it is when none is active or its leaves are not DTensors."""
    if not _ACTIVE or not is_dtensor(next(iter(cache.values()))):
        return cache
    cache.update(_ACTIVE[-1].kv(cfg, cache))
    return cache


# ---------------------------------------------------------------------------
# Kernels on DTensors: run the kernel on each device's shards
# ---------------------------------------------------------------------------


def local_of(x, placements):
    """The local shard of DTensor ``x`` redistributed to ``placements``
    (a plain tensor or None passes through)."""
    if not is_dtensor(x):
        return x
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(x.device_mesh, placements)
    return x.to_local()


def global_of(t, mesh, placements, shape):
    """A DTensor of global ``shape`` whose local shard is ``t``."""
    from torch.distributed.tensor import DTensor
    if t is None:
        return None
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(t, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape), stride=tuple(reversed(stride)))


def abstract_tensor(shape, dtype, mesh, placements):
    """A meta DTensor of global ``shape`` placed by ``placements`` (one per
    mesh dim): its local shard is a meta tensor of that device's shape."""
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(i)
            if local[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split "
                                 f"{n} ways")
            local[p.dim] //= n
    return global_of(torch.empty(local, dtype=dtype, device="meta"), mesh,
                     placements, tuple(shape))


def head_slice(n_heads: int, n_kv: int, parts: int, rank: int):
    """The KV heads [lo, hi) that query heads [rank*H/parts, (rank+1)*H/parts)
    read when the query heads are split ``parts`` ways and the KV heads are
    not (grouped heads: query head h reads KV head h // (H / Hkv))."""
    if n_heads % parts:
        raise NotImplementedError(f"{n_heads} heads do not split {parts} ways")
    hl, g = n_heads // parts, n_heads // n_kv
    if hl % g == 0:
        return rank * hl // g, (rank + 1) * hl // g
    if g % hl == 0:
        return rank * hl // g, rank * hl // g + 1
    raise NotImplementedError(f"{hl} query heads a device do not cover whole "
                              f"groups of {g}")


def partial_placement():
    from torch.distributed.tensor import Partial
    return Partial("sum")


def replicated(x):
    """Placements of DTensor ``x`` with every Partial reduced (a kernel
    takes no unreduced input)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if p.is_partial() else p for p in x.placements)


def like(g, p):
    """``g`` (a gradient) redistributed to the placements of ``p`` (its
    parameter) when both are DTensors, as the data-parallel reduction of a
    gradient lands it; ``g`` itself otherwise."""
    if not is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def split_last(x, n: int, d: int):
    """``x.reshape(..., n, d)`` of the last dim; a DTensor split over that
    dim where ``n`` does not divide over the split is gathered first."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        mesh, last = x.device_mesh, x.dim() - 1
        pl = tuple(Replicate() if p.is_shard(last) and n % mesh.size(i) else p
                   for i, p in enumerate(x.placements))
        if pl != tuple(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(*x.shape[:-1], n, d)


class _GradAsInput(torch.autograd.Function):
    """Identity whose backward lands the gradient on the forward value's
    placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def merge_last(x):
    """``x.reshape(..., n * d)`` of the last two dims, the inverse of
    ``split_last``: on a DTensor the gradient is brought back to the
    merged value's placements before it is split again."""
    out = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return _GradAsInput.apply(out) if is_dtensor(out) else out


def _vocab_offset(mesh, placements, dim: int, width: int) -> int:
    """This device's first row of a dim split over the mesh dims whose
    placement shards ``dim`` (outer mesh dim first)."""
    off = 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            off = off * mesh.size(i) + mesh.get_local_rank(i)
    return off * width


def gather_last(x, index):
    """``torch.gather(x, -1, index[..., None])[..., 0]``. On a DTensor ``x``
    split over its last dim (vocab-parallel logits) each device gathers
    the indices that fall in its slice and the results are partial sums
    over the split, as Megatron's vocab-parallel cross-entropy does."""
    if not is_dtensor(x):
        return torch.gather(x, -1, index[..., None])[..., 0]
    from torch.distributed.tensor import Replicate
    mesh, last = x.device_mesh, x.dim() - 1
    xp = replicated(x)
    ip = tuple(Replicate() if p.is_shard(last) else p for p in xp)
    xl, il = local_of(x, xp), local_of(_as_dtensor(index, mesh), ip)
    width = xl.shape[-1]
    off = _vocab_offset(mesh, xp, last, width)
    inside = (il >= off) & (il < off + width)
    got = torch.gather(xl, -1, (il - off).clamp(0, width - 1)[..., None])[..., 0]
    got = torch.where(inside, got, torch.zeros_like(got))
    out = tuple(partial_placement() if p.is_shard(last) else q for p, q in zip(xp, ip))
    return global_of(got, mesh, out, tuple(index.shape))


def logsumexp_last(x):
    """``torch.logsumexp(x, -1)``. On a DTensor ``x`` split over its last
    dim, each device reduces its slice and the maximum and the sum of
    exponentials are reduced over the split (two all-reduces of the row
    statistics, not a gather of the rows)."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed.tensor import Partial, Replicate
    mesh, last = x.device_mesh, x.dim() - 1
    xp = replicated(x)
    if not any(p.is_shard(last) for p in xp):
        return torch.logsumexp(x, dim=-1)
    rp = tuple(Replicate() if p.is_shard(last) else p for p in xp)
    xl = local_of(x, xp)
    shape = tuple(x.shape[:-1])
    m = global_of(xl.amax(-1), mesh, tuple(Partial("max") if p.is_shard(last) else q
                                           for p, q in zip(xp, rp)), shape)
    m = local_of(m, rp).detach()
    e = torch.exp(xl - m[..., None]).sum(-1)
    e = local_of(global_of(e, mesh, tuple(partial_placement() if p.is_shard(last) else q
                                         for p, q in zip(xp, rp)), shape), rp)
    return global_of(m + torch.log(e), mesh, rp, shape)


def embedding(tokens, table):
    """``F.embedding(tokens, table)`` for a DTensor ``table`` (V, d) split
    over its vocab rows: each device looks up the tokens in its rows and
    the lookups are partial sums over the split (Megatron's vocab-parallel
    embedding); a split of d over a mesh dim that splits the batch is
    gathered first."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate, Shard
    mesh = table.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    tp = tuple(tokens.placements)
    ep = tuple(Replicate() if (p.is_shard(1) and tp[i].is_shard()) or p.is_partial()
               else p for i, p in enumerate(table.placements))
    kp = tuple(Replicate() if p.is_shard(0) else q for p, q in zip(ep, tp))
    el, kl = local_of(table, ep), local_of(tokens, kp)
    rows = el.shape[0]
    off = _vocab_offset(mesh, ep, 0, rows)
    inside = (kl >= off) & (kl < off + rows)
    got = F.embedding((kl - off).clamp(0, rows - 1), el)
    got = torch.where(inside[..., None], got, torch.zeros_like(got))
    out = tuple(partial_placement() if p.is_shard(0) else
                Shard(tokens.dim()) if p.is_shard(1) else q for p, q in zip(ep, kp))
    return global_of(got, mesh, out, tuple(tokens.shape) + (table.shape[1],))


def _as_dtensor(x, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def write_ring_local(ring, ring_pos, rows) -> None:
    """A ring write ``ring[:, slot(p)] = rows`` on a DTensor ring (B, C,
    ...), in place on each device's shard: rows follow the ring's batch
    and head split, and a ring split over its slots takes on each device
    the rows that land in its slots — min(S, C_local) of a chunk of S that
    covers the ring evenly. No values: this is the dry run's write."""
    from torch.distributed.tensor import Replicate
    mesh = ring.device_mesh
    want = tuple(Replicate() if p.is_shard(1) else p for p in ring.placements)
    rows_l = local_of(_as_dtensor(rows, mesh), want)
    ring_l, pos_l = ring.to_local(), ring_pos.to_local()
    n = min(rows_l.shape[1], ring_l.shape[1])
    ring_l[:, :n] = rows_l[:, :n].to(ring_l.dtype)
    pos_l[:, :n] = torch.zeros((), dtype=pos_l.dtype, device=pos_l.device)
