"""Per-device FLOP, byte and collective counts of a traced step (the
counterpart of ``repro.launch.hlo_analysis``).

There is no HLO here. The reference parses XLA's compiled per-device
module; the port runs the step eagerly under a ``TorchDispatchMode``
(``Trace``) and counts the aten ops it dispatches. On DTensor inputs the
mode hands each DTensor-level op on to DTensor and counts the ops DTensor
runs on the local shards, with the collectives its redistributions issue:
the local program of one device, replicated compute included, which is
what the reference's "All sizes are PER DEVICE" means. The ops DTensor
runs on fake tensors to propagate global shapes are not counted. A step on
``meta`` tensors allocates nothing and computes nothing: that is the dry
run.

Per op:

- FLOPs: matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, and
  convolutions and their backward) count 2 per multiply-add in
  ``dot_flops``; the ops of ``ELEMENTWISE_1FLOP`` one per output element in
  ``elementwise_flops``; those of ``TRANSCENDENTAL`` one per output element
  in ``transcendentals``; ``flops`` is dot + elementwise, as in the
  reference;
- bytes: every op that is not a view or an allocation reads its tensor
  inputs and writes its outputs. The reference models XLA's fusions
  (``_fusion_bytes``: a fusion pays its boundary only); the port runs
  eagerly and does not fuse, so its byte count is its own;
- the hand-written kernels (``kernels/_work.py``) count as one op each,
  with the flops and bytes of PERF.md's bound column (each input read
  once, each output written once), from shapes alone; the ops of a
  kernel's plain version inside the wrapper are not counted on top, so a
  CPU step and its meta trace give the same count;
- collectives (``_c10d_functional``): operand, result and wire bytes with
  the reference's wire formulas, the group size that of the mesh dim the
  collective runs over. A collective over a group of one moves nothing and
  is not counted.

Loops need no trip counts: a Python loop runs its body once per iteration,
and each run is counted where it happens. So the reference's HLO-text
machinery has no counterpart: ``parse_module``, ``exec_counts`` and
``_trip_count`` (the call graph and while-loop trip counts),
``_fusion_bytes`` (fusion boundaries) and ``shape_bytes`` / ``shape_dims``
(HLO shape strings).

The trace also follows the live bytes of every storage it sees allocated
(the step's arguments, registered at the start, and every op's outputs,
released when the storage is freed): ``peak_bytes`` is their maximum over
the step, on any device, meta included.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _work

_FUNCOL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}

ELEMENTWISE_1FLOP = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "clamp", "clamp_min",
    "clamp_max", "floor", "ceil", "round", "sign", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "remainder", "fmod", "reciprocal",
    "square", "relu", "threshold_backward", "masked_fill", "addcmul",
    "addcdiv", "lerp",
}
TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log1p", "tanh", "sigmoid",
    "rsqrt", "sqrt", "pow", "sin", "cos", "atan2", "erf", "silu", "gelu",
    "softplus", "_softmax", "_log_softmax", "logsumexp", "tanh_backward",
    "sigmoid_backward", "silu_backward", "gelu_backward",
    "_softmax_backward_data", "_log_softmax_backward_data",
}
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "convolution",
         "convolution_backward"}
# no data moved: allocations and bookkeeping
_FREE = {"empty", "empty_strided", "empty_like", "new_empty", "_unsafe_view",
         "new_empty_strided", "detach", "alias", "lift_fresh", "set_",
         "resize_", "_local_scalar_dense", "is_same_size", "sym_size",
         "sym_stride", "sym_numel", "wait_tensor", "_wrap_tensor_autograd",
         "record_stream"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _strided(t) -> bool:
    from torch.distributed.tensor.placement_types import _StridedShard
    return any(isinstance(p, _StridedShard) for p in getattr(t, "placements", ()))


def _unstride(tree):
    """``tree`` with every DTensor split in a strided layout redistributed
    to Replicate on those mesh dims."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.placement_types import _StridedShard
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unstride(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _unstride(v) for k, v in tree.items()}
    if _strided(tree):
        pl = [Replicate() if isinstance(p, _StridedShard) else p for p in tree.placements]
        return tree.redistribute(tree.device_mesh, pl)
    return tree


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(name: str, args, out) -> float:
    if name == "mm":
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2.0 * m * n * k
    if name == "addmm":
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2.0 * m * n * k
    if name == "bmm":
        (b, m, k), n = args[0].shape, args[1].shape[2]
        return 2.0 * b * m * n * k
    if name == "baddbmm":
        (b, m, k), n = args[1].shape, args[2].shape[2]
        return 2.0 * b * m * n * k
    # convolution: 2 * output elements * (input channels per group) * taps;
    # its backward computes up to two products of that size
    x, w = args[0], args[1]
    if name == "convolution":
        groups = args[8]
        return 2.0 * out.numel() * (x.shape[1] // groups) * math.prod(w.shape[2:])
    fwd = 2.0 * args[0].numel() * (w.shape[1]) * math.prod(w.shape[2:])
    mask = args[-1]
    return fwd * (int(bool(mask[0])) + int(bool(mask[1])))


class Trace(TorchDispatchMode):
    """Counts what a step dispatches while it is active (``with Trace() as
    t: step(...)``); ``t.result()`` gives the reference's keys. Register
    the step's inputs with ``t.hold(tree)`` first to have them in
    ``peak_bytes``."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.elementwise_flops = 0.0
        self.transcendentals = 0.0
        self.bytes_accessed = 0.0
        self.collectives = defaultdict(lambda: {"operand_bytes": 0.0, "result_bytes": 0.0,
                                                "wire_bytes": 0.0, "count": 0.0})
        self.kernels = defaultdict(lambda: {"count": 0, "flops": 0.0, "bytes": 0.0})
        self.live_bytes = 0
        self.peak_bytes = 0
        self._held = set()
        self._quiet = 0

    # -- live storage ------------------------------------------------------

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (local shards of
        DTensors) as live until they are freed; returns the bytes added."""
        added = 0
        from repro_torch.runtime.sharding import is_dtensor
        for t in _tensors(tree):
            added += self._track(t.to_local() if is_dtensor(t) else t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return added

    def _track(self, t: torch.Tensor) -> int:
        try:
            s = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return 0
        key = id(s)
        if key in self._held:
            return 0
        n = s.nbytes()
        self._held.add(key)
        self.live_bytes += n
        weakref.finalize(s, self._release, key, n)
        return n

    def _release(self, key, n):
        self._held.discard(key)
        self.live_bytes -= n

    # -- kernels -----------------------------------------------------------

    @contextlib.contextmanager
    def kernel(self, name: str, flops: float, n_bytes: float):
        """One kernel launch of ``flops`` and ``n_bytes``; the ops inside
        are not counted. Yields ``record(out)``, which tracks the kernel's
        outputs as live and returns them."""
        k = self.kernels[name]
        k["count"] += 1
        k["flops"] += flops
        k["bytes"] += n_bytes
        self.dot_flops += flops
        self.bytes_accessed += n_bytes

        def record(out):
            for t in _tensors(out):
                self._track(t)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            return out

        self._quiet += 1
        try:
            yield record
        finally:
            self._quiet -= 1

    # -- dispatch ----------------------------------------------------------

    def __enter__(self):
        if _work.TRACE is not None:
            raise RuntimeError("an analysis is already active")
        _work.TRACE = self
        return super().__enter__()

    def __exit__(self, *exc):
        _work.TRACE = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if not any(_strided(a) for a in _tensors((args, kwargs))):
                # DTensor runs the op on the local shards, which come back here
                return NotImplemented
            # a strided split (a flattened pair of split dims) is gathered
            # first: DTensor's cost model searches every plan from it, which
            # takes minutes an op on a 3-D mesh; the gather is counted. (The
            # plain split of the same dim is not the same layout: a view
            # that follows may need the strided one.)
            TorchDispatchMode.__enter__(self)
            try:
                args, kwargs = _unstride((args, kwargs))
                return func(*args, **kwargs)
            finally:
                TorchDispatchMode.__exit__(self, None, None, None)
        out = func(*args, **kwargs)
        if (self._quiet or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None
                or any(isinstance(t, FakeTensor) for t in _tensors(out))):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":
            self._collective(name, args, out)
            return
        if ns != "aten" or name in _FREE or func.is_view:
            return
        outs = list(_tensors(out))
        for t in outs:
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        base = name.rstrip("_") if name.endswith("_") and not name.startswith("_") else name
        n_out = outs[0].numel() if outs else 0
        if base in _DOTS:
            self.dot_flops += _dot_flops(base, args, outs[0] if outs else None)
        elif base in ELEMENTWISE_1FLOP:
            self.elementwise_flops += n_out
        elif base in TRANSCENDENTAL:
            self.transcendentals += n_out

    def _collective(self, name, args, out):
        kind = _FUNCOL.get(name)
        if kind is None:
            return
        import torch.distributed.distributed_c10d as c10d
        group_name = args[-1]
        g = c10d._resolve_process_group(group_name).size()
        if g <= 1:
            return
        ob = sum(map(_nbytes, _tensors(args[0])))
        rb = sum(map(_nbytes, _tensors(out)))
        if kind == "all-gather":
            wire = max(rb - ob, 0)
        elif kind == "all-reduce":
            wire = 2.0 * ob * (g - 1) / max(g, 1)
        elif kind == "reduce-scatter":
            wire = max(ob - rb, 0)
        elif kind == "all-to-all":
            wire = ob * (g - 1) / max(g, 1)
        else:  # collective-permute
            wire = ob
        c = self.collectives[kind]
        c["operand_bytes"] += ob
        c["result_bytes"] += rb
        c["wire_bytes"] += wire
        c["count"] += 1
        self.bytes_accessed += ob + rb
        for t in _tensors(out):
            self._track(t)

    # -- result ------------------------------------------------------------

    def result(self) -> dict:
        """Totals per device, with the reference's keys, and
        ``kernels``: {name: {count, flops, bytes}}."""
        coll = {k: dict(v) for k, v in self.collectives.items()}
        return {
            "dot_flops": self.dot_flops,
            "elementwise_flops": self.elementwise_flops,
            "transcendentals": self.transcendentals,
            "flops": self.dot_flops + self.elementwise_flops,
            "bytes_accessed": self.bytes_accessed,
            "collectives": coll,
            "collective_operand_bytes": sum(c["operand_bytes"] for c in coll.values()),
            "collective_wire_bytes": sum(c["wire_bytes"] for c in coll.values()),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }


def analyze(step, *args, **kwargs) -> dict:
    """``step(*args, **kwargs)`` run under a ``Trace``: its per-device
    counts (``Trace.result``)."""
    with Trace() as t:
        step(*args, **kwargs)
    return t.result()


def roofline_terms(analysis: dict, *, peak_flops: float, hbm_bw: float,
                   ici_bw: float) -> dict:
    """Three roofline terms in seconds (per-device program)."""
    compute_s = analysis["flops"] / peak_flops
    memory_s = analysis["bytes_accessed"] / hbm_bw
    collective_s = analysis["collective_operand_bytes"] / ici_bw
    collective_wire_s = analysis["collective_wire_bytes"] / ici_bw
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", collective_s), key=lambda kv: kv[1])
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "collective_wire_s": collective_wire_s,
        "dominant": dom[0],
        "bound_s": dom[1],
    }
