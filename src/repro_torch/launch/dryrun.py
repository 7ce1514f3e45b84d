"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the
production mesh with meta DTensor inputs (nothing allocated, nothing
computed), then report per-device memory, the per-device counts of
``launch/hlo_analysis.py`` and the three roofline terms with the H100's
constants (``launch/mesh.py``) — the port of ``repro.launch.dryrun``.

The mesh lives on a ``fake`` process group of 256 (512) ranks that this
process joins as rank 0 for the cell and leaves after it: collectives
return at once and move nothing, and the trace counts what rank 0's
program would do. The parameters (and, for ``train``, the AdamW state)
are meta DTensors placed by the logical-axis rules, the batch is sharded
on ``act_batch``, and the step runs under ``implicit_replication`` (plain
tensors such as RoPE tables count as replicated) with the rules'
``ShardCtx`` active. The kernels' wrappers give outputs of their shapes
on meta tensors and run on each device's shards of a DTensor.

Memory: the argument bytes are the local shards' bytes, exactly; the
peak is the most bytes live at once over the trace (storages of the
arguments and of every op's outputs, freed when the last reference goes:
the eager port's own lifetimes, ``hlo_analysis.Trace``).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both]
  python -m repro_torch.launch.dryrun --arch ... --set mla_absorb=True --variant absorb
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
MESH_DEVICES = {"single": 256, "multi": 512, "host": 1}
RING_PAGE = 512     # ring page size, cut to a divisor of every ring


def _parse_set(kvs):
    out = {}
    for kv in kvs or []:
        k, v = kv.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def _mesh(mesh_kind: str):
    from repro_torch.launch import mesh as meshmod
    if mesh_kind == "host":
        return meshmod.make_host_mesh()
    return meshmod.make_production_mesh(multi_pod=(mesh_kind == "multi"))


def run_cell(arch: str, shape_name: str, mesh_kind: str, variant: str = "base",
             overrides=None, rules_name: str = "default", zero1: bool = False,
             fsdp: bool = False, verbose: bool = True, shape=None) -> dict:
    """One cell. ``mesh_kind``: "single" (16 x 16), "multi" (2 x 16 x 16)
    or "host" (1 x 1). ``shape``: a ``ShapeConfig`` to run in place of the
    registered ``shape_name``."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import mesh as meshmod
    from repro_torch.launch.hlo_analysis import Trace, roofline_terms

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape or get_shape(shape_name)
    n_dev = MESH_DEVICES[mesh_kind]
    t0 = time.time()
    trace = Trace()
    if n_dev == 1:
        # nothing to place on one device: plain meta tensors are its program
        step, args = _build(cfg, shape, {"data": 1, "model": 1}, rules_name,
                            zero1, fsdp)
        arg_bytes = trace.hold(args)
        with trace:
            out = step(*args)
        mem = _memory(trace, args, out)
    else:
        with meshmod.fake_world(n_dev):
            mesh = _mesh(mesh_kind)
            step, args = _build(cfg, shape, mesh, rules_name, zero1, fsdp)
            arg_bytes = trace.hold(args)
            trace_fn = _traced(step, mesh, rules_name)
            with trace:
                out = trace_fn(*args)
            mem = _memory(trace, args, out)
    del args, step, out
    t_trace = time.time() - t0
    ana = trace.result()
    rt = roofline_terms(ana, peak_flops=meshmod.PEAK_FLOPS_BF16,
                        hbm_bw=meshmod.HBM_BW, ici_bw=meshmod.NVLINK_BW)

    counts = cfg.param_counts()
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S if shape.kind in ("train", "prefill") else B
    model_flops = (6 if shape.kind == "train" else 2) * counts["active"] * tokens
    flops_global = ana["flops"] * n_dev
    peak = trace.peak_bytes
    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind, "variant": variant,
        "n_devices": n_dev, "ok": True,
        "trace_s": round(t_trace, 1),
        "memory": {**mem, "fits_80gb": bool(peak <= meshmod.HBM_BYTES)},
        "hlo_analysis": {k: ana[k] for k in
                         ("flops", "dot_flops", "elementwise_flops",
                          "transcendentals", "bytes_accessed",
                          "collective_operand_bytes", "collective_wire_bytes")},
        "kernels": ana["kernels"],
        "collectives": ana["collectives"],
        "roofline": rt,
        "model_flops": {
            "params_total": counts["total"],
            "params_active": counts["active"],
            "tokens_per_step": tokens,
            "model_flops": model_flops,
            "hlo_flops_global": flops_global,
            "useful_ratio": model_flops / flops_global if flops_global else None,
        },
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape.name} x {mesh_kind} ({variant}): "
              f"trace {t_trace:.0f}s mem/dev {peak / 1e9:.2f} GB "
              f"(args {arg_bytes / 1e9:.2f} GB) "
              f"terms c/m/x = {rt['compute_s']:.2e}/{rt['memory_s']:.2e}/"
              f"{rt['collective_s']:.2e}s dom={rt['dominant']}", flush=True)
    return result


def _storages(tree) -> dict:
    """{storage id: bytes} of the tensors of ``tree`` (DTensors' shards)."""
    from repro_torch.launch.hlo_analysis import _tensors
    from repro_torch.runtime.sharding import is_dtensor
    out = {}
    for t in _tensors(tree):
        s = (t.to_local() if is_dtensor(t) else t).untyped_storage()
        out[id(s)] = s.nbytes()
    return out


def _memory(trace, args, out) -> dict:
    """The reference's memory keys, per device: arguments (the local
    shards), outputs, outputs written in place into arguments (alias),
    temporaries at the peak (peak - arguments), and ``per_device_gib`` =
    the peak of live bytes."""
    arg, res = _storages(args), _storages(out)
    gib = 2 ** 30
    return {"argument_gib": sum(arg.values()) / gib,
            "output_gib": sum(res.values()) / gib,
            "temp_gib": (trace.peak_bytes - sum(arg.values())) / gib,
            "alias_gib": sum(n for k, n in res.items() if k in arg) / gib,
            "per_device_gib": trace.peak_bytes / gib}


def _traced(step, mesh, rules_name):
    """``step`` under the rules' ``ShardCtx`` and ``implicit_replication``."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.runtime import sharding as shd
    rules = shd.SEQUENCE_PARALLEL_RULES if rules_name == "sp" else shd.DEFAULT_RULES

    def run(*args):
        with shd.ShardCtx(mesh, rules), implicit_replication():
            return step(*args)
    return run


def _build(cfg, shape, mesh, rules_name, zero1, fsdp):
    """(step, its abstract arguments) of one cell: meta DTensors on a
    DeviceMesh, plain meta tensors on a one-device ``{name: 1}`` mesh."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.frontends import input_specs
    from repro_torch.models import param as prm
    from repro_torch.optim import OptConfig, opt_state_defs
    from repro_torch.runtime import sharding as shd
    from repro_torch.train import make_train_step

    rules = shd.SEQUENCE_PARALLEL_RULES if rules_name == "sp" else shd.DEFAULT_RULES
    defs = tfm.model_defs(cfg)
    placed = not isinstance(mesh, dict)

    def abstract(defs, dtype, zero=False):
        if not placed:
            return prm.abstract(defs, dtype)
        specs = shd.param_partition_specs(defs, mesh, rules)
        if zero:
            specs = _zero1(specs, defs, mesh)
        return prm.abstract(defs, dtype, _placements(specs, mesh), mesh)

    params = abstract(defs, cfg.param_dtype, fsdp)  # fsdp: 2D (model x data) weights

    def batch_of(specs: dict) -> dict:
        if not placed:
            return specs
        out = {}
        for k, t in specs.items():
            axes = ("act_batch",) + (None,) * (t.dim() - 1)
            spec = shd.spec_for(axes, t.shape, mesh, rules)
            out[k] = shd.abstract_tensor(tuple(t.shape), t.dtype, mesh,
                                         shd.placements_for(spec, mesh))
        return out

    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt = abstract(opt_state_defs(defs), "float32", zero1 or fsdp)
        return make_train_step(cfg, OptConfig()), (params, opt, batch_of(input_specs(cfg, shape)))
    page = _ring_page(cfg, S)
    if shape.kind == "prefill":
        def step(params, batch):
            return tfm.prefill(cfg, params, batch, page_tokens=page)
        return step, (params, batch_of(input_specs(cfg, shape)))
    caches = (_abstract_caches(cfg, mesh, rules, B, S) if placed
              else tfm.init_caches(cfg, B, S, device="meta"))
    from repro_torch.models.frontends import token_shape
    tok = torch.empty(token_shape(cfg, B, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((B,), dtype=torch.int32, device="meta")
    inputs = batch_of({"last_tokens": tok, "cur_pos": pos})

    def step(params, caches, last_tokens, cur_pos):
        return tfm.decode(cfg, params, caches, last_tokens, cur_pos, page_tokens=page)
    return step, (params, caches, inputs["last_tokens"], inputs["cur_pos"])


def _placements(specs, mesh):
    from repro_torch.models.param import tree_map
    from repro_torch.runtime import sharding as shd
    return tree_map(lambda sp: shd.placements_for(sp, mesh), specs, is_leaf=_is_spec)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and all(
            isinstance(f, str) for f in e)) for e in x)


def _ring_page(cfg, max_len: int) -> int:
    """The ring page size: ``RING_PAGE`` cut to divide every ring."""
    from repro_torch.models.attention import cache_len_for
    page = RING_PAGE
    for spec in cfg.layer_specs():
        page = math.gcd(page, cache_len_for(spec.window, max_len))
    return page


def _zero1(ospecs, odefs, mesh):
    """Extend optimizer-state specs: shard the first unsharded divisible dim
    over the data axis (ZeRO-1)."""
    from repro_torch.models.param import is_def, tree_map
    from repro_torch.runtime.sharding import mesh_sizes

    dsz = mesh_sizes(mesh).get("data", 1)

    def extend(d, spec):
        if not d.shape:
            return spec
        parts = list(spec) + [None] * (len(d.shape) - len(spec))
        for i, dim in enumerate(d.shape):
            if parts[i] is None and dim % dsz == 0 and dsz > 1:
                parts[i] = "data"
                return tuple(parts)
        return spec

    specs = iter(_spec_leaves(ospecs))
    return tree_map(lambda d: extend(d, next(specs)), odefs, is_leaf=is_def)


def _spec_leaves(tree):
    if _is_spec(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [x for t in tree for x in _spec_leaves(t)]


def _abstract_caches(cfg, mesh, rules, batch: int, max_len: int):
    """The ring caches as meta DTensors, each leaf placed as the
    reference's ``_abstract_caches`` places its counterpart (the leading
    dim is the stacked layers; ``ShardCtx.cache_axes``)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import sharding as shd
    caches = tfm.init_caches(cfg, batch, max_len, device="meta")
    return shd.place_caches(shd.ShardCtx(mesh, rules), cfg, caches)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


def all_cells(mesh_kinds):
    from repro_torch.configs import ASSIGNED_ARCHS, cells

    for mesh_kind in mesh_kinds:
        for arch, shape_name in cells(ASSIGNED_ARCHS):
            yield arch, shape_name, mesh_kind


def orchestrate(mesh_kinds, skip_existing=True, timeout=7200, archs=None, shapes=None):
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    results = []
    todo = [c for c in all_cells(mesh_kinds)
            if (archs is None or c[0] in archs) and (shapes is None or c[1] in shapes)]
    src = str(pathlib.Path(__file__).resolve().parents[2])
    for i, (arch, shape_name, mesh_kind) in enumerate(todo):
        out = ARTIFACTS / f"{arch}__{shape_name}__{mesh_kind}__base.json"
        if skip_existing and out.exists():
            print(f"[{i+1}/{len(todo)}] skip (exists): {out.name}")
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape_name, "--mesh", mesh_kind, "--out", str(out)]
        print(f"[{i+1}/{len(todo)}] {' '.join(cmd[2:])}", flush=True)
        t0 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                           env=dict(os.environ, PYTHONPATH=src))
        dt = time.time() - t0
        if r.returncode != 0:
            fail = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "ok": False, "error": r.stderr[-4000:], "wall_s": dt}
            out.write_text(json.dumps(fail, indent=1))
            print(f"  FAILED after {dt:.0f}s; tail:\n{r.stderr[-1500:]}", flush=True)
        else:
            print(f"  ok in {dt:.0f}s", flush=True)
        results.append(out)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="base")
    ap.add_argument("--set", nargs="*", help="config overrides key=value")
    ap.add_argument("--rules", default="default", choices=["default", "sp"])
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--fsdp", action="store_true",
                    help="2D (model x data) weight sharding (ZeRO-3-style)")
    ap.add_argument("--out")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", nargs="*")
    ap.add_argument("--shapes", nargs="*")
    ap.add_argument("--no-skip", action="store_true")
    args = ap.parse_args()

    if args.all:
        kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        orchestrate(kinds, skip_existing=not args.no_skip,
                    archs=args.archs, shapes=args.shapes)
        return

    res = run_cell(args.arch, args.shape, args.mesh, variant=args.variant,
                   overrides=_parse_set(args.set), rules_name=args.rules,
                   zero1=args.zero1, fsdp=args.fsdp)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
