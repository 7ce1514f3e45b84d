"""The port's logical-axis rules (``repro_torch.runtime.sharding``) against
the reference's (``repro.runtime.sharding``) on the production meshes:
specs, fallbacks, optimizer-state and ZeRO-1/FSDP specs of every
registered config under both rule sets, the KV-cache policy and each
decode cell's per-device cache bytes, the reference's divisibility
properties, and DTensor placements on a fake mesh."""
import math
import os

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import jax
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import REGISTRY as REF_REGISTRY, get_config as ref_config
from repro.models import transformer as ref_tfm
from repro.optim import opt_state_defs as ref_opt_state_defs
from repro.runtime import sharding as ref_shd
from repro_torch.configs import ASSIGNED_ARCHS, REGISTRY, SHAPES, cells, get_config
from repro_torch.launch import dryrun, mesh as meshmod
from repro_torch.models import transformer as tfm
from repro_torch.optim import opt_state_defs
from repro_torch.runtime import sharding as shd

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"default": (shd.DEFAULT_RULES, ref_shd.DEFAULT_RULES),
         "sp": (shd.SEQUENCE_PARALLEL_RULES, ref_shd.SEQUENCE_PARALLEL_RULES)}
ARCHS = sorted(REF_REGISTRY)


def _ref_zero1():
    """The reference dry run's ``_zero1``, imported without keeping the
    device-count flag its module sets for JAX."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _abstract_caches, _zero1
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return _zero1, _abstract_caches


def _abstract_mesh(kind):
    sizes, names = MESHES[kind]
    try:  # jax >= 0.5: AbstractMesh(axis_sizes, axis_names)
        return AbstractMesh(sizes, names)
    except TypeError:  # jax 0.4.x: AbstractMesh(((name, size), ...))
        return AbstractMesh(tuple(zip(names, sizes)))


def _sizes(kind):
    sizes, names = MESHES[kind]
    return dict(zip(names, sizes))


def _ref_rows(specs):
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


def _port_rows(specs):
    return [(p, tuple(s)) for p, s in shd.tree_paths(specs, is_leaf=dryrun._is_spec)]


# ---------------------------------------------------------------------------
# Specs and fallbacks of every config
# ---------------------------------------------------------------------------


def test_registries_agree():
    assert sorted(REGISTRY) == ARCHS


def test_spec_for_basic():
    single, multi = _sizes("single"), _sizes("multi")
    assert shd.spec_for(("vocab", "embed"), (256000, 4096), single) == ("model", None)
    assert shd.spec_for(("act_batch", None), (256, 4096), single) == ("data", None)
    assert shd.spec_for(("act_batch", None), (256, 4096), multi) == (("pod", "data"), None)
    # 8 heads don't divide the 16-way model axis; a batch of one falls back
    assert shd.spec_for(("embed", "heads", "head_dim"), (2048, 8, 256), single) == \
        (None, None, None)
    assert shd.spec_for(("act_batch", "act_kv_seq"), (1, 524288), single) == (None, "model")


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_explain_specs_match_reference(arch, kind, rules):
    """Every parameter leaf: path, shape, logical axes, spec and fallback
    strings as the reference lists them, and ``param_partition_specs``."""
    port_rules, ref_rules = RULES[rules]
    amesh, sizes = _abstract_mesh(kind), _sizes(kind)
    ref_defs, defs = ref_tfm.model_defs(ref_config(arch)), tfm.model_defs(get_config(arch))
    ref_rows = [(p, tuple(s), tuple(a), tuple(sp), f) for p, s, a, sp, f in
                ref_shd.explain_specs(ref_defs, amesh, ref_rules)]
    rows = [(p, tuple(s), tuple(a), sp, f) for p, s, a, sp, f in
            shd.explain_specs(defs, sizes, port_rules)]
    assert rows == ref_rows
    assert _port_rows(shd.param_partition_specs(defs, sizes, port_rules)) == \
        _ref_rows(ref_shd.param_partition_specs(ref_defs, amesh, ref_rules))


@pytest.mark.parametrize("zero", ["none", "zero1"])
@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_and_fsdp_specs_match_reference(arch, kind, zero):
    """AdamW state specs (fp32 moments and the step), with and without the
    ZeRO-1 extension, and the FSDP parameter specs."""
    ref_zero1, _ = _ref_zero1()
    amesh, sizes = _abstract_mesh(kind), _sizes(kind)
    ref_defs, defs = ref_tfm.model_defs(ref_config(arch)), tfm.model_defs(get_config(arch))
    ref_odefs, odefs = ref_opt_state_defs(ref_defs), opt_state_defs(defs)
    ref_specs = ref_shd.param_partition_specs(ref_odefs, amesh)
    specs = shd.param_partition_specs(odefs, sizes)
    if zero == "zero1":
        ref_specs, specs = ref_zero1(ref_specs, ref_odefs, amesh), dryrun._zero1(specs, odefs, sizes)
    assert _port_rows(specs) == _ref_rows(ref_specs)
    ref_f = ref_zero1(ref_shd.param_partition_specs(ref_defs, amesh), ref_defs, amesh)
    assert _port_rows(dryrun._zero1(shd.param_partition_specs(defs, sizes), defs, sizes)) == \
        _ref_rows(ref_f)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_kv_axes_match_reference(arch, kind):
    ref = ref_shd.ShardCtx(_abstract_mesh(kind)).kv_axes(ref_config(arch))
    assert shd.ShardCtx(_sizes(kind)).kv_axes(get_config(arch)) == ref


DECODE_CELLS = [(a, s) for a, s in cells(ASSIGNED_ARCHS) if SHAPES[s].kind == "decode"]


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_cache_bytes_per_device_match_reference(arch, shape, kind):
    """The fused ring ``kv`` (B, C, 2*Hkv, D) holds the reference's ``k`` +
    ``v`` bytes on every device, the latent ``ckr`` its ``c`` + ``kr``, and
    SSM ``conv`` / ``state`` and every ``pos`` theirs."""
    _, ref_abstract = _ref_zero1()
    B, S = SHAPES[shape].global_batch, SHAPES[shape].seq_len
    amesh = _abstract_mesh(kind)
    ref = ref_abstract(ref_config(arch), ref_shd.ShardCtx(amesh), amesh,
                       ref_shd.DEFAULT_RULES, B, S)
    ref_bytes = {}
    for path, sds in jax.tree_util.tree_flatten_with_path(ref)[0]:
        name = str(path[-1].key)
        group = {"k": "kv", "v": "kv", "c": "ckr", "kr": "ckr"}.get(name, name)
        n = math.prod(sds.sharding.shard_shape(sds.shape)) * sds.dtype.itemsize
        ref_bytes[group] = ref_bytes.get(group, 0) + n
    sizes, names = MESHES[kind]
    with meshmod.fake_world(math.prod(sizes)):
        mesh = meshmod.make_production_mesh(multi_pod=kind == "multi")
        caches = dryrun._abstract_caches(get_config(arch), mesh, shd.DEFAULT_RULES, B, S)
        got = {}
        for path, t in shd.tree_paths(caches):
            name = path.rsplit("['", 1)[-1].rstrip("']")
            got[name] = got.get(name, 0) + t.to_local().numel() * t.element_size()
    assert got == ref_bytes


def test_kv_ring_head_split_keeps_pairs():
    """An even split of the fused 2*Hkv axis gives each device whole
    (K, V) pairs: head h's key at 2h and value at 2h+1 land together."""
    from repro_torch.kernels.paged_attention import interleave_kv
    B, C, Hkv, D = 2, 4, 16, 3
    k = torch.arange(B * C * Hkv * D, dtype=torch.float32).reshape(B, C, Hkv, D)
    v = -k
    ring = interleave_kv(k, v)
    for part, chunk in enumerate(ring.chunk(16, dim=2)):
        heads = chunk.shape[2] // 2
        for j in range(heads):
            h = part * heads + j
            assert torch.equal(chunk[:, :, 2 * j], k[:, :, h])
            assert torch.equal(chunk[:, :, 2 * j + 1], v[:, :, h])


# ---------------------------------------------------------------------------
# The reference's properties, on both meshes
# ---------------------------------------------------------------------------

AXES = [None, "vocab", "heads", "ff", "experts", "act_batch", "act_kv_seq"]


def _check_spec(axes, dims, sizes):
    spec = shd.spec_for(axes, dims, sizes)
    used = [a for part in spec for a in ((part,) if isinstance(part, str) else (part or ()))]
    assert len(used) == len(set(used))
    for part, dim in zip(spec, dims):
        if part is not None:
            assert dim % shd.mesh_axis_size(sizes, shd._axes_tuple(part)) == 0
    return spec


@pytest.mark.parametrize("kind", sorted(MESHES))
@given(st.lists(st.sampled_from(AXES), min_size=1, max_size=4),
       st.lists(st.integers(min_value=1, max_value=4096), min_size=4, max_size=4))
@settings(max_examples=100, deadline=None)
def test_spec_for_always_divides_never_reuses(kind, axes, dims):
    _check_spec(axes, dims[:len(axes)], _sizes(kind))


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_spec_for_properties_seeded(kind):
    """The same properties over 400 seeded draws, each spec equal to the
    reference's."""
    rng = np.random.default_rng(0)
    amesh, sizes = _abstract_mesh(kind), _sizes(kind)
    for _ in range(400):
        n = int(rng.integers(1, 5))
        axes = [AXES[i] for i in rng.integers(0, len(AXES), n)]
        dims = [int(2 ** rng.integers(0, 13) * rng.choice([1, 3, 5, 25]))
                for _ in range(n)]
        spec = _check_spec(axes, dims, sizes)
        assert spec == tuple(ref_shd.spec_for(axes, dims, amesh))


# ---------------------------------------------------------------------------
# DTensor placements on a fake mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_placements_follow_spec_on_fake_mesh(kind):
    """Shard(d) exactly on the mesh dims the spec names for dim d, the
    local shard of the spec's shape, on every leaf of a config."""
    from torch.distributed.tensor import Shard
    sizes, names = MESHES[kind]
    with meshmod.fake_world(math.prod(sizes)):
        mesh = meshmod.make_production_mesh(multi_pod=kind == "multi")
        for _, shape, axes, spec, _ in shd.explain_specs(
                tfm.model_defs(get_config("mixtral-8x22b")), mesh):
            pl = shd.placements_for(spec, mesh)
            for name, p in zip(names, pl):
                dims = [d for d, e in enumerate(spec) if name in shd._axes_tuple(e)]
                assert (p == Shard(dims[0])) if dims else p.is_replicate()
            t = shd.abstract_tensor(shape, torch.bfloat16, mesh, pl)
            assert tuple(t.shape) == tuple(shape)
            split = [math.prod(sizes[names.index(a)] for a in shd._axes_tuple(e))
                     for e in spec]
            assert tuple(t.to_local().shape) == tuple(n // k for n, k in zip(shape, split))
        assert shd.placements_for((("pod", "data"), None), mesh)[:len(names) - 1] == \
            tuple(Shard(0) for _ in names[:-1])
