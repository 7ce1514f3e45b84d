"""Production meshes and the H100's roofline constants (the port of
``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and creates no process group. A mesh needs a default process group
of its size; the dry run makes one on the ``fake`` backend
(``fake_world``), which moves no data, and destroys it when it leaves.
"""
from __future__ import annotations

import contextlib


def _mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 devices per pod; 2 pods = 512 devices with a leading
    'pod' axis. Needs a default process group of 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh():
    """One-device mesh (a group of one rank) with the production axis
    names."""
    return _mesh((1, 1), ("data", "model"))


@contextlib.contextmanager
def fake_world(size: int):
    """A default process group of ``size`` ranks on the ``fake`` backend
    (this process is rank 0; collectives return at once and move
    nothing), destroyed on exit. Refuses to stack on a live group."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers "fake")
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# NVIDIA H100 SXM5 80 GB, per GPU, from NVIDIA's H100 Tensor Core GPU
# datasheet: datasheet figures, not measurements. A 16-wide model axis spans
# two 8-GPU NVLink nodes on a real H100 cluster, so part of its traffic
# crosses the slower inter-node network: the collective term computed from
# NVLINK_BW is then a lower bound.
PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12              # HBM3 bytes/s
NVLINK_BW = 450e9             # NVLink bytes/s per direction (900 GB/s in total)
HBM_BYTES = 80e9              # device memory
