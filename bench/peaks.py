"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's H100 Tensor
Core GPU datasheet, dense rates at the full 700 W power limit): a frozen
copy of ``repro_torch/launch/mesh.py``'s constants and ``chip_smoke.py``'s
``PEAK_FLOPS`` / ``HBM_BYTES_S``, kept here so that no later change to the
program moves the yardstick."""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 / fp32 (no TF32)
PEAK_FLOPS_BF16 = PEAK_FLOPS["bfloat16"]
HBM_BYTES_S = 3.35e12                                 # HBM3 bytes/s


def bound_s(flops: float, n_bytes: float, dtype_name: str = "bfloat16") -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate and bytes over the HBM bandwidth (``chip_smoke._bound``)."""
    return max(n_bytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype_name])
