"""Pieces the plain references share: fp32 matrix products with TF32 off
(or, for the control, fp8 e4m3 operands with per-row and per-column
scales) and RMSNorm with the (1 + g) gain, written from the published
equations in plain ``torch``. Imports nothing of the program under test."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0   # largest finite float8_e4m3fn


@contextlib.contextmanager
def exact_fp32():
    """fp32 products in fp32: TF32 off for the duration, as it was after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def fp8_round(t, dim: int):
    """``t`` rounded to float8_e4m3fn with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in fp32."""
    t = t.float()
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Linear:
    """``x @ w`` for x (..., k) and w (k, n): in fp32 (``"fp32"``), with
    both operands rounded to fp8 e4m3 first (``"fp8"``: x per row, w per
    output column; the products summed in fp32), or in fp64 (``"fp64"``,
    the whole forward then carried in fp64). ``dtype`` is the precision
    the rest of the forward is carried in."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8", "fp64"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"
        self.dtype = torch.float64 if precision == "fp64" else torch.float32

    def __call__(self, x, w):
        x, w = x.to(self.dtype), w.to(self.dtype)
        if self.fp8:
            x, w = fp8_round(x, -1), fp8_round(w, 0)
        return x @ w


def wide(x):
    """x in fp32, or fp64 if it is already."""
    return x if x.dtype == torch.float64 else x.float()


def rmsnorm(x, g, eps: float):
    x = wide(x)
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + g.to(x.dtype))
