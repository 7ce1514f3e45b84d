"""Wrappers for the Hopper SSD chunk-scan kernels (``csrc/ssd_scan.cu``).

``ssd_scan`` checks its inputs, allocates y and the final state and
launches the forward kernel on the current CUDA stream; ``ssd_scan_bwd``
allocates the gradients and scratch and launches the backward kernels
(three launches in either dtype).
``SSDScan`` is the autograd function of the training path: ``ssd_scan``
forward, ``ssd_scan_bwd`` backward. Tensors on the CPU take the plain
versions (``ref.ssd_scan_ref``, ``ref.ssd_scan_bwd_ref``); a CUDA tensor
launches the kernels or raises — there is no fallback. Each launch adds
one to the wrapper's ``launches``.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch

from .ref import ssd_scan_bwd_ref, ssd_scan_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_STATE = 256
BLOCK = 32                 # the kernels' token block


def _function(name: str, argtypes: list):
    """``name`` of the kernel library, with its C signature declared."""
    from repro_torch.kernels import _build
    fn = getattr(_build.load(str(SOURCE)), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = ([_P] * 8                # x dt a b c init y final
             + [_I] * 6              # B S H P G N
             + [_L] * 6              # x/b/c batch and seq strides
             + [_I, _P])             # dtype stream
_BWD_ARGS = ([_P] * 18               # inputs, scratch and gradients
             + [_I] * 6 + [_L] * 6 + [_I, _P])


def bwd_smem_bytes(P: int, N: int, dtype: torch.dtype) -> int:
    """Shared memory of the backward's largest CTA at (P, N) for x's
    ``dtype``, as the kernel library computes it: the fp32 backward
    kernel's (all of P at once) or the bf16 gradients kernel's (the S0 and
    dS hi / lo planes of two heads, or of one where two do not fit). Its
    launcher refuses a (P, N) whose CTA would not fit in Hopper's 227 KB."""
    fn = _function("ssd_scan_bwd_smem_bytes", [_I, _I, _I])
    fn.restype = ctypes.c_longlong
    return fn(P, N, _DTYPES[dtype])


def _check(x, dt, a, b, c, init_state):
    """Device, dtype, shape and layout checks of the scan's inputs, and
    for bf16 the tensor-core kernels' tile and alignment rules."""
    dev = x.device
    named = (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c))
    if init_state is not None:
        named += (("init_state", init_state),)
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x/b/c dtypes {x.dtype}/{b.dtype}/{c.dtype}: all "
                        "float32 or all bfloat16")
    for name, t in (("dt", dt), ("a", a), ("init_state", init_state)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError("x (B, S, H, P), b and c (B, S, G, N)")
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if b.shape[:2] != (B, S) or G == 0 or H % G:
        raise ValueError(f"b/c {tuple(b.shape)} do not match x {tuple(x.shape)}")
    if dt.shape != (B, S, H) or a.shape != (H,):
        raise ValueError(f"dt must be (B, S, H) = {(B, S, H)} and a (H,)")
    if init_state is not None and init_state.shape != (B, H, P, N):
        raise ValueError(f"init_state must be (B, H, P, N) = {(B, H, P, N)}")
    if S < 1 or not 0 < N <= _MAX_STATE or B * H > 65535:
        raise ValueError(f"S {S} must be >= 1, N {N} in (0, {_MAX_STATE}] "
                         f"and B*H {B * H} <= 65535")
    # x, b, c may be views into a wider projection: only their (H, P) and
    # (G, N) inner dimensions need be dense
    if x.stride(3) != 1 or x.stride(2) != P:
        raise ValueError("x must be dense over (H, P)")
    for name, t in (("b", b), ("c", c)):
        if t.stride(3) != 1 or t.stride(2) != N:
            raise ValueError(f"{name} must be dense over (G, N)")
    for name, t in (("dt", dt), ("a", a), ("init_state", init_state)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype == torch.bfloat16:
        _check_tensor_core_tiles(x, b, c, init_state)


def _check_bwd(x, dt, a, b, c, dy, init_state, d_final):
    """``_check``, and dy and d_final; the bf16 backward takes the
    forward's tiles, and copies dy's rows and d_final whole."""
    _check(x, dt, a, b, c, init_state)
    if dy.device != x.device or dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)} in {x.dtype} on "
                         f"{x.device}, got {tuple(dy.shape)} {dy.dtype} {dy.device}")
    if d_final is not None:
        want = (x.shape[0], x.shape[2], x.shape[3], b.shape[3])
        if (d_final.device != x.device or d_final.dtype != torch.float32
                or d_final.shape != want or not d_final.is_contiguous()):
            raise ValueError(f"d_final must be a contiguous float32 {want}")
    if x.dtype == torch.bfloat16:
        for name, t in (("dy", dy), ("d_final", d_final)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"bf16: {name} must start 16-byte aligned")


def _check_tensor_core_tiles(x, b, c, init_state):
    """What the bf16 kernels add: 16-row P tiles and 16-deep k-steps over
    N and P, and every row they copy (x, b, c by 16-byte cp.async or bulk
    copies, the state by bulk copies) starting on a 16-byte boundary."""
    P, N = x.shape[3], b.shape[3]
    if P % 16 or N % 16:
        raise ValueError(f"bf16: P {P} and N {N} must be multiples of 16")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8:
            raise ValueError(f"bf16: {name}'s rows must start 16-byte aligned "
                             f"(data_ptr % 16, batch and sequence strides "
                             f"{t.stride(0)}, {t.stride(1)} multiples of 8)")
    if init_state is not None and init_state.data_ptr() % 16:
        raise ValueError("bf16: init_state must start 16-byte aligned")


def ssd_scan(x, dt, a, b, c, *, chunk: int,
             init_state: Optional[torch.Tensor] = None):
    """Mamba2 SSD scan in the model layout, continuing from ``init_state``.

    x: (B, S, H, P) fp32 or bf16; dt: (B, S, H) fp32 (post-softplus);
    a: (H,) fp32, negative; b/c: (B, S, G, N) in x's dtype, H % G == 0;
    ``init_state``: (B, H, P, N) fp32, or None for zeros. Returns (y
    (B, S, H, P) in x's dtype, final state (B, H, P, N) fp32). ``chunk``
    is the plain version's chunk length (``ssm_chunk``); either kernel
    walks the sequence in 32-token blocks of its own, one CTA per 16 rows
    of P, and sums in a fixed order (two launches are bit-equal). fp32 runs
    the FMA kernel and agrees with the plain version within fp32 rounding
    (2e-4 is the stated tolerance). bf16 runs the tensor-core kernel: exact
    bf16 products with its fp32 operands (the decay-weighted C·Bᵀ, the
    state, x·w) split into bf16 hi + lo, so the state keeps about 16 bits
    of mantissa per term and agrees within the same 2e-4, and y within two
    bf16 ulps; it needs P and N in multiples of 16 and 16-byte aligned
    rows (``_check_tensor_core_tiles``)."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a, b, c, chunk=chunk, init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan for device {x.device}")
    _check(x, dt, a, b, c, init_state)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    fn = _function("ssd_scan_launch", _FWD_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), None if init_state is None else init_state.data_ptr(),
                y.data_ptr(), final.data_ptr(), B, S, H, P, G, N,
                x.stride(0), x.stride(1), b.stride(0), b.stride(1),
                c.stride(0), c.stride(1), _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0


def ssd_scan_bwd(x, dt, a, b, c, dy, *, chunk: int,
                 init_state: Optional[torch.Tensor] = None,
                 d_final: Optional[torch.Tensor] = None):
    """Gradients of ``ssd_scan`` given the cotangents ``dy`` (x's shape and
    dtype) of y and ``d_final`` (B, H, P, N) fp32 of the final state (None:
    zeros). Returns (dx, d_dt, d_a, db, dc, d_init): dx, db, dc dense in
    x's dtype, d_dt (B, S, H), d_a (H,) and d_init (B, H, P, N) in fp32.

    On CUDA three launches (``csrc/ssd_scan.cu``), every sum in a fixed
    order (two launches are bit-equal). bf16, on the tensor cores (the
    forward's tile rules, ``_check_tensor_core_tiles``): the states kernel
    runs both block-to-block recurrences at once and writes the state at
    every 32-token block's start and its cotangent at the block's end, each
    split into bf16 hi + lo, (2, B, ceil(S/32), H, 2, P, N) scratch (the
    bytes of fp32), and d_init; the gradients kernel, one CTA per (batch,
    block, group) over the group's heads, writes dx, d_dt, db and dc
    (summed over the heads in fp32, no per-head copies) and (batch, block,
    head) partials of d(a), which the last launch sums. fp32, FMAs on the CUDA cores: the states kernel writes the
    block-start states (B, ceil(S/32), H, P, N); the backward kernel, one
    CTA per (batch, head), walks the blocks last to first and writes dx,
    d_dt, d_init and per-head fp32 partials of db, dc (B, S, H, N) and
    d(a), which the reduce kernel sums. x, b and c may be the forward's
    strided projection views; dy is made dense. The kernels walk 32-token
    blocks where the plain version walks ``chunk``-token chunks, so they
    agree within rounding."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_ref(x, dt, a, b, c, dy, chunk=chunk,
                                init_state=init_state, d_final=d_final)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan_bwd for device {x.device}")
    dy = dy.contiguous()
    _check_bwd(x, dt, a, b, c, dy, init_state, d_final)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    dev, f32 = x.device, torch.float32
    nb = -(-S // BLOCK)
    if x.dtype == torch.bfloat16:     # S0 and dS as hi, lo; d(a) per (batch, block, head)
        states = torch.empty((2, B, nb, H, 2, P, N), dtype=x.dtype, device=dev)
        d_a_part = torch.empty((B, nb, H), dtype=f32, device=dev)
        db_part = dc_part = None
    else:
        states = torch.empty((B, nb, H, P, N), dtype=f32, device=dev)
        d_a_part = torch.empty((B, H), dtype=f32, device=dev)
        db_part = torch.empty((B, S, H, N), dtype=f32, device=dev)
        dc_part = torch.empty((B, S, H, N), dtype=f32, device=dev)
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    d_dt = torch.empty((B, S, H), dtype=f32, device=dev)
    d_init = torch.empty((B, H, P, N), dtype=f32, device=dev)
    db = torch.empty((B, S, G, N), dtype=x.dtype, device=dev)
    dc = torch.empty((B, S, G, N), dtype=x.dtype, device=dev)
    d_a = torch.empty((H,), dtype=f32, device=dev)
    fn = _function("ssd_scan_bwd_launch", _BWD_ARGS)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(ptr(t) for t in (x, dt, a, b, c, init_state, dy, d_final, states,
                                   dx, d_dt, d_a_part, db_part, dc_part, d_init,
                                   db, dc, d_a)),
                B, S, H, P, G, N, x.stride(0), x.stride(1), b.stride(0),
                b.stride(1), c.stride(0), c.stride(1), _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {rc}")
    ssd_scan_bwd.launches += 1
    return dx, d_dt, d_a, db, dc, d_init


ssd_scan_bwd.launches = 0


class SSDScan(torch.autograd.Function):
    """The SSD scan with its backward: ``SSDScan.apply(x, dt, a, b, c,
    init_state, chunk) -> (y, final_state)``. The forward is ``ssd_scan``
    and saves its inputs; the backward is ``ssd_scan_bwd``, which
    recomputes the block-start states (and, in bf16, their cotangents)
    into scratch. ``init_state`` may be None (zeros; its gradient is then
    None), and either cotangent may be None."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, init_state, chunk):
        y, final = ssd_scan(x, dt, a, b, c, chunk=chunk, init_state=init_state)
        ctx.save_for_backward(x, dt, a, b, c, init_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, a, b, c, init_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, d_dt, d_a, db, dc, d_init = ssd_scan_bwd(
            x, dt, a, b, c, dy, chunk=ctx.chunk, init_state=init_state,
            d_final=None if d_final is None else d_final.contiguous())
        return dx, d_dt, d_a, db, dc, (None if init_state is None else d_init), None
