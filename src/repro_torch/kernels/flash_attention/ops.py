"""Wrappers for the Hopper flash-attention kernels
(``csrc/flash_attention.cu``) and the autograd function over them.

- ``flash_attention_fwd`` -> (out, m, l): the forward kernel;
- ``flash_attention_bwd_dkdv`` / ``flash_attention_bwd_dq``: the two
  backward kernels; ``dkdv_plan`` is the bf16 dK/dV kernel's plan of work
  units (key tile, row range, partial slot);
- ``flash_attention_bwd`` -> (dq, dk, dv): delta = rowsum(dO * O) in plain
  torch (as the JAX package computes it in jnp), then both kernels;
- ``FlashAttention``: ``torch.autograd.Function`` saving q, k, v, out, m, l.

q and k share a head dim Dk, v has its own Dv: the kernels take (D, D)
for D in {32, 64, 128, 256} and (192, 128), deepseek-v2-lite's un-absorbed
MLA training shape ([k_nope, k_rope] 128 + 64 against v 128); the output and
dO have Dv columns, dQ and dK Dk.

Tensors on the CPU take the plain versions (``ref.flash_fwd_ref``,
``ref.flash_bwd_ref``), chunked by ``q_chunk``/``kv_chunk`` as the JAX
package chunks, at any head dims; the kernels use tiles of their own. A
CUDA tensor launches the kernel or raises — there is no fallback. Each
kernel wrapper adds one to its ``.launches`` where it launches.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import List, Optional, Tuple

import torch

from .ref import flash_bwd_ref, flash_fwd_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (Dk, Dv) pairs the kernels are instantiated for
_HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
_MAX_GRID_YZ = 65535
DKDV_KEYS = 64            # keys per unit of the bf16 dK/dV kernel
DKDV_UNIT_ROWS = 4096     # its fixed row boundaries: (token, group-head) rows


def _library():
    from repro_torch.kernels import _build
    lib = _build.load(str(SOURCE))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # B Sq Skv H Hkv Dk Dv, scale, cap (on, value), window (on, size), dtype, stream
    dims = [I, I, I, I, I, I, I, F, I, F, I, I, I, P]
    plan = [P, I, P, I, P]    # plan, units, reduce table, split tiles, scratch
    for name, n_ptr, tail in (("flash_attention_fwd_launch", 6, []),
                              ("flash_attention_bwd_dkdv_launch", 9, plan),
                              ("flash_attention_bwd_dq_launch", 8, [])):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [P] * n_ptr + dims + tail
            fn.restype = ctypes.c_int
    return lib


def dkdv_plan(Sq: int, Skv: int, G: int, window: Optional[int] = None,
              unit_rows: Optional[int] = DKDV_UNIT_ROWS) -> List[Tuple[int, int, int, int]]:
    """The work units of the bf16 dK/dV kernel, in launch order: (key
    tile, row begin, row end, partial slot) over the flattened (token,
    group-head) rows of one KV head (row = token * G + group head).

    Key tile j holds keys [64j, 64j + 64); the rows that see one of them
    are tokens t >= 64j (and, under a window, t < 64j + 63 + window). That
    range is cut at the fixed multiples of ``unit_rows`` (None: not cut),
    so a key tile's cuts do not depend on any other tile. A tile left whole
    has slot -1 and its unit writes dK/dV itself; the units of a cut tile
    get consecutive slots in row order, write fp32 partials there, and a
    second launch sums them in slot order — the same bits every launch. A
    tile that no row sees is one empty unit (it writes zeros). Units run
    longest first, so the long causal ranges start in the first wave."""
    per_tile = []
    for j in range(-(-Skv // DKDV_KEYS)):
        k0, k1 = j * DKDV_KEYS, min(Skv, (j + 1) * DKDV_KEYS)
        t_end = Sq if window is None else min(Sq, k1 - 1 + window)
        r0, r1 = k0 * G, t_end * G
        if r1 <= r0:
            per_tile.append([(0, 0)])
            continue
        cuts = [r0]
        if unit_rows:
            cuts += range((r0 // unit_rows + 1) * unit_rows, r1, unit_rows)
        per_tile.append(list(zip(cuts, cuts[1:] + [r1])))
    units, slot = [], 0
    for j, ranges in enumerate(per_tile):
        for r0, r1 in ranges:
            units.append((j, r0, r1, -1 if len(ranges) == 1 else slot))
            slot += len(ranges) > 1
    return sorted(units, key=lambda u: u[1] - u[2])   # stable: longest first


@functools.lru_cache(maxsize=64)
def _dkdv_tables(Sq, Skv, G, window, unit_rows, device):
    """The plan and its reduce table ((key tile, first slot, count) of
    every cut tile) as int32 tensors on ``device``, and the slot count."""
    units = dkdv_plan(Sq, Skv, G, window, unit_rows)
    first = {}
    for j, _, _, slot in units:
        if slot >= 0:
            f, n = first.get(j, (slot, 0))
            first[j] = (min(f, slot), n + 1)
    reduce = [(j, f, n) for j, (f, n) in sorted(first.items())]
    plan_t = torch.tensor(units, dtype=torch.int32).to(device)
    reduce_t = torch.tensor(reduce or [(0, 0, 0)], dtype=torch.int32).to(device)
    return plan_t, len(units), reduce_t, len(reduce), sum(n for _, _, n in reduce)


def _check(q, k, v, extra=()):
    """Device, dtype, shape and contiguity checks of the kernels' inputs;
    ``extra`` are (name, tensor, shape, dtype) of the backward's."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q (B, Sq, H, Dk), k (B, Skv, Hkv, Dk) and v (B, Skv, "
                         "Hkv, Dv)")
    if k.shape[:3] != v.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ in "
                         "(B, Skv, Hkv)")
    B, Sq, H, D = q.shape
    _, Skv, Hkv, Dk = k.shape
    Dv = v.shape[-1]
    if k.shape[0] != B or Dk != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if (Dk, Dv) not in _HEAD_DIMS:
        if Dk != Dv:
            raise NotImplementedError(
                f"the flash kernels take (Dk, Dv) in {_HEAD_DIMS}, not ({Dk}, {Dv})")
        raise ValueError(f"head_dim {Dk} not in {tuple(d for d, _ in _HEAD_DIMS)}")
    if Sq == 0 or Skv == 0 or B > _MAX_GRID_YZ or Hkv > _MAX_GRID_YZ:
        raise ValueError(f"empty or oversized attention: B {B}, Sq {Sq}, "
                         f"Skv {Skv}, Hkv {Hkv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: all "
                        "float32 or all bfloat16")
    named = [("q", q, None, None), ("k", k, None, None), ("v", v, None, None),
             *extra]
    for name, t, shape, dtype in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _common(q, k, v, scale, cap, window):
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    return (B, Sq, Skv, H, Hkv, D, v.shape[-1], float(scale), cap is not None,
            float(cap or 0.0), window is not None, int(window or 0),
            _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _cuda_only(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"no {name} for device {t.device}")


def _raise_on(rc, name, q, v):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed at (Dk, Dv) = ({q.shape[-1]}, "
                           f"{v.shape[-1]}): CUDA error {rc}")


def flash_attention_fwd(q, k, v, *, scale: float, cap: Optional[float] = None,
                        window: Optional[int] = None, q_chunk: int = 512,
                        kv_chunk: int = 1024):
    """Causal attention forward. q (B, Sq, H, Dk), k (B, Skv, Hkv, Dk), v
    (B, Skv, Hkv, Dv). Returns (out (B, Sq, H, Dv) in q's dtype, m (B, H,
    Sq), l (B, H, Sq) fp32). ``q_chunk``/``kv_chunk`` chunk the plain
    version only."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, scale=scale, cap=cap, window=window,
                             q_chunk=q_chunk, kv_chunk=kv_chunk)
    _cuda_only("flash_attention_fwd", q)
    _check(q, k, v)
    B, Sq, H, _ = q.shape
    out = q.new_empty((B, Sq, H, v.shape[-1]))
    m = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        rc = _library().flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            m.data_ptr(), l.data_ptr(), *_common(q, k, v, scale, cap, window))
    _raise_on(rc, "flash_attention_fwd", q, v)
    flash_attention_fwd.launches += 1
    return out, m, l


def _bwd_extra(q, v, m, l, dout, delta):
    B, Sq, H, _ = q.shape
    stat = (B, H, Sq)
    return [("m", m, stat, torch.float32), ("l", l, stat, torch.float32),
            ("delta", delta, stat, torch.float32),
            ("dout", dout, (B, Sq, H, v.shape[-1]), q.dtype)]


def flash_attention_bwd_dkdv(q, k, v, m, l, dout, delta, *, scale: float,
                             cap: Optional[float] = None,
                             window: Optional[int] = None):
    """dK and dV of causal attention (the dK/dV kernel). m, l, delta (B, H,
    Sq) fp32; dout (B, Sq, H, Dv). Returns (dk, dv) in k's dtype."""
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, m, l, dout, delta, scale=scale, cap=cap,
                             window=window)[1:]
    _cuda_only("flash_attention_bwd_dkdv", q)
    dk, dv = _dkdv_launch(q, k, v, m, l, dout, delta, scale, cap, window)
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


def _dkdv_launch(q, k, v, m, l, dout, delta, scale, cap, window,
                 unit_rows=DKDV_UNIT_ROWS):
    """Launches the dK/dV kernel on CUDA tensors. In bf16 it walks the
    units of ``dkdv_plan(..., unit_rows)`` and, where a key tile was cut,
    sums the fp32 partials (scratch from ``torch.empty``) in a second
    launch; fp32 runs one CTA per 32-key tile."""
    _check(q, k, v, _bwd_extra(q, v, m, l, dout, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    tail = [None, 0, None, 0, None]
    scratch = None
    if q.dtype == torch.bfloat16:
        plan_t, n_units, reduce_t, n_reduce, n_slots = _dkdv_tables(
            Sq, Skv, H // Hkv, window, unit_rows, q.device)
        if n_slots:   # per slot: a 64-key plane of dK (Dk wide), then of dV (Dv)
            scratch = torch.empty((n_slots, B, Hkv, DKDV_KEYS * (D + v.shape[-1])),
                                  dtype=torch.float32, device=q.device)
        tail = [plan_t.data_ptr(), n_units, reduce_t.data_ptr(), n_reduce,
                None if scratch is None else scratch.data_ptr()]
    with torch.cuda.device(q.device):
        rc = _library().flash_attention_bwd_dkdv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            m.data_ptr(), l.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_common(q, k, v, scale, cap, window), *tail)
    _raise_on(rc, "flash_attention_bwd_dkdv", q, v)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, m, l, dout, delta, *, scale: float,
                           cap: Optional[float] = None,
                           window: Optional[int] = None):
    """dQ of causal attention (the dQ kernel). Returns dq in q's dtype."""
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, m, l, dout, delta, scale=scale, cap=cap,
                             window=window)[0]
    _cuda_only("flash_attention_bwd_dq", q)
    _check(q, k, v, _bwd_extra(q, v, m, l, dout, delta))
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _library().flash_attention_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_common(q, k, v, scale, cap, window))
    _raise_on(rc, "flash_attention_bwd_dq", q, v)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_fwd.launches = 0
flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, out, m, l, dout, *, scale: float,
                        cap: Optional[float] = None,
                        window: Optional[int] = None, q_chunk: int = 512,
                        kv_chunk: int = 1024):
    """(dq, dk, dv) of ``flash_attention_fwd``'s output given its cotangent
    ``dout``. delta = rowsum(dO * O) in fp32 (B, H, Sq); on CUDA the dK/dV
    kernel and the dQ kernel then launch once each."""
    acc = torch.promote_types(out.dtype, torch.float32)
    delta = (dout.to(acc) * out.to(acc)).sum(-1).transpose(1, 2).contiguous()
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, m, l, dout, delta, scale=scale, cap=cap,
                             window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    kw = dict(scale=scale, cap=cap, window=window)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, m, l, dout, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, m, l, dout, delta, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal flash attention with the flash backward: saves q, k, v, the
    output and the per-row (m, l), and recomputes the probabilities in the
    backward (``_flash_chunk_fwd``/``_flash_chunk_bwd`` of the JAX
    package)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, cap, window, q_chunk, kv_chunk):
        out, m, l = flash_attention_fwd(q, k, v, scale=scale, cap=cap,
                                        window=window, q_chunk=q_chunk,
                                        kv_chunk=kv_chunk)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.opts = dict(scale=scale, cap=cap, window=window, q_chunk=q_chunk,
                        kv_chunk=kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, m, l,
                                         dout.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None, None
