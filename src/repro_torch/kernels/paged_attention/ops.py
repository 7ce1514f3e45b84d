"""Wrapper for the Hopper ragged paged-attention kernel
(``csrc/ragged_paged_attention.cu``).

``ragged_paged_attention`` checks its inputs, allocates the output and
launches the kernel on the current CUDA stream. Tensors on the CPU take
the plain version (``ref.ragged_paged_attention_ref``); a CUDA tensor
launches the kernel or raises — there is no fallback. Each launch adds one
to ``ragged_paged_attention.launches``.

Short query ranges (decode) spread each group of KV splits over a CTA of
its own and fold the groups' fp32 partials in a second launch; longer ones
fold every group in one CTA. Both fold in the same order, so a row's bits
do not depend on the mode. The library decides the mode and says how much
fp32 scratch it needs; the wrapper allocates that (``torch.empty``).
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch

from .ref import ragged_paged_attention_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ragged_paged_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 80, 128, 256, 576)


def _library():
    from repro_torch.kernels import _build
    lib = _build.load(str(SOURCE))
    fn = lib.ragged_paged_attention_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, P, P,            # q kv table cu kv_lens out
                       I, I, I, I, I, I, I, I, I,   # T S W P ps Hq Hkv D max_q_len
                       F, I, F, I, I,               # scale has_cap cap has_win win
                       I, P, P]                     # dtype scratch stream
        fn.restype = ctypes.c_int
        lib.ragged_paged_attention_scratch_floats.argtypes = [I] * 7
        lib.ragged_paged_attention_scratch_floats.restype = ctypes.c_longlong
    return lib


def _check(q, kv_pages, page_table, cu_q_lens, kv_lens):
    dev = q.device
    for name, t in (("kv_pages", kv_pages), ("page_table", page_table),
                    ("cu_q_lens", cu_q_lens), ("kv_lens", kv_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("kv_pages", kv_pages), ("page_table", page_table),
                    ("cu_q_lens", cu_q_lens), ("kv_lens", kv_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or kv_pages.dtype != q.dtype:
        raise TypeError(f"q/kv_pages dtypes {q.dtype}/{kv_pages.dtype}: both "
                        "float32 or both bfloat16")
    for name, t in (("page_table", page_table), ("cu_q_lens", cu_q_lens),
                    ("kv_lens", kv_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 3 or kv_pages.dim() != 4 or page_table.dim() != 2:
        raise ValueError("q (T, Hq, D), kv_pages (P, ps, 2*Hkv, D), "
                         "page_table (S, W)")
    T, Hq, D = q.shape
    P, ps, H2, Dk = kv_pages.shape
    S = page_table.shape[0]
    if Dk != D or H2 % 2 or Hq % (H2 // 2):
        raise ValueError(f"q {tuple(q.shape)} does not match kv_pages "
                         f"{tuple(kv_pages.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    if ps <= 0:
        raise ValueError(f"page_size {ps} must be positive")
    if page_table.shape[1] == 0:
        raise ValueError("page_table must have at least one slot")
    if cu_q_lens.shape != (S + 1,) or kv_lens.shape != (S,):
        raise ValueError("cu_q_lens must be (S+1,) and kv_lens (S,) for an "
                         f"(S={S}, W) page table")
    for name, t in (("q", q), ("kv_pages", kv_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def ragged_paged_attention(q, kv_pages, page_table, cu_q_lens, kv_lens, *,
                           scale: float, cap: Optional[float] = None,
                           window: Optional[int] = None,
                           max_q_len: Optional[int] = None):
    """Attend T concatenated query rows against paged KV storage.

    q: (T, Hq, D); kv_pages: (P, ps, 2*Hkv, D) fused head-interleaved;
    page_table: (S, W) int32; cu_q_lens: (S+1,) int32 with
    cu_q_lens[-1] == T; kv_lens: (S,) int32. ``max_q_len`` bounds every
    per-sequence query length (defaults to T, which is always safe: tiles
    past a sequence's end exit at once). Returns (T, Hq, D) in q's dtype."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(q, kv_pages, page_table, cu_q_lens,
                                          kv_lens, scale=scale, cap=cap,
                                          window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged_paged_attention for device {q.device}")
    _check(q, kv_pages, page_table, cu_q_lens, kv_lens)
    T, Hq, D = q.shape
    P, ps, H2, _ = kv_pages.shape
    S, W = page_table.shape
    max_q_len = T if max_q_len is None else int(max_q_len)
    out = torch.empty_like(q)
    lib = _library()
    n_scratch = lib.ragged_paged_attention_scratch_floats(T, Hq, H2 // 2, D, W, max_q_len,
                                                          _DTYPES[q.dtype])
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=q.device)
               if n_scratch else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ragged_paged_attention_launch(
            q.data_ptr(), kv_pages.data_ptr(), page_table.data_ptr(),
            cu_q_lens.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            T, S, W, P, ps, Hq, H2 // 2, D, max_q_len,
            float(scale), cap is not None, float(cap or 0.0),
            window is not None, int(window or 0),
            _DTYPES[q.dtype], None if scratch is None else scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA error {rc}")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
