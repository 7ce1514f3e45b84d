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

The bf16 latent head (D 576, MLA) has a plan of its own and one launch: a
sequence's keys are cut into splits of about 192 keys (whole pages, a
function of the page size alone), 8 consecutive splits run as a cluster of
CTAs that fold their partials on chip, and the clusters of a longer
sequence fold through fp32 scratch, the last to finish found by an int32
counter. The counters must be zero at launch and every launch leaves them
zero; the wrapper keeps one buffer a device and stream (``_counters``).
Decode holds one 16-row tile a CTA, anything longer two, sharing each
staged block; a row's bits are the same in either.

With ``q_pos``/``kv_pos_pages`` the kernel reads key positions from the
given plane and query positions from ``q_pos`` (the explicit-position
mode a ring cache reads through); it then visits every table slot up to
``kv_lens``, page 0 included, and masks by position alone, in every
kernel, the latent-head (MLA) one included.

``v_from_k=True`` reads a single-plane pool ``(P, ps, 1, D)``, one KV head
whose value row is its key row: the MLA ring's stored ``[c, kr]``, read
by every kernel (at D 576 the bf16 latent kernel with staged units of one
plane).
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
                       P, P,                        # q_pos kv_pos (null: slot-derived)
                       I, I, I, I, I, I, I, I, I,   # T S W P ps Hq Hkv D max_q_len
                       I,                           # v_from_k
                       F, I, F, I, I,               # scale has_cap cap has_win win
                       I, P, P, P]                  # dtype scratch counters stream
        fn.restype = ctypes.c_int
        lib.ragged_paged_attention_scratch_floats.argtypes = [I] * 9
        lib.ragged_paged_attention_scratch_floats.restype = ctypes.c_longlong
        lib.ragged_paged_attention_counters.argtypes = [I] * 8
        lib.ragged_paged_attention_counters.restype = ctypes.c_longlong
    return lib


# The latent kernel's fold counters, by (device, stream): int32, zero
# between launches (each launch leaves them zero), grown on demand. One
# buffer a stream, so the launches that share it run in order.
_COUNTERS: dict = {}


def _counters(n: int, device, stream: int):
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _check_positions(q, kv_pages, q_pos, kv_pos_pages):
    """Both or neither, on every device; the shapes, dtypes, device and
    layout the kernel reads them in."""
    if (q_pos is None) != (kv_pos_pages is None):
        raise ValueError("q_pos and kv_pos_pages must be given together")
    if q_pos is None:
        return
    for name, t, shape in (("q_pos", q_pos, (q.shape[0],)),
                           ("kv_pos_pages", kv_pos_pages, tuple(kv_pages.shape[:2]))):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_planes(kv_pages, v_from_k):
    """A single-plane pool is one KV head."""
    if v_from_k and (kv_pages.dim() != 4 or kv_pages.shape[2] != 1):
        raise ValueError("v_from_k reads one plane: kv_pages (P, ps, 1, D), "
                         f"got {tuple(kv_pages.shape)}")


def _check(q, kv_pages, page_table, cu_q_lens, kv_lens, v_from_k=False):
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
    Hkv = H2 if v_from_k else H2 // 2
    if Dk != D or (H2 % 2 and not v_from_k) or Hq % Hkv:
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
                           max_q_len: Optional[int] = None,
                           q_pos=None, kv_pos_pages=None,
                           v_from_k: bool = False):
    """Attend T concatenated query rows against paged KV storage.

    q: (T, Hq, D); kv_pages: (P, ps, 2*Hkv, D) fused head-interleaved;
    page_table: (S, W) int32; cu_q_lens: (S+1,) int32 with
    cu_q_lens[-1] == T; kv_lens: (S,) int32. ``max_q_len`` bounds every
    per-sequence query length (defaults to T, which is always safe: tiles
    past a sequence's end exit at once). ``q_pos`` (T,) and
    ``kv_pos_pages`` (P, ps), int32, both or neither, switch on explicit
    positions (-1 in ``kv_pos_pages``: an empty row). ``v_from_k`` reads
    a single-plane pool (P, ps, 1, D) whose rows are key and value at
    once. Returns (T, Hq, D) in q's dtype."""
    _check_positions(q, kv_pages, q_pos, kv_pos_pages)
    _check_planes(kv_pages, v_from_k)
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(q, kv_pages, page_table, cu_q_lens,
                                          kv_lens, scale=scale, cap=cap,
                                          window=window, q_pos=q_pos,
                                          kv_pos_pages=kv_pos_pages,
                                          v_from_k=v_from_k)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged_paged_attention for device {q.device}")
    _check(q, kv_pages, page_table, cu_q_lens, kv_lens, v_from_k)
    T, Hq, D = q.shape
    P, ps, H2, _ = kv_pages.shape
    Hkv = H2 if v_from_k else H2 // 2
    S, W = page_table.shape
    max_q_len = T if max_q_len is None else int(max_q_len)
    out = torch.empty_like(q)
    lib = _library()
    dtype = _DTYPES[q.dtype]
    n_scratch = lib.ragged_paged_attention_scratch_floats(T, S, Hq, Hkv, D, W, ps,
                                                          max_q_len, dtype)
    n_counters = lib.ragged_paged_attention_counters(S, Hq, Hkv, D, W, ps, max_q_len, dtype)
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=q.device)
               if n_scratch else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = _counters(n_counters, q.device, stream) if n_counters else None
        rc = lib.ragged_paged_attention_launch(
            q.data_ptr(), kv_pages.data_ptr(), page_table.data_ptr(),
            cu_q_lens.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            None if q_pos is None else q_pos.data_ptr(),
            None if kv_pos_pages is None else kv_pos_pages.data_ptr(),
            T, S, W, P, ps, Hq, Hkv, D, max_q_len, int(v_from_k),
            float(scale), cap is not None, float(cap or 0.0),
            window is not None, int(window or 0),
            dtype, None if scratch is None else scratch.data_ptr(),
            None if counters is None else counters.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA error {rc}")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
