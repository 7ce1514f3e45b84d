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

The per-warp kernels launch under a plan (``block_q``, ``block_kv``,
``num_buffers``: ``tune.py``), by default the tuned or default plan of the
geometry on this card. Rows and stages are compiled in: a plan other than
the default 16 rows and 2 stages loads its dtype's tiles library
(``csrc/ragged_paged_attention_tiles.cu``, ``..._tiles_fp32.cu``), built at
its first use. The plain version ignores the plan. ``gathered`` (one
int32 on the card) receives the launch's (page, KV head) slab loads,
which ``pages_gathered`` replicates on the host. ``meta`` tensors get an
output of the kernel's shape and no arithmetic; an active analysis records
each call's work (``kernels/_work.py``).
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _work

from . import tune
from .ref import ragged_paged_attention_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ragged_paged_attention.cu"
# every other plan of the per-warp kernels, by dtype (RPA_TILES), built at first use
TILES_SOURCES = {torch.bfloat16: SOURCE.with_name("ragged_paged_attention_tiles.cu"),
                 torch.float32: SOURCE.with_name("ragged_paged_attention_tiles_fp32.cu")}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 80, 128, 256, 576)


def _library(source=SOURCE):
    from repro_torch.kernels import _build
    lib = _build.load(str(source))
    fn = lib.ragged_paged_attention_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, P, P,            # q kv table cu kv_lens out
                       P, P,                        # q_pos kv_pos (null: slot-derived)
                       I, I, I, I, I, I, I, I, I,   # T S W P ps Hq Hkv D max_q_len
                       I,                           # v_from_k
                       F, I, F, I, I,               # scale has_cap cap has_win win
                       I, I, I,                     # block_q block_kv num_buffers
                       I, P, P, P, P]               # dtype scratch counters gathered stream
        fn.restype = ctypes.c_int
        lib.ragged_paged_attention_scratch_floats.argtypes = [I] * 10
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


def _check_gathered(q, gathered):
    """One int32 on the card, beside q."""
    if gathered is None:
        return
    if q.device.type != "cuda":
        raise ValueError("gathered counts the CUDA kernel's page loads; on "
                         f"{q.device} the plain version runs")
    if (gathered.dtype != torch.int32 or gathered.numel() != 1
            or gathered.device != q.device):
        raise ValueError("gathered must be one int32 on q's device, got "
                         f"{gathered.dtype} {tuple(gathered.shape)} on {gathered.device}")


def paged_work(q, kv_pages, page_table, cu_q_lens, kv_lens, *, window=None,
               q_pos=None, **_):
    """(flops, bytes) of a launch from shapes alone: q and the output once,
    the descriptors, and every slot of every table row (each row's K and V
    planes, and its position with ``q_pos``) once; 4*D flops per (query
    head, key), each query attending every slot of its row, or ``window``
    of them. A full cache (a decode at its last position) attends exactly
    that; a shorter one attends less than this count."""
    T, Hq, D = q.shape
    _, ps, H2, _ = kv_pages.shape
    S, W = page_table.shape
    item = q.element_size()
    slots = W * ps
    keys = slots if window is None else min(slots, window)
    n_bytes = (2 * q.numel() * item + 4 * (page_table.numel() + S + 1 + S)
               + S * slots * H2 * D * item)
    if q_pos is not None:
        n_bytes += 4 * (T + S * slots)
    return 4 * D * Hq * T * keys, n_bytes


def _meta(q, *_, **__):
    return torch.empty_like(q)


@_work.entry(paged_work, _meta)
def ragged_paged_attention(q, kv_pages, page_table, cu_q_lens, kv_lens, *,
                           scale: float, cap: Optional[float] = None,
                           window: Optional[int] = None,
                           max_q_len: Optional[int] = None,
                           q_pos=None, kv_pos_pages=None,
                           v_from_k: bool = False,
                           block_q: Optional[int] = None,
                           block_kv: Optional[int] = None,
                           num_buffers: Optional[int] = None,
                           gathered=None):
    """Attend T concatenated query rows against paged KV storage.

    q: (T, Hq, D); kv_pages: (P, ps, 2*Hkv, D) fused head-interleaved;
    page_table: (S, W) int32; cu_q_lens: (S+1,) int32 with
    cu_q_lens[-1] == T; kv_lens: (S,) int32. ``max_q_len`` bounds every
    per-sequence query length (defaults to T, which is always safe: tiles
    past a sequence's end exit at once). ``q_pos`` (T,) and
    ``kv_pos_pages`` (P, ps), int32, both or neither, switch on explicit
    positions (-1 in ``kv_pos_pages``: an empty row). ``v_from_k`` reads
    a single-plane pool (P, ps, 1, D) whose rows are key and value at
    once. ``block_q``/``block_kv``/``num_buffers`` override the launch plan
    (``tune.resolve_config``); ``gathered`` receives the slab loads.
    Returns (T, Hq, D) in q's dtype."""
    _check_positions(q, kv_pages, q_pos, kv_pos_pages)
    _check_planes(kv_pages, v_from_k)
    _check_gathered(q, gathered)
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
    cfg = (tune.KernelConfig() if tune.is_latent(D, q.dtype) else
           tune.resolve_config(ps, D, max_q_len, W, block_q, block_kv, num_buffers,
                               dtype=q.dtype, group=Hq // Hkv))
    out = torch.empty_like(q)
    default = (cfg.block_q, cfg.num_buffers) == (tune.MMA_ROWS, 2)
    lib = _library(SOURCE if default else TILES_SOURCES[q.dtype])
    dtype = _DTYPES[q.dtype]
    n_scratch = lib.ragged_paged_attention_scratch_floats(T, S, Hq, Hkv, D, W, ps,
                                                          max_q_len, cfg.block_kv, dtype)
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
            cfg.block_q, cfg.block_kv, cfg.num_buffers,
            dtype, None if scratch is None else scratch.data_ptr(),
            None if counters is None else counters.data_ptr(),
            None if gathered is None else gathered.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA error {rc}")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pages_gathered(page_table, cu_q_lens, kv_lens, *, page_size: int,
                   max_q_len: int, block_q: Optional[int] = None,
                   block_kv: Optional[int] = None,
                   window: Optional[int] = None,
                   skip_blocks: bool = True, num_q_heads: int = 1,
                   num_kv_heads: int = 1, head_dim: int = 128,
                   dtype=torch.bfloat16, positions: bool = False,
                   num_pages: Optional[int] = None) -> int:
    """Host-side replica of one launch's page loads under its plan, the
    counterpart of the TPU kernel's ``pages_gathered``
    (``src/repro/kernels/paged_attention/kernel.py:325``), in every mode.

    The unit is one (page, KV head) slab: each CTA reads only its own KV
    head's rows of a page, ``ps`` rows of ``planes`` x ``D`` elements, so a
    launch reads ``count * ps * planes * D * itemsize`` bytes of KV (planes
    2, or 1 with ``v_from_k``). A CTA holds one tile of a (sequence, KV
    head): ``block_q`` rows in bf16, a quarter of that in fp32, and the
    latent kernel's 16 or 32 (its own plan); the CTAs that hold a tile's
    splits stage, between them, each live slot of the tile's reachable
    range once:

    - slot-derived positions (default): slots [lo, hi), hi past the tile's
      last query position, lo at its first one's ``window``; null slots
      (page 0, or ``num_pages`` and beyond) are skipped;
    - ``positions`` (``q_pos``/``kv_pos_pages``, the ring view): every slot
      below ``ceil(kv_len / ps)``, page 0 included.

    ``skip_blocks=False`` gives the count that visits every slot below
    ``ceil(kv_len / ps)`` of every tile, nulls included. ``block_kv`` only
    moves split boundaries, which leave the count as it is. The kernel
    adds the same count to its ``gathered`` counter."""
    tbl, cu, kvl = _host(page_table), _host(cu_q_lens), _host(kv_lens)
    S, W = tbl.shape
    ps = int(page_size)
    G = int(num_q_heads) // int(num_kv_heads)
    if tune.is_latent(head_dim, dtype):
        rows = 16 if max(1, max_q_len) * G <= tune.MMA_ROWS else 2 * tune.MMA_ROWS
    else:
        cfg = tune.resolve_config(ps, head_dim, max_q_len, W, block_q, block_kv,
                                  dtype=dtype, group=G)
        rows = tune.tile_rows(cfg.block_q, dtype)
    live = tbl >= (0 if positions else 1)
    if num_pages is not None:
        live &= tbl < int(num_pages)
    total = 0
    for s in range(S):
        qlen, kv_len = int(cu[s + 1] - cu[s]), int(kvl[s])
        n_pages = min(-(-kv_len // ps), W)
        for row0 in range(0, max(1, max_q_len) * G, rows):
            if row0 >= qlen * G:
                break
            if not skip_blocks:
                total += n_pages
                continue
            row_end = min(row0 + rows, qlen * G)
            first_qpos = kv_len - qlen + row0 // G
            last_qpos = kv_len - qlen + (row_end - 1) // G
            hi = n_pages if positions else min(n_pages, last_qpos // ps + 1)
            lo = (max(first_qpos - int(window) + 1, 0) // ps
                  if window is not None and not positions else 0)
            total += int(np.count_nonzero(live[s, lo:hi]))
    return total * int(num_kv_heads)
