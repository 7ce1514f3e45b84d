"""Launch plans for the Hopper paged-attention kernels
(``csrc/ragged_paged_attention.cu``): the counterpart of the TPU kernel's
autotuner (``src/repro/kernels/paged_attention/tune.py``), same names.

A plan has the reference's three fields, each re-read for the CUDA
kernels' tiles:

* ``block_q`` — the (token, group-head) rows a CTA holds, counted in the
  bf16 kernel's unit: 16 (one ``mma.sync`` m16 tile) or 32 (two tiles
  sharing each staged block of K and V). The fp32 kernel holds a quarter
  as many rows (4 or 8): its accumulators take every lane of a warp for
  each row, so 4 fp32 rows hold the registers of 16 bf16 ones (D/2 a
  thread). 32 only up to head dim 128, where the accumulators of two tiles
  still fit the registers (``kWideMaxD``).
* ``block_kv`` — the most page slots one warp's split holds:
  ``split_slots(n) = max(1, min(block_kv, n // 64))`` for a sequence of
  ``n`` pages, so the split boundaries, the groups a sequence needs and
  the scratch all follow it (1 to 32: a lane per slot).
* ``num_buffers`` — the cp.async stages each warp keeps in flight, 2 to
  4, as the card's 227 KB of shared memory allows at that head dim (4 fit
  at D 128 in bf16, not at D 256).

The default, ``KernelConfig()`` = (16, 8, 2), is the plan the kernels had
before they took a plan: a geometry that was never tuned launches the
same instantiations and computes the same bits. Rows and stages are
compiled into the kernels: the default plan's instantiations stay in the
default library, every other plan's live in a tiles library per dtype
(``ragged_paged_attention_tiles{,_fp32}.cu``), built at the first launch
that asks for one, so the default build does not grow. A row's bits depend
on ``block_kv`` alone (its split boundaries); ``block_q`` and
``num_buffers`` change only how the same arithmetic is scheduled.

The bf16 latent-head kernel (D 576, MLA) keeps its own plan (splits of
about 192 keys folded by clusters of 8) and ignores these fields.

Plans are cached per ``(page_size, head_dim, device name)``, the device
name being ``torch.cuda.get_device_name()`` normalised as the reference
normalises a TPU's ``device_kind`` ("cpu" without a card), so a table
tuned on another card, or on a TPU, never applies:

* ``best_config(ps, D)`` — the cached plan, else the default; never
  launches anything.
* ``resolve_config(...)`` — one launch's effective plan: overrides win,
  then the cache; clamped to the launch shape and to the card.
* ``autotune(ps, D, ...)`` — times every candidate with CUDA events on
  synthetic ragged cases on the card, caches the winner, and optionally
  persists the table (``REPRO_KERNEL_TUNE_CACHE`` names one to load at
  import and save to).
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from typing import Dict, Optional, Tuple

import torch

DEFAULT_CACHE_PATH = os.environ.get("REPRO_KERNEL_TUNE_CACHE", "")

# candidate sweep: rows a CTA x page slots a split x cp.async stages
CANDIDATE_BLOCK_Q = (16, 32)
CANDIDATE_BLOCK_KV = (4, 8, 16)
CANDIDATE_BUFFERS = (2, 3, 4)

# mirrored from csrc/ragged_paged_attention.cu (tests/test_torch_tune.py
# holds them to the source)
WARPS = 4               # kWarps: splits a group, one a warp
MMA_ROWS = 16           # kMmaRows: block_q's unit
FP32_ROWS = 4           # kRows: the fp32 rows of one unit
MMA_KEYS = 16           # kMmaKeys: keys of a bf16 staged block
STAGE_BYTES = 8192      # kStageBytes: about this much K and V an fp32 block
SMEM_BYTES = 232448     # kSmemBytes: a CTA's shared memory, at most
MAX_SPLIT_SLOTS = 32    # kMaxSplitSlots: block_kv, at most
WIDE_MAX_D = 128        # kWideMaxD: the widest head of block_q 32
LATENT_D = 576          # kLatentD: the latent kernel's own plan


@dataclass(frozen=True)
class KernelConfig:
    block_q: int = 16
    block_kv: int = 8
    num_buffers: int = 2


_CACHE: Dict[Tuple[int, int, str], KernelConfig] = {}


def _arch() -> str:
    """The card the tuned plans belong to: its CUDA device name, lower
    case, spaces as dashes; "cpu" without a card (plans cached there only
    pin launch overrides: the plain version has no tiles)."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name().replace(" ", "-").lower()


def is_latent(head_dim: int, dtype) -> bool:
    """The bf16 latent head: its own plan, outside the tuner."""
    return dtype == torch.bfloat16 and int(head_dim) == LATENT_D


def split_slots(n_pages: int, block_kv: int) -> int:
    """Page slots of one split for a sequence of ``n_pages`` pages."""
    return max(1, min(int(block_kv), int(n_pages) // 64))


def tile_rows(block_q: int, dtype) -> int:
    """The (token, group-head) rows of a CTA tile of the per-warp kernels."""
    return int(block_q) if dtype == torch.bfloat16 else int(block_q) // MMA_ROWS * FP32_ROWS


def smem_bytes(head_dim: int, dtype, block_q: int, num_buffers: int) -> int:
    """Dynamic shared memory of a per-warp kernel's CTA under this plan
    (``MmaGeo::bytes`` / ``Geo::bytes``)."""
    D, nt = int(head_dim), int(block_q) // MMA_ROWS
    if dtype == torch.bfloat16:
        stage = MMA_KEYS * (2 * D + 8) * 2
        return 2 * nt * MMA_ROWS * (D + 8) + WARPS * int(num_buffers) * stage
    lpk = 32 if D >= 512 else 8
    keys = max(4, STAGE_BYTES // (2 * D * 4))
    keys = min(keys, 32) // (32 // lpk) * (32 // lpk)
    return 4 * nt * FP32_ROWS * D + WARPS * int(num_buffers) * keys * 2 * D * 4


def best_config(page_size: int, head_dim: int,
                arch: Optional[str] = None) -> KernelConfig:
    """Cached plan for this geometry on this card; the default plan if the
    geometry was never tuned here."""
    return _CACHE.get((int(page_size), int(head_dim), arch or _arch()), KernelConfig())


def resolve_config(page_size: int, head_dim: int, max_q_len: int,
                   table_width: int,
                   block_q: Optional[int] = None,
                   block_kv: Optional[int] = None,
                   num_buffers: Optional[int] = None, *,
                   dtype=torch.bfloat16, group: int = 1) -> KernelConfig:
    """Effective plan for one launch: explicit overrides win, the rest
    comes from the cache, and everything is clamped as the reference
    clamps (no more rows than the longest sequence's ``max_q_len * group``
    need, no more slots than the table width, 2-4 stages), then to the card:
    whole m16 tiles (16 or 32, 32 up to D 128), at most 32 slots, and no
    more stages than shared memory holds."""
    base = best_config(page_size, head_dim)
    D = int(head_dim)
    rows = max(1, int(max_q_len)) * max(1, int(group))
    unit = MMA_ROWS if dtype == torch.bfloat16 else FP32_ROWS
    tiles = min(int(block_q or base.block_q) // MMA_ROWS, -(-rows // unit),
                2 if D <= WIDE_MAX_D else 1)
    bq = MMA_ROWS * max(1, tiles)
    bkv = max(1, min(int(block_kv or base.block_kv), max(1, int(table_width)),
                     MAX_SPLIT_SLOTS))
    nb = max(2, min(int(num_buffers or base.num_buffers), 4))
    while nb > 2 and smem_bytes(D, dtype, bq, nb) > SMEM_BYTES:
        nb -= 1
    return KernelConfig(block_q=bq, block_kv=bkv, num_buffers=nb)


def set_config(page_size: int, head_dim: int, cfg: KernelConfig,
               arch: Optional[str] = None) -> None:
    _CACHE[(int(page_size), int(head_dim), arch or _arch())] = cfg


def load_table(path: str) -> int:
    """Merge a persisted tune table into the in-process cache; returns
    the number of entries loaded."""
    if not path or not os.path.exists(path):
        return 0
    with open(path) as f:
        data = json.load(f)
    n = 0
    for row in data.get("entries", []):
        _CACHE[(int(row["page_size"]), int(row["head_dim"]),
                str(row["arch"]))] = KernelConfig(
            block_q=int(row["block_q"]), block_kv=int(row["block_kv"]),
            num_buffers=int(row["num_buffers"]))
        n += 1
    return n


def save_table(path: str) -> None:
    entries = [
        {"page_size": ps, "head_dim": d, "arch": arch, **asdict(cfg)}
        for (ps, d, arch), cfg in sorted(_CACHE.items())
    ]
    with open(path, "w") as f:
        json.dump({"entries": entries}, f, indent=2, sort_keys=True)
        f.write("\n")


def _bench_case(page_size: int, head_dim: int, *, device, dtype=torch.bfloat16,
                n_kv_heads: int = 2, group: int = 2, seqs: int = 3,
                pages_per_seq: int = 6, null_every: int = 3, decode: bool = False,
                seed: int = 0) -> dict:
    """Synthetic ragged workload, the reference's shape, drawn on the
    device from an explicit generator: a few sequences, ragged page counts,
    sparse tables (every ``null_every``-th slot nulled, so the skip path is
    exercised) and ragged query lengths (all 1 with ``decode``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ps, D, W = page_size, head_dim, pages_per_seq
    n_pages = 1 + seqs * W
    kv = torch.randn((n_pages, ps, 2 * n_kv_heads, D), generator=gen, device=device)
    kv[0] = 0.0
    tbl = torch.zeros((seqs, W), dtype=torch.int32)
    kvl, qls = [], []
    for s in range(seqs):
        used = W - s % 2                        # ragged page counts
        for j in range(used):
            if not (null_every and (j + 1) % null_every == 0):
                tbl[s, j] = 1 + s * W + j       # else sparse: the slot stays null
        kvl.append(used * ps)
        qls.append(1 if decode else 1 + (s * 5) % (2 * ps))
    cu = torch.tensor([0] + qls, dtype=torch.int32).cumsum(0, dtype=torch.int32)
    q = torch.randn((int(cu[-1]), n_kv_heads * group, D), generator=gen, device=device)
    return {"q": q.to(dtype), "kv_pages": kv.to(dtype), "page_table": tbl.to(device),
            "cu_q_lens": cu.to(device), "kv_lens": torch.tensor(kvl, dtype=torch.int32,
                                                                device=device),
            "max_q_len": max(qls)}


def autotune(page_size: int, head_dim: int, *, repeats: int = 20,
             cache_path: Optional[str] = None, candidates=None,
             verbose: bool = False, cases=None, device="cuda",
             dtype=torch.bfloat16, timings: Optional[dict] = None) -> KernelConfig:
    """Time the candidate grid with the CUDA kernel on synthetic ragged
    cases (``cases``: ``_bench_case`` dicts; by default one extend and one
    decode case at 2 KV heads of group 2), cache and return the winner.
    Each candidate's time is device time: CUDA events around ``repeats``
    rounds of every case, enqueued behind a device-side sleep so that the
    card never waits for the host. ``timings``, if given, receives each
    effective candidate's ms a round. Raises ``ValueError`` on the CPU
    (``device``, or the cases' tensors): the plain version has no tiles to
    time."""
    from .ops import ragged_paged_attention

    device = cases[0]["q"].device if cases else torch.device(device)
    if device.type != "cuda":
        raise ValueError("autotune times the CUDA kernel's tiles; on "
                         f"{device} the plain version runs and has none")
    D = int(head_dim)
    if cases is None:
        cases = [_bench_case(page_size, D, device=device, dtype=dtype, decode=d)
                 for d in (False, True)]
    cand = candidates or [KernelConfig(bq, bkv, nb) for bq in CANDIDATE_BLOCK_Q
                          for bkv in CANDIDATE_BLOCK_KV for nb in CANDIDATE_BUFFERS]
    # each candidate as the card holds it at this head dim, duplicates once
    plans = list(dict.fromkeys(
        resolve_config(page_size, D, 1 << 20, MAX_SPLIT_SLOTS, c.block_q, c.block_kv,
                       c.num_buffers, dtype=dtype) for c in cand))

    def run(cfg):
        for c in cases:
            ragged_paged_attention(c["q"], c["kv_pages"], c["page_table"], c["cu_q_lens"],
                                   c["kv_lens"], scale=D ** -0.5, max_q_len=c["max_q_len"],
                                   block_q=cfg.block_q, block_kv=cfg.block_kv,
                                   num_buffers=cfg.num_buffers)

    best: Tuple[float, KernelConfig] = (float("inf"), best_config(page_size, D))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        for cfg in plans:
            run(cfg)                            # build the library, warm
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)       # ~25 ms: the host enqueues ahead
            start.record()
            for _ in range(repeats):
                run(cfg)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / repeats
            if timings is not None:
                timings[cfg] = ms
            if verbose:
                print(f"  tune ps={page_size} D={D} {cfg}: {ms:.5f} ms")
            if ms < best[0]:
                best = (ms, cfg)
    set_config(page_size, D, best[1])
    path = cache_path if cache_path is not None else DEFAULT_CACHE_PATH
    if path:
        save_table(path)
    return best[1]


if DEFAULT_CACHE_PATH:
    load_table(DEFAULT_CACHE_PATH)
