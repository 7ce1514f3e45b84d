"""Fault injection for the reliability plane (DESIGN.md §11).

Flips bits in paged KV/state compute arrays according to each page's age
and retention state, so CI can measure — not assert — that the ECC plane
holds decode together at the target RBER and that an over-aged page
without refresh degrades.

The injector works at two scales, mirroring how the repo meters memory:

- **accounting scale** — the region's deployment-size byte count, where
  uncorrectable-block *events* are sampled (``Poisson(n_blocks * P[block
  uncorrectable at this RBER])``); a tier's ECC either corrects a block
  or it doesn't, and that probability depends on the real block
  population, not the reduced model's array sizes;
- **compute scale** — the actual (reduced-model) page array, where raw
  flips land (``Poisson(array_bits * rber)``) so corruption propagates
  through real decode math.

Contract with the ECC profile (engine ``--inject-rber`` plumbing):

- profile ``off``: every sampled raw flip lands — no correction, no scrub;
- profile ``uniform``/``domain``: critical (sign+exponent) flips land only
  when an accounting-scale block is uncorrectable; mantissa flips beyond
  the bulk code's per-block budget pass through as bounded activation
  noise (that *is* the relaxed-mantissa trade); pages whose age crosses
  ``scrub_age_frac`` of the refresh interval request a scrub-on-read
  instead, which corrects everything and re-arms the retention clock
  (metered by :meth:`repro_torch.core.simulator.MemorySystem.scrub_region`).

The port's copy draws from the same ``np.random.default_rng(seed)`` in the
same order as ``repro.core.faults`` (two Poissons, a third for the
accounting-scale blocks under protection, then the indices and bits of
the critical flips, then of the bulk flips), so the same visits flip the
same bits. A bfloat16 page has no numpy form: the draws need only a
page's word count, word size and float dtype name, and the flips land
through the integer view (``int16``/``int32``, read as ``uint16``/
``uint32``). :func:`draw_flips` folds the drawn flips into one XOR mask
per distinct word — two flips of one bit cancel, as ``np.bitwise_xor.at``
has them cancel — so :meth:`FaultInjector.apply` can write a page that
lives on the device with one scatter of only the flipped words.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ecc import SplitCode, rber_at_age, uncorrectable_log10

#: sign+exponent ("critical") bit range per float dtype: (low bit, word bits)
CRIT_BIT_RANGE = {
    "bfloat16": (7, 16),
    "float16": (10, 16),
    "float32": (23, 32),
}

_UINT_FOR_ITEMSIZE = {2: np.uint16, 4: np.uint32}
_INT_FOR_ITEMSIZE = {2: (np.int16, torch.int16), 4: (np.int32, torch.int32)}

#: hard cap on flips applied to one array per visit — keeps the clamped
#: RBER=0.5 regime (over-aged pages) linear in array size
MAX_FLIPS_PER_VISIT = 1 << 20


@dataclass
class FaultStats:
    """Counters surfaced in the engine report's ``reliability`` section."""
    pages_visited: int = 0
    scrubs_requested: int = 0
    crit_flips: int = 0
    bulk_flips: int = 0
    corrected_bits: int = 0
    uncorrectable_blocks: int = 0

    def as_dict(self) -> dict:
        return {
            "pages_visited": self.pages_visited,
            "scrubs_requested": self.scrubs_requested,
            "crit_flips": self.crit_flips,
            "bulk_flips": self.bulk_flips,
            "corrected_bits": self.corrected_bits,
            "uncorrectable_blocks": self.uncorrectable_blocks,
        }


def dtype_name(arr: torch.Tensor) -> str:
    """The float dtype's name as ``CRIT_BIT_RANGE`` keys it
    (``torch.bfloat16`` -> ``"bfloat16"``, numpy's and ml_dtypes' names)."""
    return str(arr.dtype).removeprefix("torch.")


@dataclass
class Flips:
    """The flips of one visit to one array, folded per word: flat word
    indices (distinct, ascending) and the XOR mask of each, as unsigned
    words of the array's size."""
    idx: np.ndarray
    mask: np.ndarray


def draw_flips(size: int, itemsize: int, name: str, n_crit: int, n_bulk: int,
               rng: np.random.Generator) -> Optional[Flips]:
    """``n_crit`` sign/exponent and ``n_bulk`` mantissa flips at uniformly
    random words of an array of ``size`` words (with replacement —
    colliding flips cancel, as real double errors do), drawn as
    ``repro.core.faults.flip_bits`` draws them. None when nothing is
    drawn."""
    if (n_crit <= 0 and n_bulk <= 0) or size == 0:
        return None
    lo, word_bits = CRIT_BIT_RANGE.get(name, CRIT_BIT_RANGE["float32"])
    uint = _UINT_FOR_ITEMSIZE[itemsize]
    idx, masks = [], []
    for n, bits in ((n_crit, (lo, word_bits)), (n_bulk, (0, lo))):
        if n > 0:
            idx.append(rng.integers(0, size, int(n)))
            bit = rng.integers(bits[0], bits[1], int(n))
            masks.append(np.ones(1, uint) << bit.astype(uint))
    uidx, inv = np.unique(np.concatenate(idx), return_inverse=True)
    mask = np.zeros(uidx.shape, uint)
    np.bitwise_xor.at(mask, inv, np.concatenate(masks))
    return Flips(uidx, mask)


def apply_flips(arr: torch.Tensor, flips: Optional[Flips]) -> torch.Tensor:
    """A copy of ``arr`` (on any device) with ``flips`` applied to its flat
    words; ``arr`` itself if none."""
    if flips is None:
        return arr
    out = arr.detach().clone()
    xor_words_(out, flips)
    return out


def xor_words_(words: torch.Tensor, flips: Flips) -> None:
    """XOR ``flips`` into ``words`` in place through its integer view, its
    flat word ``i`` taken in row-major order (``words`` may be a strided
    view, such as one page of a pool, which is then written through).
    Distinct indices make the gather and the scatter one each; nothing
    else of ``words`` is read or written."""
    npint, tint = _INT_FOR_ITEMSIZE[words.element_size()]
    iv = words.view(tint)
    sel = tuple(torch.as_tensor(i, dtype=torch.long, device=words.device)
                for i in np.unravel_index(flips.idx, tuple(words.shape)))
    mask = torch.as_tensor(flips.mask.view(npint), device=words.device)
    iv[sel] = iv[sel] ^ mask


def flip_bits(arr: torch.Tensor, n_crit: int, n_bulk: int,
              rng: np.random.Generator) -> torch.Tensor:
    """Return a copy of ``arr`` with ``n_crit`` sign/exponent flips and
    ``n_bulk`` mantissa flips at uniformly random positions (with
    replacement — colliding flips cancel, as real double errors do)."""
    if n_crit <= 0 and n_bulk <= 0:
        return arr
    return apply_flips(arr, draw_flips(arr.numel(), arr.element_size(),
                                       dtype_name(arr), n_crit, n_bulk, rng))


class FaultInjector:
    """Age-driven bit-flip source for paged KV/state arrays.

    ``rber_at_retention`` (the ``--inject-rber`` value) anchors the error
    curve: a page exactly at its programmed retention sees that RBER; a
    freshly written page sees 1e-5 of it; growth between is exponential in
    age/retention (same law as :func:`repro_torch.core.ecc.rber_at_age`),
    and a page at >= 4x its retention saturates at the 0.5 clamp — pure
    noise.
    """

    def __init__(self, mem, rber_at_retention: float, seed: int = 0,
                 scrub_age_frac: float = 0.75):
        self.mem = mem
        self.rber = float(rber_at_retention)
        self.scrub_age_frac = scrub_age_frac
        self.rng = np.random.default_rng(seed)
        self.stats = FaultStats()

    # -- error model ------------------------------------------------------
    def page_rber(self, region) -> float:
        """Raw bit error rate of a tracked region at the current sim time."""
        age = max(self.mem.now - region.written_at, 0.0)
        tech = self.mem.devices[region.tier].tech
        return rber_at_age(tech, age, region.retention_s,
                           rber0=self.rber * 1e-5,
                           rber_at_retention=self.rber)

    def wants_scrub(self, region) -> bool:
        """True when the page is old enough that a real controller would
        scrub on read (deterministic at ``scrub_age_frac`` of the refresh
        interval — the CI gate relies on this firing before the refresh
        deadline)."""
        age = self.mem.now - region.written_at
        interval = region.retention_s / self.mem.tracker.margin
        return age >= self.scrub_age_frac * interval

    # -- injection --------------------------------------------------------
    def sample(self, size: int, itemsize: int, name: str, region,
               protected: bool) -> Tuple[Optional[Flips], int]:
        """Sample faults for one visit to an array of ``size`` words of
        ``itemsize`` bytes and float dtype ``name``; returns (the flips
        that land, or None, uncorrectable block count this visit). The
        array's values play no part: only its geometry and the page's age.

        ``protected`` states whether an ECC profile is active for the
        page's tier (engine passes ``ecc_profile != "off"``). Callers own
        the ``pages_visited`` counter — one page may span several cache
        leaves, each sampled by its own call.
        """
        if itemsize not in _UINT_FOR_ITEMSIZE:
            return None, 0
        p = self.page_rber(region)
        if p <= 0:
            return None, 0
        lo, word_bits = CRIT_BIT_RANGE.get(name, CRIT_BIT_RANGE["float32"])
        crit_frac = (word_bits - lo) / word_bits
        bits = size * itemsize * 8
        n_crit_raw = int(self.rng.poisson(bits * crit_frac * p))
        n_bulk_raw = int(self.rng.poisson(bits * (1.0 - crit_frac) * p))
        n_bad = 0
        if protected:
            dev = self.mem.devices[region.tier]
            code = dev.ecc.code_for("kv", region.retention_s)
            crit_code = code.crit if isinstance(code, SplitCode) else code
            bulk_t = (code.bulk.correctable if isinstance(code, SplitCode)
                      else code.correctable)
            # accounting scale: does any real block fail to correct?
            n_blocks = max(1, int(region.bytes // dev.tech.block_bytes))
            p_fail = min(10.0 ** uncorrectable_log10(crit_code, p), 1.0)
            n_bad = int(min(self.rng.poisson(n_blocks * p_fail), n_blocks))
            frac_bad = n_bad / n_blocks
            n_crit = int(round(n_crit_raw * frac_bad))
            if n_bad > 0:
                n_crit = max(n_crit, 1)
            # bulk code corrects up to t per compute-scale block; the rest
            # passes through as activation noise
            blocks_compute = max(1, bits // (dev.tech.block_bytes * 8))
            budget = int(blocks_compute * bulk_t)
            n_bulk = max(0, n_bulk_raw - budget)
            self.stats.corrected_bits += (n_crit_raw - n_crit) + (n_bulk_raw - n_bulk)
        else:
            n_crit, n_bulk = n_crit_raw, n_bulk_raw
        n_crit = min(n_crit, MAX_FLIPS_PER_VISIT)
        n_bulk = min(n_bulk, MAX_FLIPS_PER_VISIT)
        self.stats.crit_flips += n_crit
        self.stats.bulk_flips += n_bulk
        self.stats.uncorrectable_blocks += n_bad
        if n_crit == 0 and n_bulk == 0:
            return None, n_bad
        return draw_flips(size, itemsize, name, n_crit, n_bulk, self.rng), n_bad

    def corrupt(self, arr: torch.Tensor, region,
                protected: bool) -> Tuple[Optional[torch.Tensor], int]:
        """Sample faults for one page visit; returns (a corrupted copy of
        ``arr``, or None if nothing landed, uncorrectable block count this
        visit)."""
        flips, n_bad = self.sample(arr.numel(), arr.element_size(),
                                   dtype_name(arr), region, protected)
        return (None if flips is None else apply_flips(arr, flips)), n_bad

    def note_scrub(self) -> None:
        self.stats.scrubs_requested += 1
