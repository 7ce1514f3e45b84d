"""Retention-aware block error correction (paper §4).

The block interface permits large codewords, which buy correction capability
per parity bit (the paper cites the block-size/performance relation [8]).
RBER grows as a stored block ages toward its programmed retention; the
control plane picks a code (or a refresh deadline) so the uncorrectable
block error rate stays under target *at the scheduled refresh age*, not at
10-year retirement — that is what "retention-aware" buys.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.memclass import MemTechnology


def rber_at_age(tech: MemTechnology, age_s: float, retention_s: float,
                rber0: float = 1e-9, rber_at_retention: float = 1e-4) -> float:
    """Raw bit error rate vs age. Retention is defined as the age where
    RBER reaches `rber_at_retention`; growth is exponential in age/retention
    (thermal-activation loss model, matching the RRAM retention studies
    [22, 31])."""
    frac = min(max(age_s, 0.0) / max(retention_s, 1e-9), 4.0)
    k = math.log(rber_at_retention / rber0)
    return min(rber0 * math.exp(k * frac), 0.5)


def _log_binom_tail(n: int, t: int, p: float) -> float:
    """log10 P[#errors > t] for Bin(n, p), via the dominant term + union
    bound (adequate for p*n << t regimes used here). Below the
    distribution's mode the dominant term at exactly t+1 errors
    *under*-estimates the tail (the mass sits at ~n*p errors, far above
    t), so that regime is reported as certain failure — without the
    guard, `design_code` would happily return t=1 codes at RBERs where
    every block fails."""
    if p <= 0:
        return -300.0
    if p >= 0.5:
        return 0.0  # certain failure regime
    if t < n * p:
        return math.log10(0.5)  # t below the mode: tail >= ~1/2
    # dominant term: exactly t+1 errors
    k = t + 1
    logc = (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))
    logp = logc + k * math.log(p) + (n - k) * math.log1p(-p)
    return logp / math.log(10)


@dataclass(frozen=True)
class BlockCode:
    """BCH-like block code over an MRM block."""
    data_bits: int
    parity_bits: int
    correctable: int  # t

    @property
    def n_bits(self) -> int:
        return self.data_bits + self.parity_bits

    @property
    def overhead(self) -> float:
        return self.parity_bits / self.data_bits


def design_code(block_bytes: int, rber: float, uber_target: float = 1e-15,
                m_bits: int = 15) -> BlockCode:
    """Smallest-t BCH-style code for a block at the given RBER.

    BCH over GF(2^m): t errors cost ~ m*t parity bits. Large blocks
    (>= 4 KiB) amortize parity better than 512 B sectors — the §4 claim.
    """
    data_bits = block_bytes * 8
    for t in range(1, 257):
        n = data_bits + m_bits * t
        if _log_binom_tail(n, t, rber) < math.log10(uber_target):
            return BlockCode(data_bits=data_bits, parity_bits=m_bits * t,
                             correctable=t)
    raise ValueError(f"no code with t<=256 reaches UBER {uber_target} at RBER {rber}")


def max_safe_age(tech: MemTechnology, code: BlockCode, retention_s: float,
                 uber_target: float = 1e-15) -> float:
    """Largest age at which the code still meets the UBER target — the
    refresh scheduler's deadline input."""
    lo, hi = 0.0, 4.0 * retention_s
    for _ in range(60):
        mid = (lo + hi) / 2
        p = rber_at_age(tech, mid, retention_s)
        if _log_binom_tail(code.n_bits, code.correctable, p) < math.log10(uber_target):
            lo = mid
        else:
            hi = mid
    return lo


# ---------------------------------------------------------------------------
# Reliability plane (DESIGN.md §11): lower-margin cells + domain-specific ECC
# ---------------------------------------------------------------------------

#: fraction of a bf16 word that inference *cannot* tolerate flipping:
#: sign + 8 exponent bits of 16 (the domain-specific-ECC argument — an
#: exponent flip rescales an activation by up to 2^127, a mantissa flip
#: adds bounded relative noise; PAPERS.md "Breaking the HBM Bit Cost
#: Barrier").
CRIT_FRAC_BF16 = 9.0 / 16.0

#: RBER growth exponent for lower-margin (denser/cheaper) cells: a write
#: programmed at retention r runs cells whose refresh-age RBER is the
#: nominal-margin value scaled by (retention_nominal / r) ** MARGIN_GAMMA
#: — the density lever MRM trades on (paper §4): short-lived data accepts
#: leakier cells, and ECC + refresh absorb the difference.
MARGIN_GAMMA = 1.5

#: designable ceiling for the derated RBER (t <= 256 over a 4 KiB block)
MARGIN_RBER_CAP = 2e-3

#: the serving lifecycle's retention ladder as fractions of a tier's
#: nominal retention — the operating points the TCO/roofline sweeps
#: evaluate ECC overhead at (hot prefix / session page / spill-tier page /
#: over-provisioned spill; DESIGN.md §9, §11)
STATE_RETENTION_FRAC = {
    "hot": 1.0 / 24.0,
    "demoted": 1.0 / 144.0,
    "cold": 1.0 / 288.0,
    "spilled": 1.0 / 1152.0,
}

#: ECC metering profiles accepted by MemorySystem / TierEcc
ECC_PROFILES = ("off", "uniform", "domain")


def margin_derate(tech: MemTechnology, retention_s: float,
                  gamma: float = MARGIN_GAMMA) -> float:
    """RBER multiplier for the lower-margin cells a short-retention write
    runs on (>= 1; 1 at nominal retention)."""
    r = max(min(retention_s, tech.retention_s), 1.0)
    return (tech.retention_s / r) ** gamma


def derated_rber_at_age(tech: MemTechnology, age_s: float, retention_s: float,
                        rber0: float = 1e-9,
                        rber_at_retention: float = 1e-4,
                        gamma: float = MARGIN_GAMMA) -> float:
    """`rber_at_age` on lower-margin cells: both anchor points scale with
    the margin derate, capped at the designable ceiling."""
    d = margin_derate(tech, retention_s, gamma)
    return min(rber_at_age(tech, age_s, retention_s,
                           rber0=min(rber0 * d, MARGIN_RBER_CAP),
                           rber_at_retention=min(rber_at_retention * d,
                                                 MARGIN_RBER_CAP)), 0.5)


def cell_cost_factor(tech: MemTechnology, retention_s: float) -> float:
    """Relative $/GB of the lower-margin cells a short-retention write may
    use (< 1 below nominal retention): relaxed write margin buys density.
    A mild power law floored at 0.65 — the economics coefficient the TCO
    sweep trades against the ECC check-bit overhead."""
    r = max(min(retention_s, tech.retention_s), 1.0)
    return max(0.65, (r / tech.retention_s) ** 0.06)


@dataclass(frozen=True)
class SplitCode:
    """Domain-specific codeword over one block: sign+exponent bits under a
    strict code, mantissa bits under a fixed light code (t=1: flips beyond
    it pass through as bounded activation noise rather than corruption —
    the exponent-protected / mantissa-relaxed trade for KV pages)."""
    crit: BlockCode   # sign + exponent region, strict UBER target
    bulk: BlockCode   # mantissa region, fixed light correction

    @property
    def data_bits(self) -> int:
        return self.crit.data_bits + self.bulk.data_bits

    @property
    def parity_bits(self) -> int:
        return self.crit.parity_bits + self.bulk.parity_bits

    @property
    def n_bits(self) -> int:
        return self.data_bits + self.parity_bits

    @property
    def correctable(self) -> int:
        return self.crit.correctable

    @property
    def overhead(self) -> float:
        return self.parity_bits / self.data_bits


def design_split_code(block_bytes: int, rber: float,
                      uber_target: float = 1e-15,
                      crit_frac: float = CRIT_FRAC_BF16,
                      bulk_correctable: int = 1,
                      m_bits: int = 15) -> SplitCode:
    """Exponent-protected / mantissa-relaxed codeword for a KV block: the
    critical `crit_frac` of the bits gets a strict `design_code`, the
    mantissa remainder a fixed t=`bulk_correctable` code. Beats the
    uniform-strict code exactly where the density lever operates (derated
    RBER >= ~1e-5); at nominal-margin RBER the two are equivalent and the
    caller should prefer whichever is smaller."""
    crit_bytes = max(1, round(block_bytes * crit_frac))
    bulk_bits = block_bytes * 8 - crit_bytes * 8
    crit = design_code(crit_bytes, rber, uber_target, m_bits)
    bulk = BlockCode(data_bits=bulk_bits,
                     parity_bits=m_bits * bulk_correctable,
                     correctable=bulk_correctable)
    return SplitCode(crit=crit, bulk=bulk)


def uncorrectable_log10(code: BlockCode, rber: float) -> float:
    """log10 P[one codeword fails to correct] at the given RBER."""
    return _log_binom_tail(code.n_bits, code.correctable, rber)


class TierEcc:
    """Per-retention-state, per-data-class code selection for one tier.

    The policy of DESIGN.md §11: weights always carry the strict uniform
    code (an exponent *or* mantissa flip in a weight replays into every
    token until redeploy); KV/state pages under the ``domain`` profile
    carry the split exponent-protected / mantissa-relaxed codeword when it
    is cheaper at the write's derated RBER. Codes are sized at the
    *scheduled refresh age* (retention / margin at service time ~
    retention/2) on the lower-margin cells the write's retention admits,
    and cached per (data class, quantized retention).
    """

    def __init__(self, tech: MemTechnology, profile: str,
                 uber_target: float = 1e-15,
                 crit_frac: float = CRIT_FRAC_BF16,
                 gamma: float = MARGIN_GAMMA):
        if profile not in ECC_PROFILES:
            raise ValueError(f"ecc profile {profile!r} not in {ECC_PROFILES}")
        self.tech = tech
        self.profile = profile
        self.uber_target = uber_target
        self.crit_frac = crit_frac
        self.gamma = gamma
        self._cache: dict = {}

    def design_rber(self, retention_s: float) -> float:
        """RBER the code must cover: refresh age (retention/2) on the
        lower-margin cells this retention admits."""
        r = max(min(retention_s, self.tech.retention_s), 1.0)
        return derated_rber_at_age(self.tech, r / 2.0, r, gamma=self.gamma)

    def code_for(self, data_class: str, retention_s: float):
        """BlockCode (weights / uniform profile) or SplitCode (KV under
        ``domain``) for a write programmed at ``retention_s``."""
        if self.profile == "off":
            return None
        # quantize retention to 1/8-decade buckets: one designed code per
        # operating point, not per write
        r = max(min(retention_s, self.tech.retention_s), 1.0)
        key = (data_class, round(8 * math.log10(r)))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        rber = self.design_rber(r)
        uniform = design_code(self.tech.block_bytes, rber, self.uber_target)
        code = uniform
        if self.profile == "domain" and data_class != "weights":
            split = design_split_code(self.tech.block_bytes, rber,
                                      self.uber_target, self.crit_frac)
            if split.overhead < uniform.overhead:
                code = split
        self._cache[key] = code
        return code

    def overhead_for(self, data_class: str, retention_s: float) -> float:
        """Check-bit bytes per data byte — the capacity/traffic multiplier
        every metering point charges (0 when the profile is off)."""
        code = self.code_for(data_class, retention_s)
        return 0.0 if code is None else code.overhead

    def summary(self) -> dict:
        """Per-state overheads for reporting (kv class, lifecycle ladder)."""
        if self.profile == "off":
            return {"profile": "off"}
        out = {"profile": self.profile}
        for state, frac in STATE_RETENTION_FRAC.items():
            out[state] = self.overhead_for("kv", self.tech.retention_s * frac)
        out["weights"] = self.overhead_for("weights", self.tech.retention_s)
        return out
