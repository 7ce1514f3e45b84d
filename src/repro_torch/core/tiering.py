"""Retention-aware data placement across memory tiers (paper §4).

The placement problem: assign inference data classes (weights, KV cache,
activations) to tiers (HBM / MRM / LPDDR) subject to hard constraints
(capacity, write bandwidth, endurance over device life, retention
serviceability) minimizing energy + amortized cost. Three classes x a
handful of tiers => exhaustive enumeration is exact and auditable.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import dcm
from repro_torch.core.ecc import TierEcc
from repro_torch.core.endurance import writes_per_cell
from repro_torch.core.memclass import YEAR, MemTechnology


@dataclass(frozen=True)
class DataClassProfile:
    """IO profile of one inference data structure (paper §2 tables)."""
    name: str                 # weights | kv_cache | activations
    size_bytes: float
    read_bw_bytes_s: float    # sustained read demand
    write_bw_bytes_s: float   # sustained write demand
    lifetime_s: float         # how long a written byte stays useful
    soft_state: bool          # recomputable (KV) / re-loadable (weights)
    random_access: bool = False  # needs byte addressability (activations)


@dataclass(frozen=True)
class Tier:
    tech: MemTechnology
    capacity_bytes: float
    count: int = 1  # devices/stacks aggregated

    @property
    def read_bw(self) -> float:
        return self.tech.read_bw_gbps * 1e9 * self.count

    @property
    def write_bw(self) -> float:
        return self.tech.write_bw_gbps * 1e9 * self.count


@dataclass
class PlacementResult:
    assignment: Dict[str, str]            # data class -> tier tech name
    feasible: bool
    violations: List[str]
    energy_w: float                       # sustained memory energy (W)
    cost_usd: float                       # capacity cost
    refresh_overhead_bw: Dict[str, float]  # tier -> refresh write B/s
    per_tier_util: Dict[str, Dict[str, float]] = field(default_factory=dict)
    ecc_overhead: Dict[str, float] = field(default_factory=dict)  # class -> check bits/data bit


def _class_on_tier(dc: DataClassProfile, tier: Tier,
                   device_life_s: float,
                   ecc_profile: str = "off") -> Tuple[List[str], float, float, float]:
    """Check one (class, tier) pairing; returns (violations, energy_w,
    refresh_write_bw, ecc_overhead). Under an active ECC profile every
    byte the class stores or moves on a managed tier carries its code's
    check bits (DESIGN.md §11) — capacity, bandwidth and energy all scale
    by (1 + overhead), sized at the class's DCM-programmed retention."""
    v = []
    t = tier.tech
    if dc.random_access and not t.byte_addressable:
        # paper §2.2: byte addressability is NOT required for weights/KV
        # (large sequential IO) — but transient random-access data cannot
        # live behind a block interface
        v.append(f"{dc.name}: random access on block-interface tier {t.name}")
    # retention service: how often must this data be rewritten just to stay alive?
    refresh_bw = 0.0
    ecc_ov = 0.0
    if t.kind == "managed":
        op = dcm.plan_write(t, dc.lifetime_s)
        write_e = op.energy_pj_bit
        effective_endurance = op.endurance_at_point
        if dc.lifetime_s > op.retention_s:
            # must refresh ceil(lifetime/retention) - 1 times
            refresh_bw = dc.size_bytes / op.retention_s
        if ecc_profile != "off":
            klass = "weights" if dc.name == "weights" else "kv"
            ecc_ov = TierEcc(t, ecc_profile).overhead_for(klass, op.retention_s)
    elif t.refresh_interval_s is not None:
        # DRAM-family: refresh is on-die; modelled as constant energy below
        write_e = t.write_energy_pj_bit
        effective_endurance = t.endurance_device
    else:
        # true NVM at fixed 10y retention
        write_e = t.write_energy_pj_bit
        effective_endurance = t.endurance_device

    scale = 1.0 + ecc_ov
    total_write_bw = (dc.write_bw_bytes_s + refresh_bw) * scale
    stored = dc.size_bytes * scale
    read_bw = dc.read_bw_bytes_s * scale
    if stored > tier.capacity_bytes:
        v.append(f"{dc.name}: size {stored:.2e} > capacity {tier.capacity_bytes:.2e}")
    if read_bw > tier.read_bw:
        v.append(f"{dc.name}: read bw {read_bw:.2e} > {tier.read_bw:.2e}")
    if total_write_bw > tier.write_bw:
        v.append(f"{dc.name}: write bw {total_write_bw:.2e} > {tier.write_bw:.2e}")
    wpc = writes_per_cell(total_write_bw, stored, device_life_s)
    if wpc > effective_endurance:
        v.append(f"{dc.name}: {wpc:.2e} writes/cell > endurance {effective_endurance:.2e}")

    energy_w = (read_bw * 8 * t.read_energy_pj_bit
                + total_write_bw * 8 * write_e) * 1e-12
    if t.refresh_interval_s is not None and t.kind == "volatile":
        # DRAM refresh power ~ 1.5 mW/GB
        energy_w += dc.size_bytes / 1e9 * 1.5e-3
    return v, energy_w, refresh_bw, ecc_ov


def evaluate_placement(classes: Sequence[DataClassProfile], tiers: Sequence[Tier],
                       assignment: Dict[str, str],
                       device_life_s: float = 5 * YEAR,
                       ecc_profile: str = "off") -> PlacementResult:
    by_name = {t.tech.name: t for t in tiers}
    violations: List[str] = []
    energy = 0.0
    refresh: Dict[str, float] = {}
    ecc_ovs: Dict[str, float] = {}
    used: Dict[str, float] = {t.tech.name: 0.0 for t in tiers}
    wbw: Dict[str, float] = {t.tech.name: 0.0 for t in tiers}
    rbw: Dict[str, float] = {t.tech.name: 0.0 for t in tiers}
    for dc in classes:
        tier = by_name[assignment[dc.name]]
        v, e, rfr, ov = _class_on_tier(dc, tier, device_life_s, ecc_profile)
        violations += v
        energy += e
        refresh[tier.tech.name] = refresh.get(tier.tech.name, 0.0) + rfr
        ecc_ovs[dc.name] = ov
        used[tier.tech.name] += dc.size_bytes * (1.0 + ov)
        wbw[tier.tech.name] += (dc.write_bw_bytes_s + rfr) * (1.0 + ov)
        rbw[tier.tech.name] += dc.read_bw_bytes_s * (1.0 + ov)
    for t in tiers:
        n = t.tech.name
        if used[n] > t.capacity_bytes:
            violations.append(f"tier {n}: capacity over-subscribed "
                              f"({used[n]:.2e} > {t.capacity_bytes:.2e})")
        if wbw[n] > t.write_bw:
            violations.append(f"tier {n}: write bw over-subscribed")
        if rbw[n] > t.read_bw:
            violations.append(f"tier {n}: read bw over-subscribed")
    cost = sum(t.capacity_bytes / 1e9 * t.tech.cost_usd_per_gb for t in tiers
               if any(assignment[dc.name] == t.tech.name for dc in classes))
    util = {t.tech.name: {
        "capacity": used[t.tech.name] / t.capacity_bytes,
        "read_bw": rbw[t.tech.name] / t.read_bw,
        "write_bw": wbw[t.tech.name] / t.write_bw,
    } for t in tiers}
    return PlacementResult(assignment=dict(assignment),
                           feasible=not violations, violations=violations,
                           energy_w=energy, cost_usd=cost,
                           refresh_overhead_bw=refresh, per_tier_util=util,
                           ecc_overhead=ecc_ovs)


def solve_placement(classes: Sequence[DataClassProfile], tiers: Sequence[Tier],
                    device_life_s: float = 5 * YEAR,
                    objective: str = "energy",
                    ecc_profile: str = "off") -> PlacementResult:
    """Exhaustive exact solve (|classes|^|tiers| is tiny)."""
    names = [t.tech.name for t in tiers]
    best: Optional[PlacementResult] = None
    for combo in itertools.product(names, repeat=len(classes)):
        assignment = {dc.name: tn for dc, tn in zip(classes, combo)}
        res = evaluate_placement(classes, tiers, assignment, device_life_s,
                                 ecc_profile)
        key = (not res.feasible,
               res.energy_w if objective == "energy" else res.cost_usd,
               res.cost_usd)
        if best is None or key < (not best.feasible,
                                  best.energy_w if objective == "energy" else best.cost_usd,
                                  best.cost_usd):
            best = res
    assert best is not None
    return best
