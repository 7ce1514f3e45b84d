"""Dynamically Configurable Memory (paper §4): per-write programmable
retention, with the retention <-> write-energy <-> endurance trade-off.

Model (anchored on the STT-MRAM thermal-stability relation and the RRAM
retention/endurance studies the paper cites [14, 18, 31, 41, 47]):

- retention is exponential in the thermal stability factor Delta
  (t_ret ~ tau0 * exp(Delta)), and write energy is roughly linear in Delta
  => write_energy(r) = e_nom * (1 + alpha * ln(r / r_nom))
- endurance degrades with write stress, which scales with Delta
  => endurance(r) = E_nom * (r_nom / r)^beta

alpha/beta are per-technology coefficients on :class:`MemTechnology`.
The control plane (refresh scheduler) chooses the retention target from the
data's expected lifetime, "right-provisioning the MRM to the workload".
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.memclass import MemTechnology

_TAU0 = 1e-9  # attempt time; ln(r/tau0) ~ Delta


@dataclass(frozen=True)
class WriteOp:
    """Cost/effect of one block write at a programmed retention."""
    retention_s: float
    energy_pj_bit: float
    latency_scale: float      # relative to nominal write latency
    endurance_at_point: float  # cell endurance when always written like this


def clamp_retention(tech: MemTechnology, retention_s: float) -> float:
    """Programmable range: 1 second .. the technology's nominal retention."""
    return max(1.0, min(retention_s, tech.retention_s))


def write_energy(tech: MemTechnology, retention_s: float) -> float:
    """pJ/bit to program a cell for the given retention target.

    energy ~ e_nom * (Delta(r)/Delta(r_nom))^(1+2*alpha): the stability
    ratio enters superlinearly because both pulse amplitude and duration
    shrink with the barrier (fit to the relaxed-retention STT-RAM numbers
    in [41]: ~3-4x write-energy reduction at seconds-scale retention).
    """
    r = clamp_retention(tech, retention_s)
    if tech.dcm_alpha <= 0:
        return tech.write_energy_pj_bit
    ratio = math.log(r / _TAU0) / math.log(tech.retention_s / _TAU0)
    return tech.write_energy_pj_bit * max(0.12, ratio ** (1.0 + 2.0 * tech.dcm_alpha))


def endurance_at(tech: MemTechnology, retention_s: float) -> float:
    """Cell endurance when writes are programmed at the given retention."""
    r = clamp_retention(tech, retention_s)
    if tech.dcm_beta <= 0:
        return tech.endurance_device
    gain = (tech.retention_s / r) ** tech.dcm_beta
    return min(tech.endurance_device * gain, tech.endurance_potential)


def plan_write(tech: MemTechnology, expected_lifetime_s: float,
               margin: float = 2.0) -> WriteOp:
    """The DCM policy: program retention = margin x expected lifetime.

    margin > 1 keeps an ECC/refresh safety window (see repro_torch.core.ecc);
    the refresh scheduler treats retention/margin as the service deadline.
    """
    r = clamp_retention(tech, expected_lifetime_s * margin)
    e = write_energy(tech, r)
    return WriteOp(
        retention_s=r,
        energy_pj_bit=e,
        latency_scale=max(0.25, e / tech.write_energy_pj_bit),
        endurance_at_point=endurance_at(tech, r),
    )


def refresh_deadline(op: WriteOp, written_at_s: float, margin: float = 2.0) -> float:
    """Absolute time by which the block must be refreshed, migrated, or
    dropped (retention minus the safety window)."""
    return written_at_s + op.retention_s / margin
