"""Memory-technology models: the quantitative substrate of the paper.

Each :class:`MemTechnology` captures the metrics the paper's §2-§3 argue
over: read/write bandwidth, energy per bit, *retention time*, *endurance*
(device-demonstrated vs technology-potential), density/cost, and the access
granularity. Constants are order-of-magnitude, sourced from the paper's own
citations (documented inline); the benchmarks validate orders of magnitude,
not point values (DESIGN.md §5).

The MRM_* entries are the paper's proposal: SCM technologies re-operated at
relaxed retention (hours-days instead of 10+ years), trading retention for
endurance / write energy via the DCM model in `repro_torch.core.dcm`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

HOUR = 3600.0
DAY = 24 * HOUR
YEAR = 365.25 * DAY


@dataclass(frozen=True)
class MemTechnology:
    name: str
    kind: str  # "volatile" | "nonvolatile" | "managed"
    # bandwidth per device/stack (GB/s)
    read_bw_gbps: float
    write_bw_gbps: float
    # energy (pJ/bit) — paper §2.1: ~1/3 of accelerator energy is memory
    read_energy_pj_bit: float
    write_energy_pj_bit: float
    # endurance: writes per cell
    endurance_device: float      # demonstrated in shipping devices
    endurance_potential: float   # technology potential (paper Fig. 1 sources)
    # retention at the nominal operating point (seconds)
    retention_s: float
    # DRAM-style refresh period (None = no refresh needed at this retention)
    refresh_interval_s: Optional[float]
    # density / economics
    cost_usd_per_gb: float
    # access granularity (the paper: block-level access is fine for inference)
    byte_addressable: bool
    block_bytes: int
    # DCM trade-off coefficients (see repro_torch.core.dcm)
    dcm_alpha: float = 0.0   # write-energy vs retention slope
    dcm_beta: float = 0.0    # endurance vs retention exponent


# ---------------------------------------------------------------------------
# Technology table. Sources (paper citations):
#  [5]  Optane DIMM endurance (blocksandfiles 2019)
#  [27] Meena et al., Overview of emerging NVM technologies (potentials)
#  [29] Weebit ReRAM (embedded, 2x nm)
#  [37] Everspin STT-MRAM 2x nm GP-MCU arrays
#  [46] Sun, Memory-hierarchy design with emerging memories
#  [50] B200 HBM (8 TB/s, 192 GB)
#  HBM3e stack numbers: ~1.2 TB/s, 24-36 GB/stack.
# ---------------------------------------------------------------------------

TECHNOLOGIES: Dict[str, MemTechnology] = {}


def _reg(t: MemTechnology) -> MemTechnology:
    TECHNOLOGIES[t.name] = t
    return t


HBM3E = _reg(MemTechnology(
    name="hbm3e", kind="volatile",
    read_bw_gbps=1200.0, write_bw_gbps=1200.0,
    read_energy_pj_bit=3.5, write_energy_pj_bit=3.5,   # ~pJ/bit incl. PHY
    endurance_device=1e16, endurance_potential=1e16,   # DRAM: unlimited in practice
    retention_s=64e-3, refresh_interval_s=32e-3,       # ms-scale cell retention
    cost_usd_per_gb=12.0,                              # yield/stacking premium (§2.1)
    byte_addressable=True, block_bytes=32,
))

DDR5 = _reg(MemTechnology(
    name="ddr5", kind="volatile",
    read_bw_gbps=64.0, write_bw_gbps=64.0,
    read_energy_pj_bit=12.0, write_energy_pj_bit=12.0,  # off-package IO
    endurance_device=1e16, endurance_potential=1e16,
    retention_s=64e-3, refresh_interval_s=32e-3,
    cost_usd_per_gb=3.0,
    byte_addressable=True, block_bytes=64,
))

LPDDR5X = _reg(MemTechnology(
    name="lpddr5x", kind="volatile",
    read_bw_gbps=68.0, write_bw_gbps=68.0,
    read_energy_pj_bit=5.5, write_energy_pj_bit=5.5,
    endurance_device=1e16, endurance_potential=1e16,
    retention_s=64e-3, refresh_interval_s=32e-3,
    cost_usd_per_gb=4.0,                                # GB200's capacity tier [32]
    byte_addressable=True, block_bytes=64,
))

NAND_SLC = _reg(MemTechnology(
    name="nand_slc", kind="nonvolatile",
    read_bw_gbps=3.0, write_bw_gbps=0.5,
    read_energy_pj_bit=8.0, write_energy_pj_bit=60.0,
    endurance_device=1e5, endurance_potential=1e5,      # paper §3: not enough [7]
    retention_s=10 * YEAR, refresh_interval_s=None,
    cost_usd_per_gb=0.30,
    byte_addressable=False, block_bytes=16384,
))

OPTANE_PCM = _reg(MemTechnology(
    name="optane_pcm", kind="nonvolatile",
    read_bw_gbps=40.0, write_bw_gbps=10.0,
    read_energy_pj_bit=2.0, write_energy_pj_bit=50.0,   # RESET current dominates
    endurance_device=1e8, endurance_potential=1e12,     # [5] device; [27] potential
    retention_s=10 * YEAR, refresh_interval_s=None,
    cost_usd_per_gb=2.0,
    byte_addressable=True, block_bytes=256,
    dcm_alpha=0.35, dcm_beta=0.45,
))

RRAM_DEVICE = _reg(MemTechnology(
    name="rram", kind="nonvolatile",
    read_bw_gbps=20.0, write_bw_gbps=2.0,
    read_energy_pj_bit=1.5, write_energy_pj_bit=20.0,
    endurance_device=1e6, endurance_potential=1e12,     # [29] device; [27,31] potential
    retention_s=10 * YEAR, refresh_interval_s=None,
    cost_usd_per_gb=1.0,
    byte_addressable=True, block_bytes=256,
    dcm_alpha=0.4, dcm_beta=0.5,
))

STT_MRAM_DEVICE = _reg(MemTechnology(
    name="stt_mram", kind="nonvolatile",
    read_bw_gbps=60.0, write_bw_gbps=15.0,
    read_energy_pj_bit=1.0, write_energy_pj_bit=10.0,
    endurance_device=1e10, endurance_potential=1e15,    # [37] device; [27,46] potential
    retention_s=10 * YEAR, refresh_interval_s=None,
    cost_usd_per_gb=5.0,
    byte_addressable=True, block_bytes=64,
    dcm_alpha=0.5, dcm_beta=0.6,
))

# ---------------------------------------------------------------------------
# MRM operating points: the paper's proposal. Same physical technologies,
# re-operated at relaxed retention (days, managed by the software control
# plane) — endurance and write energy improve per the DCM model; read path
# engineered for bandwidth (wide block interface, no random-access overhead,
# lightweight controller).
# ---------------------------------------------------------------------------

MRM_PCM = _reg(MemTechnology(
    name="mrm_pcm", kind="managed",
    read_bw_gbps=900.0, write_bw_gbps=90.0,             # read-optimized stack
    read_energy_pj_bit=1.2, write_energy_pj_bit=18.0,   # relaxed-RESET writes
    endurance_device=3e10, endurance_potential=1e12,
    retention_s=2 * DAY, refresh_interval_s=1 * DAY,
    cost_usd_per_gb=2.5,
    byte_addressable=False, block_bytes=4096,
    dcm_alpha=0.35, dcm_beta=0.45,
))

MRM_RRAM = _reg(MemTechnology(
    name="mrm_rram", kind="managed",
    read_bw_gbps=800.0, write_bw_gbps=60.0,
    read_energy_pj_bit=0.9, write_energy_pj_bit=8.0,
    endurance_device=1e10, endurance_potential=1e12,
    retention_s=1 * DAY, refresh_interval_s=12 * HOUR,
    cost_usd_per_gb=1.5,
    byte_addressable=False, block_bytes=4096,
    dcm_alpha=0.4, dcm_beta=0.5,
))

MRM_MRAM = _reg(MemTechnology(
    name="mrm_mram", kind="managed",
    read_bw_gbps=1000.0, write_bw_gbps=200.0,
    read_energy_pj_bit=0.8, write_energy_pj_bit=4.0,    # low-barrier cells [41, 47]
    endurance_device=1e12, endurance_potential=1e15,
    retention_s=6 * HOUR, refresh_interval_s=3 * HOUR,
    cost_usd_per_gb=4.0,
    byte_addressable=False, block_bytes=1024,
    dcm_alpha=0.5, dcm_beta=0.6,
))


def get_technology(name: str) -> MemTechnology:
    if name not in TECHNOLOGIES:
        raise KeyError(f"unknown memory technology {name!r}; "
                       f"known: {sorted(TECHNOLOGIES)}")
    return TECHNOLOGIES[name]


def derated(tech: MemTechnology, **overrides) -> MemTechnology:
    return replace(tech, **overrides)
