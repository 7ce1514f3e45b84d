"""MRM device + memory-system simulator.

The serving engine drives this with its *real* access stream (weight reads
per step, KV page writes/reads, activations) so the paper's workload claims
(read:write ratio, sequentiality, endurance requirements, energy) are
*measured from the running system*, not asserted.

Instruments per tier: bytes read/written (+ sequentiality), energy, wear
(via `repro_torch.core.endurance`), refresh traffic (via `repro_torch.core.refresh`),
and exports the tokens/J / TCO numbers for `benchmarks/mrm_tco.py`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core import dcm
from repro_torch.core.ecc import TierEcc, design_code, rber_at_age
from repro_torch.core.endurance import WearLevelingAllocator, WearState
from repro_torch.core.memclass import YEAR, MemTechnology
from repro_torch.core.refresh import Action, RefreshScheduler, RetentionTracker


def data_class_of(owner: str) -> str:
    """Map a region owner tag to its ECC data class: ``weights*`` regions
    carry the strict uniform code, everything else (KV pages, state
    snapshots, activations) is inference cache and may take the relaxed
    mantissa protection under the ``domain`` profile (DESIGN.md §11)."""
    return "weights" if owner.startswith("weights") else "kv"


@dataclass
class IOStats:
    read_bytes: float = 0.0
    write_bytes: float = 0.0
    refresh_bytes: float = 0.0
    read_energy_j: float = 0.0
    write_energy_j: float = 0.0
    n_reads: int = 0
    n_writes: int = 0
    seq_read_bytes: float = 0.0  # reads declared sequential by the caller
    # ECC check-bit traffic rides in separate counters so data-plane
    # identities (kv tier reads == kernel page-gather bytes) survive any
    # profile: the step-latency model adds them in, read_bytes never
    # includes them (DESIGN.md §11)
    ecc_read_bytes: float = 0.0
    ecc_write_bytes: float = 0.0
    scrub_read_bytes: float = 0.0  # data+check bytes re-read by scrubs
    n_scrubs: int = 0

    @property
    def rw_ratio(self) -> float:
        return self.read_bytes / self.write_bytes if self.write_bytes else float("inf")

    @property
    def seq_fraction(self) -> float:
        return self.seq_read_bytes / self.read_bytes if self.read_bytes else 0.0


class MemDevice:
    """One tier: a technology + capacity with wear, retention and ECC."""

    def __init__(self, tech: MemTechnology, capacity_bytes: int,
                 uber_target: float = 1e-15, ecc_profile: str = "off"):
        self.tech = tech
        self.capacity = capacity_bytes
        self.ecc = TierEcc(tech, ecc_profile, uber_target)
        # wear-tracking granularity: cap the array at ~1M entries so huge
        # simulated devices stay cheap to track (a tracking block may span
        # several physical blocks; wear stats are per tracking block)
        self.track_block_bytes = max(tech.block_bytes,
                                     -(-capacity_bytes // (1 << 20)))
        self.n_blocks = max(1, capacity_bytes // self.track_block_bytes)
        self.wear = WearState(self.n_blocks, self.track_block_bytes,
                              tech.endurance_device)
        self.alloc = WearLevelingAllocator(self.wear)
        self.stats = IOStats()
        # retention-aware ECC: size the code for the RBER at refresh age
        if tech.kind == "managed":
            ref_age = tech.retention_s / 2
            self.code = design_code(tech.block_bytes,
                                    rber_at_age(tech, ref_age, tech.retention_s),
                                    uber_target)
        else:
            self.code = design_code(tech.block_bytes, 1e-9, uber_target)

    # -- IO ---------------------------------------------------------------
    def read(self, nbytes: float, sequential: bool = True,
             data_class: str = "kv",
             retention_s: Optional[float] = None) -> None:
        """Meter a data read. Invariant: ``read_bytes`` counts *data* bytes
        only — the check bits that ride along under an active ECC profile
        land in ``ecc_read_bytes`` (energy charged, latency charged via
        :meth:`MemorySystem.step_latency_since`), so data-plane byte
        identities are profile-independent."""
        s = self.stats
        s.read_bytes += nbytes
        s.n_reads += 1
        if sequential:
            s.seq_read_bytes += nbytes
        eb = nbytes * self.ecc.overhead_for(
            data_class, retention_s if retention_s is not None
            else self.tech.retention_s)
        s.ecc_read_bytes += eb
        s.read_energy_j += (nbytes + eb) * 8 * self.tech.read_energy_pj_bit * 1e-12

    def write(self, nbytes: float, expected_lifetime_s: Optional[float] = None,
              refresh: bool = False, data_class: str = "kv") -> dcm.WriteOp:
        """Meter a data write (or refresh rewrite). Same ECC invariant as
        :meth:`read`: check bits for the write's programmed retention land
        in ``ecc_write_bytes``, never in ``write_bytes``/``refresh_bytes``."""
        if expected_lifetime_s is None:
            expected_lifetime_s = self.tech.retention_s / 2.0
        op = dcm.plan_write(self.tech, expected_lifetime_s)
        s = self.stats
        if refresh:
            s.refresh_bytes += nbytes
        else:
            s.write_bytes += nbytes
            s.n_writes += 1
        eb = nbytes * self.ecc.overhead_for(data_class, op.retention_s)
        s.ecc_write_bytes += eb
        s.write_energy_j += (nbytes + eb) * 8 * op.energy_pj_bit * 1e-12
        return op

    def blocks_for(self, nbytes: float) -> int:
        return max(1, int(-(-nbytes // self.track_block_bytes)))

    def blocks_for_stored(self, nbytes: float, data_class: str,
                          retention_s: float) -> int:
        """Capacity-ledger tenant rule (DESIGN.md §11): a stored region
        occupies blocks for its data bytes *plus* the check bits its code
        requires at this retention — ECC overhead is charged into the same
        per-tier block ledger as the data it protects."""
        ov = self.ecc.overhead_for(data_class, retention_s)
        return self.blocks_for(nbytes * (1.0 + ov))

    @property
    def energy_j(self) -> float:
        return self.stats.read_energy_j + self.stats.write_energy_j

    def report(self) -> dict:
        s = self.stats
        return {
            "tech": self.tech.name,
            "capacity_gb": self.capacity / 1e9,
            "read_gb": s.read_bytes / 1e9,
            "write_gb": s.write_bytes / 1e9,
            "refresh_gb": s.refresh_bytes / 1e9,
            "rw_ratio": s.rw_ratio,
            "seq_fraction": s.seq_fraction,
            "energy_j": self.energy_j,
            "wear_max": self.wear.max_wear,
            "wear_ratio": self.wear.wear_ratio,
            "life_used": self.wear.life_used(),
            "ecc_overhead": self.code.overhead,
            "ecc_profile": self.ecc.profile,
            "ecc_read_gb": s.ecc_read_bytes / 1e9,
            "ecc_write_gb": s.ecc_write_bytes / 1e9,
            "scrub_read_gb": s.scrub_read_bytes / 1e9,
            "n_scrubs": s.n_scrubs,
            "utilization": self.alloc.utilization,
        }


class MemorySystem:
    """Tiers + retention tracker + refresh scheduler, as one control plane."""

    def __init__(self, tiers: Dict[str, Tuple[MemTechnology, int]],
                 margin: float = 2.0, ecc_profile: str = "off",
                 service_refresh: bool = True):
        self.devices: Dict[str, MemDevice] = {
            name: MemDevice(tech, cap, ecc_profile=ecc_profile)
            for name, (tech, cap) in tiers.items()}
        self.ecc_profile = ecc_profile
        #: A/B switch for the reliability gate: with ``service_refresh``
        #: off, retention deadlines are never serviced, so regions age past
        #: their programmed retention and the fault injector sees the
        #: over-aged RBER (CI asserts decode degrades; DESIGN.md §11).
        self.service_refresh = service_refresh
        self.tracker = RetentionTracker(margin=margin)
        self.scheduler = RefreshScheduler(self.tracker)
        self.now = 0.0
        self._regions: Dict[int, Tuple[str, List[int]]] = {}

    def advance(self, dt: float) -> List:
        """Advance simulation time; service refresh deadlines."""
        self.now += dt
        if not self.service_refresh:
            return []
        actions = self.scheduler.tick(self.now)
        for a in actions:
            dev = self.devices[a.region.tier]
            if a.action == Action.REFRESH:
                dev.write(a.region.bytes,
                          expected_lifetime_s=a.region.retention_s / self.tracker.margin,
                          refresh=True, data_class=data_class_of(a.region.owner))
                blocks = self._regions.get(a.region.region_id, (None, []))[1]
                if blocks:
                    dev.alloc.rewrite_in_place(blocks)
            else:
                _, blocks = self._regions.pop(a.region.region_id, (None, []))
                if blocks:
                    dev.alloc.free_blocks(blocks)
        return actions

    def write_region(self, tier: str, owner: str, nbytes: float,
                     expected_lifetime_s: float, sequential: bool = True) -> Optional[int]:
        """Allocate + write a region with DCM-programmed retention.
        Returns a region id (None = allocation failure)."""
        dev = self.devices[tier]
        dc = data_class_of(owner)
        # size the block claim at the *programmed* retention's code so the
        # capacity ledger carries the check-bit tenant from allocation on
        ret = dcm.plan_write(dev.tech, expected_lifetime_s).retention_s
        nblocks = dev.blocks_for_stored(nbytes, dc, ret)
        blocks = dev.alloc.alloc(nblocks)
        if blocks is None:
            return None
        op = dev.write(nbytes, expected_lifetime_s=expected_lifetime_s,
                       data_class=dc)
        rid = self.tracker.track(owner, tier, nblocks, nbytes, self.now,
                                 op.retention_s)
        self._regions[rid] = (tier, blocks)
        return rid

    def read_region(self, rid: int, nbytes: Optional[float] = None,
                    sequential: bool = True) -> None:
        r = self.tracker.get(rid)  # O(1): hottest call in the serving loop
        if r is None:
            return
        self.devices[r.tier].read(nbytes if nbytes is not None else r.bytes,
                                  sequential, data_class=data_class_of(r.owner),
                                  retention_s=r.retention_s)
        self.tracker.touch(rid, self.now)

    def scrub_region(self, rid: int) -> bool:
        """Scrub-on-read: re-read the region's data + check bits, correct,
        and rewrite in place at the same retention point.

        Metering invariant ("scrub-charged-as-refresh", DESIGN.md §11):
        the read side lands in ``scrub_read_bytes`` (data + check bits,
        read energy charged), the corrective rewrite is charged exactly
        like a scheduled refresh — ``refresh_bytes`` + ECC check bits +
        in-place wear — and the retention clock re-arms, so a scrubbed
        page needs no separate refresh this deadline. Returns False for
        unknown/released regions."""
        r = self.tracker.get(rid)
        if r is None:
            return False
        dev = self.devices[r.tier]
        dc = data_class_of(r.owner)
        ov = dev.ecc.overhead_for(dc, r.retention_s)
        s = dev.stats
        s.scrub_read_bytes += r.bytes * (1.0 + ov)
        s.read_energy_j += r.bytes * (1.0 + ov) * 8 * dev.tech.read_energy_pj_bit * 1e-12
        s.n_scrubs += 1
        dev.write(r.bytes, expected_lifetime_s=r.retention_s / self.tracker.margin,
                  refresh=True, data_class=dc)
        blocks = self._regions.get(rid, (None, []))[1]
        if blocks:
            dev.alloc.scrub_in_place(blocks)
        self.tracker.rearm(r, self.now)
        return True

    def region(self, rid: int):
        """O(1) region metadata lookup (tier, bytes, deadlines)."""
        return self.tracker.get(rid)

    def utilization(self, tier: str) -> float:
        """Fraction of the tier's tracked blocks currently allocated."""
        return self.devices[tier].alloc.utilization

    # -- per-tier step-latency model -----------------------------------
    def snapshot(self) -> Dict[str, Tuple[float, float]]:
        """Per-tier (read_bytes, write+refresh_bytes) counters; pair with
        :meth:`step_latency_since` to time an engine step. ECC check-bit
        and scrub traffic is folded into the totals here (the wire moves
        those bits, so the step-latency model must charge them) while the
        per-class data counters stay ECC-free."""
        return {n: (d.stats.read_bytes + d.stats.ecc_read_bytes
                    + d.stats.scrub_read_bytes,
                    d.stats.write_bytes + d.stats.refresh_bytes
                    + d.stats.ecc_write_bytes)
                for n, d in self.devices.items()}

    def step_latency_since(self, snap: Dict[str, Tuple[float, float]],
                           floor_s: float = 1e-4) -> Tuple[float, Dict[str, dict]]:
        """Model the wall time of the traffic since ``snap``: each tier
        serves its own reads at its read bandwidth and its writes at its
        write bandwidth; tiers run in parallel, so the step takes as long
        as the slowest tier (not all bytes charged to one tier's read BW).
        Returns (step_seconds, per-tier byte/latency breakdown)."""
        step_s = floor_s
        per_tier: Dict[str, dict] = {}
        for n, d in self.devices.items():
            r0, w0 = snap.get(n, (0.0, 0.0))
            dr = (d.stats.read_bytes + d.stats.ecc_read_bytes
                  + d.stats.scrub_read_bytes) - r0
            dw = (d.stats.write_bytes + d.stats.refresh_bytes
                  + d.stats.ecc_write_bytes) - w0
            lat = (dr / (d.tech.read_bw_gbps * 1e9) +
                   dw / (d.tech.write_bw_gbps * 1e9))
            per_tier[n] = {"read_bytes": dr, "write_bytes": dw,
                           "latency_s": lat}
            step_s = max(step_s, lat)
        return step_s, per_tier

    def release_region(self, rid: int) -> None:
        self.tracker.release(rid)
        entry = self._regions.pop(rid, None)
        if entry:
            tier, blocks = entry
            self.devices[tier].alloc.free_blocks(blocks)

    def report(self) -> dict:
        return {
            "now_s": self.now,
            "ecc_profile": self.ecc_profile,
            "tiers": {n: d.report() for n, d in self.devices.items()},
            "refresh_stats": dict(self.tracker.stats),
            "total_energy_j": sum(d.energy_j for d in self.devices.values()),
        }
