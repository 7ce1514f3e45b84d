"""Dynamically Configurable Memory (paper §4) demo on the PyTorch port's
control plane (``examples/dcm_retention_demo.py`` through
``repro_torch.core``): the same RRAM cells serve hour-lived KV pages and
day-lived weights at different write energies, while the cluster-level
refresh scheduler keeps everything alive exactly as long as needed — and
not longer. Pure Python: nothing computes on a device.

Run:  PYTHONPATH=src python examples/dcm_retention_demo_torch.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.dcm import plan_write
from repro_torch.core.memclass import DAY, HOUR, MRM_RRAM
from repro_torch.core.simulator import MemorySystem


def main():
    print("DCM write-energy vs programmed retention (MRM-RRAM):")
    for life, label in [(10.0, "10 s  (speculative draft)"),
                        (600.0, "10 min (chat session KV)"),
                        (HOUR, "1 h   (long doc session)"),
                        (DAY, "1 day (weights, daily redeploy)")]:
        op = plan_write(MRM_RRAM, life)
        print(f"  {label:<28} retention={op.retention_s/3600:7.2f} h  "
              f"energy={op.energy_pj_bit:5.2f} pJ/bit  "
              f"endurance={op.endurance_at_point:.1e}")

    print("\nCluster control plane over one simulated hour:")
    ms = MemorySystem({"mrm": (MRM_RRAM, 8 << 30)})
    weights = ms.write_region("mrm", "weights", 4e9, expected_lifetime_s=DAY)
    sessions = [ms.write_region("mrm", f"session:{i}", 64e6,
                                expected_lifetime_s=600) for i in range(4)]
    for minute in range(60):
        ms.advance(60.0)
        for rid in sessions:
            ms.read_region(rid)          # active sessions keep reading
        ms.read_region(weights)
        if minute == 20:                  # two sessions end at t=20min
            for rid in sessions[:2]:
                ms.release_region(rid)
            sessions = sessions[2:]
            print("  t=20min: released 2 sessions (soft state dropped, no refresh)")
    rep = ms.report()
    print(f"  refreshes: {rep['refresh_stats']['refresh']} "
          f"({rep['refresh_stats']['refresh_bytes']/1e6:.0f} MB rewritten)")
    print(f"  drops/migrates: {rep['refresh_stats']['drop']}/"
          f"{rep['refresh_stats']['migrate']}")
    print(f"  MRM energy: {rep['total_energy_j']:.2f} J over {rep['now_s']/60:.0f} min")
    return rep


if __name__ == "__main__":
    main()
