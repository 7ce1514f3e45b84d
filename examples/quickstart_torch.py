"""Quickstart on the PyTorch port: the MRM memory class in 60 seconds
(``examples/quickstart.py``'s five steps, through ``repro_torch``).

1. Pick an architecture and look at its inference memory-IO profile.
2. Solve the retention-aware placement across HBM / MRM / LPDDR tiers.
3. Program one DCM write and watch the retention/energy/endurance trade.
4. Serve a few real requests through the full stack on the card: radix
   prefix reuse cuts the second identical prompt's prefill in both planes
   (DESIGN.md §6, §8).
5. Age a KV page past its retention deadline and watch the reliability
   plane correct it (DESIGN.md §11).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(the model computes on ``cuda`` by default, which raises without a card;
``--device cpu`` runs the kernels' plain versions)
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config, reduced
from repro_torch.core.dcm import plan_write
from repro_torch.core.memclass import HBM3E, HOUR, LPDDR5X, MRM_RRAM
from repro_torch.core.simulator import MemorySystem
from repro_torch.core.tiering import DataClassProfile, Tier, solve_placement

ARCH = "qwen3-8b"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(ARCH)
    counts = cfg.param_counts()
    kv_tok = cfg.kv_bytes_per_token()
    print(f"== {ARCH}: {counts['total']/1e9:.1f}B params, "
          f"{kv_tok/1024:.1f} KiB of KV appended per generated token")

    # --- 1. workload profile (decode reads everything, writes one vector) ---
    decode_tps = 800.0
    weights_bytes = counts["total"] * 2
    classes = [
        DataClassProfile("weights", weights_bytes, decode_tps * weights_bytes / 32,
                         weights_bytes / (24 * HOUR), 24 * HOUR, soft_state=False),
        DataClassProfile("kv_cache", 64e9, decode_tps * 64e9 / 32,
                         decode_tps * kv_tok * 8, 600, soft_state=True),
        DataClassProfile("activations", 4e9, 0.3e12, 0.3e12, 0.01,
                         soft_state=True, random_access=True),
    ]
    print(f"   decode read:write ratio ~ "
          f"{(weights_bytes + 64e9) / (kv_tok * 32):,.0f}:1  (paper §2.2: >1000:1)")

    # --- 2. retention-aware placement ---------------------------------------
    tiers = [Tier(HBM3E, 96e9, count=4), Tier(MRM_RRAM, 512e9, count=8),
             Tier(LPDDR5X, 256e9, count=2)]
    res = solve_placement(classes, tiers)
    print("== placement:", res.assignment)
    print(f"   feasible={res.feasible}  memory power={res.energy_w:.0f} W  "
          f"capacity cost=${res.cost_usd:,.0f}")

    # --- 3. DCM: program a write for a 10-minute KV page --------------------
    op = plan_write(MRM_RRAM, expected_lifetime_s=600)
    nominal = plan_write(MRM_RRAM, expected_lifetime_s=MRM_RRAM.retention_s)
    print(f"== DCM write @10min lifetime: retention={op.retention_s/3600:.2f} h, "
          f"energy {op.energy_pj_bit:.2f} pJ/bit (nominal {nominal.energy_pj_bit:.2f}), "
          f"endurance {op.endurance_at_point:.1e} (device nominal "
          f"{MRM_RRAM.endurance_device:.1e})")

    # --- 4. serve through the full stack: prefix reuse is real ---------------
    import numpy as np

    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServeEngine

    device = resolve_device(args.device)
    small = reduced(cfg)                     # compute scale
    params = init_params(small, 0, device=device)
    mem = MemorySystem({"mrm": (MRM_RRAM, 64 << 30), "hbm": (HBM3E, 16 << 30)})
    engine = ServeEngine(
        small, params, mem,
        EngineConfig(max_slots=2, max_cache_len=96, weight_tier="hbm",
                     kv_tier="mrm", page_tokens=16, chunk_tokens=16,
                     eos_token=-1, kv_pressure_policy="evict-lru"),
        account_cfg=cfg, device=device)      # accounting scale (deployment)
    rng = np.random.default_rng(0)
    prompt = list(rng.integers(2, small.vocab_size, 40))
    for _ in range(2):                       # identical prompts: the 2nd hits
        engine.submit(list(prompt), max_new_tokens=8)
        engine.run_until_idle()
    rep = engine.report()
    print(f"== served 2x the same 40-token prompt: "
          f"prefix hits {rep['prefix_hits']}, "
          f"prefill tokens skipped {rep['prefill_tokens_skipped']}, "
          f"KV tokens reused {rep['prefix_tokens_reused']}")
    assert rep["prefix_hits"] >= 1
    assert rep["prefill_tokens_skipped"] > 0

    # --- 5. reliability plane: age a page, scrub it back (DESIGN.md §11) ----
    mem_r = MemorySystem({"mrm": (MRM_RRAM, 64 << 30)}, ecc_profile="domain")
    rid = mem_r.write_region("mrm", "kv:demo", 1 << 20, expected_lifetime_s=600)
    region = mem_r.region(rid)
    dev = mem_r.devices["mrm"]
    print(f"== ECC (domain profile): a 1 MiB KV page at 10-min retention "
          f"carries {dev.stats.ecc_write_bytes:,.0f} check-bit bytes "
          f"({dev.ecc.overhead_for('kv', region.retention_s):.2%} overhead)")
    mem_r.advance(0.8 * region.retention_s / mem_r.tracker.margin)  # near deadline
    scrubbed = mem_r.scrub_region(rid)
    print(f"== scrub-on-read near the deadline: corrected in place, metered as "
          f"refresh ({dev.stats.refresh_bytes:,.0f} B) + scrub reads "
          f"({dev.stats.scrub_read_bytes:,.0f} B incl. check bits), wear "
          f"{dev.wear.scrub_rewrites} block rewrites; retention clock re-armed "
          f"(next deadline {region.written_at + region.retention_s:.0f}s)")
    assert scrubbed
    assert dev.stats.ecc_write_bytes > 0 and dev.stats.scrub_read_bytes > 0
    assert region.written_at == mem_r.now  # the scrub re-armed the clock
    return rep


if __name__ == "__main__":
    main()
