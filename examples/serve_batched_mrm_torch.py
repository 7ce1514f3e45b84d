"""Serve a small model with batched requests on the PyTorch port, weights
and paged KV cache living on MRM: ``examples/serve_batched_mrm.py``
through ``repro_torch``, the model computing on the card.

- continuous batching over fixed decode slots (real token generation);
- chunked prefill: prompts enter in 32-token pieces interleaved with
  decode rounds;
- weights written once to the MRM weight region, read wholesale per pass;
- KV pages allocated with DCM retention programmed from session lifetime,
  capacity pressure resolved by prefix-LRU eviction (never silent drops);
- radix prefix reuse: the requests share a 32-token head, so later
  admissions attach the shared pages AND skip their prefill compute
  (DESIGN.md §6, §8);
- the report shows the measured read:write ratio, sequentiality, energy.

The reduced gemma2-27b computes; the memory plane meters the full one.

Run:  PYTHONPATH=src python examples/serve_batched_mrm_torch.py [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core.memclass import HBM3E, MRM_RRAM
from repro_torch.core.simulator import MemorySystem
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import EngineConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    FULL = get_config("gemma2-27b")      # accounting scale (deployment)
    cfg = reduced(FULL)                  # compute scale
    params = init_params(cfg, 0, device=device)

    mem = MemorySystem({
        "mrm": (MRM_RRAM, 512 << 30),    # weights + KV pages
        "hbm": (HBM3E, 96 << 30),        # activations (write-heavy)
    })
    engine = ServeEngine(
        cfg, params, mem,
        EngineConfig(max_slots=4, max_cache_len=128, weight_tier="mrm",
                     kv_tier="mrm", page_tokens=16, expected_session_s=30.0,
                     eos_token=-1, chunk_tokens=32,
                     kv_pressure_policy="evict-lru"),
        account_cfg=FULL, device=device)

    rng = np.random.default_rng(0)
    print(f"serving {FULL.name}: weights {engine.weight_bytes/1e9:.0f} GB -> MRM, "
          f"KV {FULL.kv_bytes_per_token()/1024:.0f} KiB/token, paged x16 tokens, "
          f"chunked prefill x32")
    shared_head = list(rng.integers(2, cfg.vocab_size, 32))  # system prompt
    for i in range(8):
        prompt = shared_head + list(
            rng.integers(2, cfg.vocab_size, int(rng.integers(8, 28))))
        engine.submit(prompt, max_new_tokens=16)

    rep = engine.run_until_idle()
    mrm = rep["memory"]["tiers"]["mrm"]
    print(f"\nfinished {rep['finished']} requests, {rep['tokens_generated']} tokens "
          f"({rep['prefill_chunks']} prefill chunks)")
    print(f"  steady read:write ratio  {rep['steady_rw_ratio']:,.0f}:1   (paper: >1000:1)")
    print(f"  sequential read fraction {mrm['seq_fraction']*100:.1f}%")
    print(f"  energy per token         {rep['energy_per_token_j']*1e3:.2f} mJ")
    print(f"  refresh events           {rep['memory']['refresh_stats']['refresh']}")
    print(f"  pressure events          {rep['pressure']['events']} "
          f"(silent drops {rep['dropped_allocs']})")
    print(f"  prefix hits              {rep['prefix_hits']} "
          f"({rep['prefix_tokens_reused']} KV tokens reused, "
          f"{rep['prefill_tokens_skipped']} prefill tokens skipped)")
    print(f"  MRM wear (max writes)    {mrm['wear_max']:.0f}  "
          f"(ratio {mrm['wear_ratio']:.2f}, life used {mrm['life_used']:.2e})")
    print(f"  ECC overhead             {mrm['ecc_overhead']*100:.2f}%")
    assert rep["steady_rw_ratio"] > 1000
    assert rep["dropped_allocs"] == 0
    assert rep["prefix_hits"] >= 1          # the shared head was actually reused
    return rep


if __name__ == "__main__":
    main()
