#!/usr/bin/env python3
"""How far a full-width model's last logits move under its own rounding,
on the ring and the paged serving steps of the PyTorch port, in float32.

    python3 scripts/ring_conditioning.py                     # hymba-1.5b, mamba2-2.7b
    python3 scripts/ring_conditioning.py deepseek-v2-lite-16b

For each arch named, at full width and depth in float32, random weights
from the serve seed, on the third of the serve launcher's prompts (a
shared 32-token head and its tail, behind any meta tokens), it takes the
last position's logits of the ring path's whole-prompt prefill on the card,
of the same with every weight scaled by 1 + 2^-22 (two ulps), of the
whole-prompt prefill and of the page-grid chunked run (first chunk to the
first page boundary past the meta tokens, then one extend a page) on the
ring and on the paged plane, each on the card and on the host's CPU (the
kernels' plain versions). It prints one JSON line of relative differences
(max |a - b| over max |b|): a model whose logits move O(1) under a two-ulp
weight nudge amplifies rounding, and its tokens part between any two
paths that sum in another order, whatever their code. Pages of 32, rings
of 256. Needs one card and a host that holds the model in float32.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PAGE, RING = 32, 256
ARCHS = ("hymba-1.5b", "mamba2-2.7b")


def main(archs) -> int:
    import torch
    if not torch.cuda.is_available():
        print("ring_conditioning: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch import configs as cfg_mod
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.launch import serve
    from repro_torch.models import param
    from repro_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all([ops.SOURCE, sops.SOURCE, fops.SOURCE])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    for arch in archs:
        cfg = dataclasses.replace(cfg_mod.get_config(arch), dtype="float32",
                                  param_dtype="float32")
        prompt = serve.make_prompts(cfg, 8, 32, serve.parser().parse_args([]).seed)[2]
        plen = cfg.n_meta_tokens
        S = plen + len(prompt)
        first = min(S, (plen // PAGE + 1) * PAGE)
        cuts = [first] + list(range(first + PAGE - first % PAGE, S, PAGE)) + [S]
        cuts = sorted(set(c for c in cuts if c <= S))

        def ring_whole(p, dev):
            t = torch.tensor([prompt], device=dev)
            return tfm.prefill(cfg, p, {"tokens": t}, max_cache_len=RING,
                               page_tokens=PAGE)[0][0].float().cpu()

        def chunked(p, dev, paged):
            t = torch.tensor([prompt], device=dev)
            W = -(-S // PAGE)
            if paged:
                caches = tfm.init_paged_caches(cfg, W + 1, PAGE, torch.float32, device=dev)
                tbl = torch.arange(1, W + 1, dtype=torch.int32, device=dev)[None]
                lg, caches = tfm.paged_prefill(cfg, p, {"tokens": t[:, :first - plen]},
                                               caches, tbl, page_tokens=PAGE)
            else:
                lg, caches = tfm.prefill(cfg, p, {"tokens": t[:, :first - plen]},
                                         max_cache_len=RING, page_tokens=PAGE)
            for a, b in zip(cuts, cuts[1:]):
                piece = t[:, a - plen:b - plen]
                if paged:
                    lg, caches = tfm.paged_extend(cfg, p, caches, piece, a, tbl,
                                                  page_tokens=PAGE)
                else:
                    lg, caches = tfm.extend(cfg, p, caches, piece, a, page_tokens=PAGE)
            return lg[0].float().cpu()

        def rel(a, b):
            return ((a - b).abs().max() / b.abs().max()).item()

        params = tfm.init_params(cfg, 0, device="cuda")
        on_cpu = param.tree_map(lambda a: a.cpu(), params)
        whole = ring_whole(params, "cuda")
        nudged = ring_whole(param.tree_map(lambda a: a * (1 + 2.0 ** -22), params), "cuda")
        runs = {(dev, name): fn(p, dev) for dev, p in (("cuda", params), ("cpu", on_cpu))
                for name, fn in (("ring_whole", ring_whole),
                                 ("ring_chunked", lambda p, d: chunked(p, d, False)),
                                 ("paged_chunked", lambda p, d: chunked(p, d, True)))}
        print(json.dumps({
            "arch": cfg.name, "layers": cfg.num_layers, "dtype": "float32",
            "positions": S, "chunk_ends": cuts, "nvidia_smi": smi,
            "ring_whole_vs_weights_nudged_2_ulps": rel(nudged, whole),
            "cuda_vs_cpu": {k: rel(runs["cuda", k], runs["cpu", k])
                            for k in ("ring_whole", "ring_chunked", "paged_chunked")},
            "ring_chunked_vs_whole": {d: rel(runs[d, "ring_chunked"], runs[d, "ring_whole"])
                                      for d in ("cuda", "cpu")},
            "paged_vs_ring_chunked": {d: rel(runs[d, "paged_chunked"], runs[d, "ring_chunked"])
                                      for d in ("cuda", "cpu")},
            "logit_absmax": whole.abs().max().item()}), flush=True)
        del params, on_cpu, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ARCHS))
