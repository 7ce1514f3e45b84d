"""Tiny cells for the CPU tests: the port's ``reduced`` configurations
with configuration dicts of the same sizes under the published keys the
references read, and traffic of the cells' shape at a few tokens."""
from __future__ import annotations

import copy
import json

from bench import harness

ROOT = harness.ROOT


def mamba2_keys(cfg) -> dict:
    return {"d_model": cfg.d_model, "n_layer": cfg.num_layers, "vocab_size": cfg.vocab_size,
            "d_state": cfg.ssm_state, "d_conv": cfg.ssm_conv, "expand": cfg.ssm_expand,
            "headdim": cfg.ssm_headdim, "ngroups": cfg.ssm_ngroups,
            "norm_epsilon": cfg.norm_eps}


TRAFFIC = {
    "chat": {"loop": "closed", "clients": 3, "max_cache_len": 128, "block": 8,
             "prompt": {"lognormal": {"median": 24, "sigma": 0.7}, "clip": [8, 60]},
             "output": {"lognormal": {"median": 6, "sigma": 0.7}, "clip": [3, 12]}},
}
PAGE = {"chat": (16, 16)}     # (page_tokens, chunk_tokens)


# a cell's configuration file and traffic mix under ``bench/``, whether or
# not BENCHMARK.json runs the cell
CELLS = {"mamba2.chat": ("mamba2-2.7b", "chat")}


def cell(name: str, limit: float = 1.0):
    """(Cell, port config) of the cell ``name`` at a tiny size, with every
    metric of BENCHMARK.json."""
    from repro_torch.configs import get_config, reduced
    config, kind = CELLS[name]
    conf = json.loads((ROOT / "bench" / "configs" / f"{config}.json").read_text())
    cfg = reduced(get_config(conf["arch"]))
    conf.update(mamba2_keys(cfg))
    conf["page_tokens"], conf["chunk_tokens"] = PAGE[kind]
    conf["check"] = {"served_tokens": 12, "slots": 2, "max_logit_gap": limit}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    tiny = harness.Cell(name=name, workload={"name": name, "config": config,
                                             "traffic": kind, "chips": 1},
                        config=conf, traffic=copy.deepcopy(TRAFFIC[kind]),
                        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                        chips=1)
    return tiny, cfg
