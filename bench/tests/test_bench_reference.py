"""Both plain references against the port (``repro_torch``) at reduced
size on the CPU: the forward of one sequence, and every token a short
served run of each cell produced, with the port in fp32 (where the served
tokens are the reference's own choices)."""
import dataclasses
import time

import pytest
import torch

from bench import harness, weights
from bench.tests import tiny

CELLS = ["mamba2.chat"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fp32(name):
    cell, cfg = tiny.cell(name, limit=1e-3)
    return cell, dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


@pytest.mark.parametrize("name", CELLS)
def test_reference_forward_matches_the_port(name):
    from repro_torch.models import transformer as tfm
    cell, cfg = _fp32(name)
    params = weights.draw(tfm.model_defs(cfg), 5, "cpu", "float32")
    T = 96
    toks = torch.randint(2, cfg.vocab_size, (1, T), generator=torch.Generator().manual_seed(1))
    x, _ = tfm._embed_inputs(cfg, params, {"tokens": toks})
    x, _ = tfm.train_groups(cfg, params, x, positions=torch.arange(T))
    port = tfm._head(cfg, params, x[0]).float()
    w = weights.per_layer(params, [(len(g.unit), g.repeats) for g in cfg.scan_groups()])
    seq = {"tokens": toks[0].tolist(), "score_from": 0}
    ref = harness.reference(cell.config["reference"]).logits(cell.config, w, [seq])[0]
    assert (ref - port).abs().max().item() < 1e-4 * max(1.0, port.abs().max().item())


@pytest.mark.parametrize("name", CELLS)
def test_served_tokens_are_the_references_choices(name):
    cell, cfg = _fp32(name)
    _, check, _, seqs, _ = harness.run_cell(cell, 2 ** 31 + 3, 1.0, False, "cpu",
                                            time.perf_counter(), port_cfg=cfg,
                                            log=lambda *a: None)
    assert seqs and check["served_tokens"] >= 12
    assert check["max_logit_gap"] < 1e-3 and check["correct"]
