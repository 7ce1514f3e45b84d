"""The harness, its look for a card skipped, drives a whole run with the
timed path broken underneath (``bench/faults.py``), and ``correct`` comes
out false: a token altered where it is produced, a decode step that leaves
its state pages unchanged, and half of a decode batch left out. A sound
run of the same tiny cell (fp32, limit 1e-3) is correct, and its check
reads requests from both halves of the batch."""
import dataclasses
import time

import pytest
import torch

from bench import faults, harness
from bench.tests import tiny


def _run(name):
    cell, cfg = tiny.cell(name, limit=1e-3)
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    return harness.run_cell(cell, 2 ** 32 + 9, 0.8, False, "cpu", time.perf_counter(),
                            port_cfg=cfg, log=lambda *a: None)


@pytest.mark.parametrize("fault", [None, *faults.FAULTS])
def test_a_broken_timed_path_is_not_correct(fault):
    threads = torch.get_num_threads()
    patch = faults.Patch()
    torch.set_num_threads(1)
    try:
        if fault is not None:
            faults.FAULTS[fault](patch)
        _, check, _, seqs, _ = _run("mamba2.chat")
    finally:
        patch.undo()
        torch.set_num_threads(threads)
    assert check["correct"] is (fault is None), check
    slots = {s["slot"] for s in seqs}
    assert min(slots) < 1 <= max(slots)      # 3 slots: row 0 and rows 1-2


def test_a_patch_puts_everything_back():
    from repro_torch.models import ssm, transformer
    from repro_torch.serving.engine import ComputeBackend
    before = (ComputeBackend.sample, ssm._write_state_pages, transformer.paged_decode)
    patch = faults.Patch()
    for plant in faults.FAULTS.values():
        plant(patch)
    assert ssm._write_state_pages is not before[1]
    patch.undo()
    assert (ComputeBackend.sample, ssm._write_state_pages, transformer.paged_decode) == before


def test_the_sample_covers_every_part_of_the_batch():
    import types
    cell, _ = tiny.cell("mamba2.chat")
    cell.traffic["clients"] = 32
    cell.config["check"] = {"served_tokens": 2048, "slots": 8, "max_logit_gap": 1.0}
    done = [harness.Req(rid=i, client=i % 32, prompt=[1] * 10, max_new=100 + i,
                        submit_t=0.0, slot=i % 32) for i in range(96)]
    eng = types.SimpleNamespace(outputs={r.rid: list(range(r.max_new)) for r in done})
    seqs = harness.sample(cell, 2 ** 31 + 7, done, eng)
    assert seqs[0]["rid"] == 95                               # the longest first
    assert {s["slot"] // 4 for s in seqs} == set(range(8))    # every eighth of the slots
    assert sum(len(s["served"]) for s in seqs) >= 2048
    assert all(s["tokens"][10:] == s["served"][:-1] for s in seqs)
    assert seqs == harness.sample(cell, 2 ** 31 + 7, done, eng)
    assert seqs != harness.sample(cell, 2 ** 31 + 8, done, eng)
