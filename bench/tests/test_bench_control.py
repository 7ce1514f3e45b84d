"""The control (the reference with fp8 e4m3 products, the precision below
the configuration's bf16), put in the program's place and judged by the
harness's own ``compare``, comes out not correct, at a size a test run
holds: on the CPU, over a tiny cell served in bf16, whose limit lies
between the program's readings and the control's."""
import pytest
import torch

from bench import control
from bench.tests import tiny

TINY_LIMIT = 0.07   # program 0-0.036, control 0.121-0.550 over seeds 11-16


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_is_not_correct(seed):
    cell, cfg = tiny.cell("mamba2.chat", limit=TINY_LIMIT)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = control.readings(cell, seed, 0.8, "cpu", cfg)
    finally:
        torch.set_num_threads(threads)
    assert r["served_tokens"] > 0 and r["control_gap"] > r["program_gap"], r
    assert r["correct"] and not r["control_correct"], r
