"""Engine host time a step, ms: the mean over the window's steps of the
wall of ``ServeEngine.step`` less the wall inside the compute backend's
``run_prefill_chunk`` and ``run_decode`` (scheduler, memory plane, radix
tree, page tables, metering)."""
from bench.metrics._common import mean_ms


def read(run):
    return mean_ms([wall - backend for wall, backend, _ in run.steps])
