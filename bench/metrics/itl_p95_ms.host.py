"""95th percentile of the gap between consecutive output tokens of a
request, ms, over every gap that ended in the window (returns of the
steps that emitted them). A tail the host paces, read in the traced
run."""
from bench.metrics._common import p95_ms


def read(run):
    return p95_ms(run.itl_s)
