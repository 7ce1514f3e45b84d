"""Mean wall of a ``ComputeBackend.run_decode`` call in the window, ms;
each call ends with the sampled tokens copied to the host."""
from bench.metrics._common import mean_ms


def read(run):
    return mean_ms([c["wall_s"] for c in run.decode_calls])
