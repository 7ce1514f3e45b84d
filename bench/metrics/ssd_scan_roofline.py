"""The SSD chunk-scan kernel's share of its roofline, %: sum over the
window's prefill chunks of each launch's bound (``bench/work.py``'s frozen
``ssd_work``: B 1, the chunk's tokens, every head, with the state page's
initial state; one launch a layer) over the device time of the kernels
named ``ssd_scan_mma_kernel`` (``torch.profiler``). Decode runs no scan."""
from bench import work
from bench.metrics._common import bound_s, roofline


def call_bound(c, kind, m):
    if kind != "prefill":
        return 0.0
    di = m["expand"] * m["d_model"]
    n_bytes, flops = work.ssd_work(1, c["tokens"], di // m["headdim"], m["headdim"],
                                   m["ngroups"], m["d_state"], 2, True)
    return m["n_layer"] * bound_s(n_bytes, flops)


def read(run):
    return roofline(run, "ssd_scan_mma_kernel", call_bound)
