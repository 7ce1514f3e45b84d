"""Model FLOPs utilisation of the whole served step, %: the useful FLOPs
of every token the window computed (prompt tokens computed, not those a
prefix hit reused; one head a prefill chunk's last token and a decode
row), counted from the configuration's published shapes
(``bench/work.py``, the top-k routed and shared experts, not capacity
slots), over the window's seconds at the bf16 dense peak."""
from bench import peaks, work


def read(run):
    m = run.config
    fn = work.TOKEN_FLOPS[m["flops"]]
    f0, f1 = fn(m, 0), fn(m, 1)
    fixed, per_key, head = f0["layers"], f1["layers"] - f0["layers"], f0["head"]
    total = 0.0
    for c in run.prefill_calls:
        n, off = c["tokens"], c["offset"]
        total += n * fixed + per_key * (n * off + n * (n + 1) // 2) + head
    for c in run.decode_calls:
        for kv in c["kv_lens"]:
            if kv:
                total += fixed + per_key * kv + head
    return 100.0 * total / (run.window_s * peaks.PEAK_FLOPS_BF16)
