"""Wall inside ``ComputeBackend.run_prefill_chunk`` per 1,000 prompt tokens
computed in the window, ms. The traced run, where this is read,
synchronises the card at the end of each chunk, so the span holds the
chunk's device work."""


def read(run):
    tokens = sum(c["tokens"] for c in run.prefill_calls)
    wall = sum(c["wall_s"] for c in run.prefill_calls)
    return wall * 1e3 / (tokens / 1e3) if tokens else None
