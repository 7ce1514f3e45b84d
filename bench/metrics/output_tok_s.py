"""Output tokens/s: every output token the window's steps emitted, over
the window's seconds (host clock; the window ends at the first step
boundary after ``--seconds``)."""


def read(run):
    return run.tokens_out / run.window_s
