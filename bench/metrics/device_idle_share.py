"""Share of the traced window in which the card ran nothing, %: 1 - the
union of the device activities' intervals (``bench/trace.py``) over the
window."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.window_s)
