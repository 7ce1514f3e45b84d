"""Device activities (kernels, copies, memsets) launched inside one
``backend.decode`` span, the mean over the window's decode calls: each
activity in the trace of the card is paired with the CUDA runtime call that
launched it by correlation id, and put down to the program span open at
that call (``bench/program.py``'s ``attribute``; where the card yields no
runtime records, the activity's device start). A count: it repeats exactly
for one program. None untraced, without device activity, or where the
run holds no program spans (``bench/program.py`` puts them there)."""


def read(run):
    if run.trace is None or "program" not in run.trace:
        return None
    if run.trace["program"]["launch_clock"] == "none":     # no device activity
        return None
    counts = run.trace["program"]["decode_launches"]
    return sum(counts) / len(counts) if counts else None
