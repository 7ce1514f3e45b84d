"""MRM memory plane and KV manager time a step, ms, from the program's own
spans: the ``memplane.*`` and ``kv.*`` spans of the window (the step's
metering snapshot, weight passes, paged-read metering, step latency, KV
page accounting and cold-leaf decay; none inside another), summed, over
the window's ``engine.step`` spans. None where the run holds no program
spans (``bench/program.py`` puts them there)."""


def read(run):
    prog = getattr(run, "program", None)
    if not prog or not prog["spans"]:
        return None
    spans = prog["spans"]
    plane = ("memplane.", "kv.")
    names = {p.id: p.name for p in spans}
    total = sum(p.end - p.start for p in spans if p.name.startswith(plane)
                and not names.get(p.parent, "").startswith(plane))
    steps = sum(1 for p in spans if p.name == "engine.step")
    return total / 1e6 / steps if steps else None
