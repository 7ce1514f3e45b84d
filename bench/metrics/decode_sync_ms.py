"""Time a decode call is blocked on the device, ms, from the program's own
spans: the mean over the window's ``backend.decode`` spans of their
``backend.sample_sync`` (argmax and the ``.cpu()`` that waits for every
kernel the call launched). None where the run holds no program spans
(``bench/program.py`` puts them there)."""


def read(run):
    prog = getattr(run, "program", None)
    if not prog or not prog["spans"]:
        return None
    spans = prog["spans"]
    calls = {p.id: 0 for p in spans if p.name == "backend.decode"}
    for p in spans:
        if p.name == "backend.sample_sync" and p.parent in calls:
            calls[p.parent] += p.end - p.start
    return sum(calls.values()) / 1e6 / len(calls) if calls else None
