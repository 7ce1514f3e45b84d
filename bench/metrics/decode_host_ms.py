"""Host time a decode call spends enqueuing, ms, from the program's own
spans: the mean over the window's ``backend.decode`` spans of each one's
wall less its ``backend.sample_sync`` (the sampled tokens' copy to the
host, which waits for the device). None where the run holds no program
spans (``bench/program.py`` puts them there)."""
from bench import program


def read(run):
    prog = getattr(run, "program", None)
    if not prog or not prog["spans"]:
        return None
    ms = program.self_ms(prog["spans"], "backend.decode", ("backend.sample_sync",))
    return sum(ms) / len(ms) if ms else None
