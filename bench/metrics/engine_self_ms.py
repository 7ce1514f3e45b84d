"""Engine self time a step, ms, from the program's own spans
(``repro_torch.runtime.tracing``): the mean over the window's
``engine.step`` spans of each one's wall less the time covered by its
``backend.*`` descendants and by the harness's wrappers around them (which
in the traced run hold a sync after each prefill chunk). The in-program
counterpart of ``engine_host_ms``. None where the run holds no program spans
(``bench/program.py`` puts them there)."""
from bench import program


def read(run):
    prog = getattr(run, "program", None)
    if not prog or not prog["spans"]:
        return None
    wrappers = [(s, e) for n, s, e in prog["bench"]
                if n in ("bench.run_prefill_chunk", "bench.run_decode")]
    ms = program.self_ms(prog["spans"], "engine.step", ("backend.",), wrappers)
    return sum(ms) / len(ms) if ms else None
