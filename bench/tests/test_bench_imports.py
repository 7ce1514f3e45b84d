"""Nothing a benchmark run loads has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``repro`` (compared whole: ``repro_torch`` is the
program), and the plain references import nothing of the program."""
import ast
import pathlib
import subprocess
import sys

from bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
BENCH = harness.ROOT / "bench"


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_references_import_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert not _imports(path) & (FORBIDDEN | {"repro_torch"}), path


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        if "tests" not in path.parts:
            assert not _imports(path) & FORBIDDEN, path


RUN = r"""
import sys, time, json
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
from bench import harness
from bench.tests import tiny
for name in ("mamba2.chat",):
    cell, cfg = tiny.cell(name)
    run, check, dev, seqs, params = harness.run_cell(cell, 5, 0.5, True, "cpu",
                                                     time.perf_counter(), port_cfg=cfg,
                                                     log=lambda *a: None)
    for m in cell.end_to_end + cell.per_layer:
        harness.metric_reader(m["name"]).read(run)
run_py = harness.load_module(harness.ROOT / "bench" / "run.py", "bench_cli")
print(json.dumps(run_py.forbidden_modules()))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = RUN.format(root=str(harness.ROOT), src=str(harness.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_whole_name_is_compared():
    run_py = harness.load_module(BENCH / "run.py", "bench_cli")
    sys.modules["repro_torch_probe_module"] = sys
    try:
        assert "repro_torch_probe_module" not in run_py.forbidden_modules()
    finally:
        del sys.modules["repro_torch_probe_module"]
