"""The port stands alone: no file under src/repro_torch/, not chip_smoke.py
and not the port's legs beside the reference's (``examples/*_torch.py``,
``experiments/*_torch.py``) imports jax or the JAX package ``repro`` (as
opposed to ``repro_torch``) — not even a module of it that never imports
JAX."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
LEGS = sorted((ROOT / "examples").glob("*_torch.py")) + sorted(
    (ROOT / "experiments").glob("*_torch.py"))
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + LEGS


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    assert path.exists()
    bad = {m for m in _imported_roots(path) if m in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_covers_the_package():
    assert len(FILES) > 20


def test_scan_covers_the_legs():
    """The four example legs and the two fleet legs."""
    assert [p.name for p in LEGS] == [
        "dcm_retention_demo_torch.py", "quickstart_torch.py", "serve_batched_mrm_torch.py",
        "train_tiny_lm_torch.py", "run_fleet_torch.py", "scenarios_torch.py"]
