"""The port's legs outside the package against the reference's, on the CPU:

- ``repro_torch.core.trajectory.persist_trajectory`` against
  ``repro.core.trajectory``'s on the same entries in ``tmp_path``: the
  same files, the same dedupe decisions (wall-clock ``at`` aside);
- ``experiments/run_fleet_torch.run_scenario`` against
  ``experiments/run_fleet.run_scenario`` on every ``smoke`` scenario:
  equal reports and trace digests, the wall-clock fields left out; its
  ``main`` writes ``BENCH_fleet_torch.json`` through the port's writer;
- ``examples/dcm_retention_demo_torch.py`` and
  ``examples/quickstart_torch.py`` (``--device cpu``) print what the
  reference legs print, every number included.
The serving and training example legs have files of their own
(``test_torch_legs_serve.py``, ``test_torch_legs_train.py``): each
reference leg takes ~20 s of JAX compilation.
"""
import contextlib
import importlib.util
import io
import json
import pathlib
import runpy
import sys

import pytest

import repro.core.trajectory as jax_trajectory
import repro_torch.core.trajectory as torch_trajectory

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from experiments import run_fleet, run_fleet_torch  # noqa: E402
from experiments.scenarios import SCENARIOS  # noqa: E402

WALL = ("wall_s", "events_per_s")


def test_trajectory_equals_reference(tmp_path):
    entries = [{"arch": "a", "x": 1.0, "wall_s": 3.0},
               {"arch": "a", "x": 1.0, "wall_s": 4.0},     # dup of the last "a"
               {"arch": "b", "x": 2},
               {"arch": "a", "x": 1.5},
               {"arch": "b", "x": 2},                      # dup of the last "b"
               {"arch": "a", "x": 1.0, "nested": {"k": [1, 2]}}]
    got = {}
    for name, mod in (("jax", jax_trajectory), ("torch", torch_trajectory)):
        root = tmp_path / name
        root.mkdir()
        got[name] = [mod.persist_trajectory("T.json", e, root=str(root),
                                            ignore=("at", "wall_s")) for e in entries]
        got[name + "_file"] = [{k: v for k, v in e.items() if k != "at"}
                               for e in json.loads((root / "T.json").read_text())["entries"]]
    assert got["torch"] == got["jax"] == [True, False, True, True, False, True]
    assert got["torch_file"] == got["jax_file"]


def test_trajectory_root_is_the_repo():
    """The default root counts four levels up, the same depth in both
    packages: the repository's root."""
    spec = importlib.util.find_spec("repro_torch.core.trajectory")
    assert pathlib.Path(spec.origin).resolve().parents[3] == ROOT


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_scenario_equals_reference(name):
    ref = run_fleet.run_scenario(name, "smoke")
    got = run_fleet_torch.run_scenario(name, "smoke")
    assert got["trace"]["digest"] == ref["trace"]["digest"]
    strip = lambda e: {k: v for k, v in e.items() if k not in WALL}  # noqa: E731
    assert strip(got) == strip(ref)
    run_fleet_torch.gate(got)


def test_run_fleet_main_writes_its_own_trajectory(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(run_fleet_torch, "persist_trajectory",
                        lambda fn, entry, **kw: calls.append((fn, entry["scenario"])))
    out = tmp_path / "fleet.json"
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert run_fleet_torch.main(["--scenario", "long_doc", "--json", str(out)]) == 0
    assert calls == [("BENCH_fleet_torch.json", "long_doc/smoke")]
    assert json.loads(out.read_text())["entries"][0]["scenario"] == "long_doc/smoke"
    assert "long_doc/smoke:" in buf.getvalue()
    assert run_fleet_torch.persist_trajectory is not run_fleet.persist_trajectory


def _printed(path, argv, monkeypatch):
    """What a leg prints, run as ``python <path> <argv>`` in this process."""
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        runpy.run_path(str(path), run_name="__main__")
    return buf.getvalue()


@pytest.mark.parametrize("leg,argv", [("dcm_retention_demo", []),
                                      ("quickstart", ["--device", "cpu"])])
def test_example_leg_prints_the_reference(leg, argv, monkeypatch):
    ref = _printed(ROOT / "examples" / f"{leg}.py", [], monkeypatch)
    got = _printed(ROOT / "examples" / f"{leg}_torch.py", argv, monkeypatch)
    assert got == ref
    assert any(ch.isdigit() for ch in got)
