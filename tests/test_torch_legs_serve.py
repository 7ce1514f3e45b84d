"""``examples/serve_batched_mrm_torch.py`` (``--device cpu``: reduced
gemma2-27b computing, the full config metered) against
``examples/serve_batched_mrm.py``: the same printed report, every number
included, and the leg's own asserts hold (read:write ratio above 1000, no
silent drops, the shared head reused). A file of its own: the reference
leg takes ~20 s of JAX compilation.
"""
import contextlib
import io
import pathlib
import runpy
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _printed(path, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        runpy.run_path(str(path), run_name="__main__")
    return buf.getvalue()


def test_serve_batched_leg_prints_the_reference(monkeypatch):
    ref = _printed(ROOT / "examples" / "serve_batched_mrm.py", [], monkeypatch)
    got = _printed(ROOT / "examples" / "serve_batched_mrm_torch.py", ["--device", "cpu"],
                   monkeypatch)
    assert got == ref
    assert "finished 8 requests, 128 tokens" in got
