"""``examples/train_tiny_lm_torch.py`` (``--device cpu``) against
``examples/train_tiny_lm.py`` at 3 steps (and the legs' 23-step resume),
reduced deepseek-7b forced to float32 on both sides: both legs' own
asserts hold (the loss falls), and the first step's loss agrees within
1e-4. Later steps are not compared: at the reference's init fp32
gradients are ill-conditioned and two correct implementations part after
one AdamW step (ROADMAP §C notes). A file of its own: the reference leg
takes ~20 s of JAX compilation.
"""
import contextlib
import functools
import io
import pathlib
import re
import runpy
import sys

import repro.configs
import repro.launch.train as jax_train
import repro_torch.configs
import repro_torch.launch.train as torch_train
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _printed(path, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        runpy.run_path(str(path), run_name="__main__")
    return buf.getvalue()


def test_train_leg_first_loss_matches_the_reference(monkeypatch, tmp_path):
    for mod in (repro.configs, repro_torch.configs):
        monkeypatch.setattr(mod, "reduced", functools.partial(
            mod.reduced, dtype="float32", param_dtype="float32"))
    histories = {}      # each launcher's histories, in call order
    for name, mod in (("jax", jax_train), ("torch", torch_train)):
        def main(argv, _orig=mod.main, _name=name):
            histories.setdefault(_name, []).append(_orig(argv))
            return histories[_name][-1]
        monkeypatch.setattr(mod, "main", main)
    ref = _printed(ROOT / "examples" / "train_tiny_lm.py",
                   ["--steps", "3", "--ckpt-dir", str(tmp_path / "jax")], monkeypatch)
    got = _printed(ROOT / "examples" / "train_tiny_lm_torch.py",
                   ["--steps", "3", "--ckpt-dir", str(tmp_path / "torch"), "--device", "cpu"],
                   monkeypatch)
    first = [histories[n][0][0]["loss"] for n in ("jax", "torch")]
    assert abs(first[1] - first[0]) <= 1e-4 * abs(first[0])
    assert [h[0]["step"] for h in histories["torch"]] == [0, 0]   # the train, then the resume
    for out in (ref, got):
        assert re.search(r"^loss: \S+ -> \S+ over 3 steps$", out, re.M)
        assert "-- resuming from the checkpoint for 20 more steps --" in out
        assert '"steps": 23' in out
