"""Both serve launchers with the fleet and fault-injection flags, on the
port's CPU path against the JAX package's, reduced configs forced to
float32 on both sides (as in ``test_torch_serve_launchers.py``):

- ``--replicas 2 --migrate-prefixes --shared-prefix-tokens 32`` under
  ``--clock lockstep`` and ``--clock event``: the same fleet report and
  every replica's tokens, the directory holding the shared head (the
  launcher's default migration gap of 4 never fires at 6 requests; forced
  migrations are ``test_torch_cluster.py``'s);
- ``--inject-rber 1e-3 --ecc-profile domain``: the same report (its
  ``reliability.injection`` counters included) and tokens.

Exact equality: reports and tokens.
"""
import contextlib
import functools
import io

import pytest
import torch

import repro.configs
import repro.launch.serve as jax_serve
import repro_torch.configs
import repro_torch.launch.serve as torch_serve
from repro_torch.models import init_params
from repro_torch.models.param import tree_leaves
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)


def _run_launchers(monkeypatch, argv):
    """Both launchers' ``main`` at the same flags in float32 (the port on
    the CPU): their reports and every engine's decoded tokens."""
    engines = {"jax": [], "torch": []}
    for name, mod in (("jax", jax_serve), ("torch", torch_serve)):
        def build(*a, _orig=mod.build_engine, _name=name, **kw):
            engines[_name].append(_orig(*a, **kw))
            return engines[_name][-1]
        monkeypatch.setattr(mod, "build_engine", build)
    for mod in (repro.configs, repro_torch.configs):
        monkeypatch.setattr(mod, "reduced", functools.partial(
            mod.reduced, dtype="float32", param_dtype="float32"))
    with contextlib.redirect_stdout(io.StringIO()):
        reports = {"jax": jax_serve.main(list(argv)),
                   "torch": torch_serve.main([*argv, "--device", "cpu"])}
    tokens = {n: [{k: [int(x) for x in v] for k, v in e.outputs.items()} for e in es]
              for n, es in engines.items()}
    return reports, tokens, engines


@pytest.mark.parametrize("clock", ["lockstep", "event"])
def test_fleet_launchers_agree(monkeypatch, clock):
    reports, tokens, engines = _run_launchers(
        monkeypatch, ["--replicas", "2", "--migrate-prefixes", "--clock", clock,
                      "--shared-prefix-tokens", "32", "--requests", "6",
                      "--max-new", "6"])
    assert reports["torch"] == reports["jax"]
    assert tokens["torch"] == tokens["jax"]
    assert len(engines["torch"]) == 2
    # one weight draw: both replicas compute on the same tensors, which
    # serving left as drawn
    params = engines["torch"][0].params
    assert engines["torch"][1].params is params
    fresh = init_params(engines["torch"][0].cfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(fresh)))
    rep = reports["torch"]
    assert rep["replicas"] == 2 and rep["clock_mode"] == clock
    assert rep["finished"] == 6 and rep["tokens_generated"] == 36
    assert rep["directory"]["entries"] > 0 and rep["prefix_hits"] >= 1


def test_inject_rber_launchers_agree(monkeypatch):
    reports, tokens, _ = _run_launchers(
        monkeypatch, ["--inject-rber", "1e-3", "--ecc-profile", "domain",
                      "--requests", "4", "--max-new", "6",
                      "--shared-prefix-tokens", "32"])
    assert reports["torch"] == reports["jax"]
    assert tokens["torch"] == tokens["jax"]
    rel = reports["torch"]["reliability"]
    assert rel["ecc_profile"] == "domain" and rel["inject_rber"] == 1e-3
    assert rel["injection"]["pages_visited"] > 0
