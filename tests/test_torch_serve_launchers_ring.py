"""Both serve launchers with ``--paged-kernel off`` on the stacks the ring
path newly serves (mamba2-2.7b, hymba-1.5b, deepseek-v2-lite-16b): the
port's launcher on the CPU prints the JAX launcher's report, and with the
reduced configs forced to float32 on both sides both decode the same
tokens, with prefix hits seeded from ring snapshots (point snapshots for
the SSM and hybrid stacks)."""
import pytest

from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from test_torch_serve_launchers import _run_launchers

KIND = {"mamba2-2.7b": "point", "hymba-1.5b": "point",
        "deepseek-v2-lite-16b": "positional"}


@pytest.mark.parametrize("arch", sorted(KIND))
def test_ring_launchers_agree_in_float32(monkeypatch, arch):
    reports, tokens = _run_launchers(
        monkeypatch, ["--arch", arch, "--paged-kernel", "off", "--requests", "4",
                      "--max-new", "4", "--shared-prefix-tokens", "32"], float32=True)
    rep = reports["torch"]
    assert rep == reports["jax"]
    assert tokens["torch"] == tokens["jax"]
    assert rep["finished"] == 4 and rep["tokens_generated"] == 16
    assert rep["prefix"]["snapshot_kind"] == KIND[arch]
    assert rep["prefix"]["compute_hits"] >= 1 and rep["seed_copy_bytes"] > 0
    assert rep["prefix"]["snapshots_published"] >= 1 and rep["kernel_read_bytes"] == 0
