"""The port's copy of JAX's generator (``repro_torch.models.jax_random``)
against ``jax.random``, and the draws it feeds: ``init_params`` against the
reference's ``init_params(cfg, jax.random.key(seed))`` leaf for leaf, and
both serve launchers at the same flags.

- ``split``, the random bits and ``uniform`` equal JAX's bit for bit;
- ``normal`` = sqrt(2) erf_inv(u) and the float32 log, log1p and expm1
  that the copy computes as XLA's CPU backend does equal JAX's bit for bit;
- ``init_params`` leaves have the reference's paths, shapes, dtypes and
  bits;
- ``repro_torch.launch.serve`` and ``repro.launch.serve`` at default flags
  print the same memory-plane report, and in float32 (reduced configs
  forced to float32 on both sides) also decode the same tokens. In bf16
  their tokens part once (ROADMAP §C.4), which a strict xfail records.
"""
import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs
import repro.launch.serve as jax_serve
import repro_torch.configs
import repro_torch.launch.serve as torch_serve
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config, reduced
from repro_torch.models import init_params, jax_random
from repro_torch.models.param import tree_leaves

SEEDS = (0, 1, 42, 2 ** 31 - 1)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place of float32 (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_bits_uniform_equal_jax(seed):
    key = jax.random.key(seed)
    k = jax_random.key(seed)
    assert tuple(np.asarray(jax.random.key_data(key)).tolist()) == k
    want = np.asarray(jax.random.key_data(jax.random.split(key, 7))).tolist()
    assert [list(x) for x in jax_random.split(k, 7)] == want
    for shape in ((1,), (3, 5, 7), (1000,)):
        bits = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64).ravel()
        assert np.array_equal(jax_random.random_bits(k, bits.size).numpy(), bits)
    for lo, hi in ((0.0, 1.0), (1.0, 16.0), (1e-3, 1e-1)):
        for shape in ((1,), (7, 37), (2, 3, 11)):
            u = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi))
            got = jax_random.uniform(k, shape, lo, hi).numpy()
            assert got.shape == u.shape and np.array_equal(got, u), (lo, hi, shape)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_within_ulps_of_jax(seed):
    """Bit for bit over 200,000 draws, far tails (erf_inv's w >= 5
    branch, through the copy's correctly rounded square root) included."""
    n = 200_000
    want = np.asarray(jax.random.normal(jax.random.key(seed), (n,), jnp.float32))
    got = jax_random.normal(jax_random.key(seed), (n,)).numpy()
    d = _ulps(want, got)
    assert d.max() == 0, ((d > 0).sum(), d.max())


@pytest.mark.parametrize("name,lo,hi", [
    ("log", 1.0, 16.0), ("log", 1e-30, 1e30), ("log1p", -1.0, 0.0),
    ("expm1", 1e-3, 1e-1), ("expm1", -3.0, 3.0)])
def test_float32_functions_equal_xla(name, lo, hi):
    """The copies of XLA's float32 log, log1p and expm1 (plain arithmetic,
    device-independent) give jnp's bits on 100,000 arguments."""
    x = np.asarray(jax.random.uniform(jax.random.key(9), (100_000,), jnp.float32, lo, hi))
    x = x[x > -1.0]                       # log1p(-1) = -inf: not in the domain
    want = np.asarray(jax.jit(getattr(jnp, name))(x))
    fn = {"log": jax_random.log_f32, "log1p": jax_random._log1p_f32,
          "expm1": jax_random.expm1_f32}[name]
    got = fn(torch.from_numpy(x.copy())).numpy()
    assert np.array_equal(got, want), int((got != want).sum())


def _bits(x):
    """Leaf values as integers: adjacent representable values differ by 1."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
        return x.view(torch.int32).numpy().astype(np.int64)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16).astype(np.int64)
    return x.view(np.int32).astype(np.int64)


ARCHS = ("gemma-2b", "mamba2-2.7b", "qwen3-8b")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_equal_reference(arch):
    """Every leaf bit-equal, the SSM initialisers' float32 logs included."""
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    want = jax.tree_util.tree_flatten_with_path(jax_init_params(jcfg, jax.random.key(3)))[0]
    got = tree_leaves(init_params(cfg, 3, device="cpu"))
    assert len(got) == len(want)
    for (path, a), t in zip(want, got):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape and str(t.dtype) == f"torch.{a.dtype.name}", path
        assert np.array_equal(_bits(a), _bits(t)), jax.tree_util.keystr(path)


def _run_launchers(monkeypatch, argv, float32=False):
    """Both launchers' ``main`` at the same flags (the port on the CPU):
    their reports and every request's decoded tokens."""
    engines = {}
    for name, mod in (("jax", jax_serve), ("torch", torch_serve)):
        def build(*a, _orig=mod.build_engine, _name=name, **kw):
            engines[_name] = _orig(*a, **kw)
            return engines[_name]
        monkeypatch.setattr(mod, "build_engine", build)
    if float32:
        for mod in (repro.configs, repro_torch.configs):
            monkeypatch.setattr(mod, "reduced", functools.partial(
                mod.reduced, dtype="float32", param_dtype="float32"))
    with contextlib.redirect_stdout(io.StringIO()):
        reports = {"jax": jax_serve.main(list(argv)),
                   "torch": torch_serve.main([*argv, "--device", "cpu"])}
    tokens = {n: {k: [int(x) for x in v] for k, v in e.outputs.items()}
              for n, e in engines.items()}
    return reports, tokens


def test_serve_launchers_report_equal_at_default_flags(monkeypatch):
    reports, tokens = _run_launchers(monkeypatch, [])
    assert reports["torch"] == reports["jax"]
    assert reports["torch"]["finished"] == len(tokens["torch"]) > 0


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP §C.4: in bf16 the two launchers' tokens part once (request 6, "
    "token 11: the reference's top two logits are one bf16 ulp apart); the "
    "reference run op by op parts from its jitted run on 14 of 128 tokens"))
def test_serve_launchers_tokens_equal_at_default_flags(monkeypatch):
    reports, tokens = _run_launchers(monkeypatch, [])
    assert tokens["torch"] == tokens["jax"]


def test_serve_launchers_agree_in_float32(monkeypatch):
    reports, tokens = _run_launchers(monkeypatch, [], float32=True)
    assert reports["torch"] == reports["jax"]
    assert tokens["torch"] == tokens["jax"]
    assert sum(map(len, tokens["torch"].values())) == reports["jax"]["tokens_generated"] > 0
