"""The port's copy of JAX's generator (``repro_torch.models.jax_random``)
against ``jax.random``:

- ``split``, the random bits and ``uniform`` equal JAX's bit for bit;
- ``normal`` = sqrt(2) erf_inv(u) and the float32 log, log1p and expm1
  that the copy computes as XLA's CPU backend does equal JAX's bit for bit.

The draws it feeds are held in ``test_torch_init_params_*.py``
(``init_params`` leaf for leaf) and ``test_torch_serve_launchers.py``
(both serve launchers at the same flags).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import jax_random
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

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
