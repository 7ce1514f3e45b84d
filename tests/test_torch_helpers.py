"""Helpers shared by the port's tests (this module holds no tests):

- ``one_torch_thread``, an autouse fixture a test module imports: while
  the module runs, torch computes on one intra-op thread. The suite runs
  under ``pytest -n 6``, and torch's default of one thread per core then
  has six processes' threads spin against each other; the port's CPU
  tests compute on small tensors, where one thread is as fast alone;
- ``check_init_params_equal_reference``: the port's ``init_params(cfg,
  seed)`` against the reference's ``init_params(cfg,
  jax.random.key(seed))`` on a reduced config, leaf for leaf — paths,
  shapes, dtypes and bits."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config, reduced
from repro_torch.models import init_params
from repro_torch.models.param import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x):
    """Leaf values as integers: adjacent representable values differ by 1."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
        return x.view(torch.int32).numpy().astype(np.int64)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16).astype(np.int64)
    return x.view(np.int32).astype(np.int64)


def check_init_params_equal_reference(arch: str) -> None:
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
