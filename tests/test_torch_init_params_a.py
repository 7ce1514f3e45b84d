"""The port's ``init_params(cfg, seed)`` against the reference's
``init_params(cfg, jax.random.key(seed))`` on reduced configs, leaf for
leaf: paths, shapes, dtypes and bits (qwen3-8b, mixtral-8x22b, gemma-2b, mamba2-2.7b). The archs are spread over
three files so that no one file holds a worker long.
"""
import pytest

from test_torch_helpers import check_init_params_equal_reference, one_torch_thread  # noqa: F401

ARCHS = ('gemma-2b', 'mamba2-2.7b', 'mixtral-8x22b', 'qwen3-8b')


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_equal_reference(arch):
    """Every leaf bit-equal, the SSM initialisers' float32 logs included."""
    check_init_params_equal_reference(arch)
