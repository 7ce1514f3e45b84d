"""The port's ``init_params(cfg, seed)`` against the reference's
``init_params(cfg, jax.random.key(seed))`` on reduced configs, leaf for
leaf: paths, shapes, dtypes and bits (deepseek-v2-lite-16b, hymba-1.5b, internvl2-76b,
musicgen-large). The archs are spread over
three files so that no one file holds a worker long.
"""
import pytest

from test_torch_helpers import check_init_params_equal_reference, one_torch_thread  # noqa: F401

ARCHS = ('deepseek-v2-lite-16b', 'hymba-1.5b', 'internvl2-76b', 'musicgen-large')


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_equal_reference(arch):
    """Every leaf bit-equal, the SSM initialisers' float32 logs included."""
    check_init_params_equal_reference(arch)
