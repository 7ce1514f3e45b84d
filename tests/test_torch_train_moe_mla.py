"""The port's training path on MLA + MoE and MoE stacks (reduced
deepseek-v2-lite-16b: MLA un-absorbed at Dk 48 / Dv 32, 4 routed experts
top-2 plus a shared one behind a dense layer; reduced mixtral-8x22b: 8
experts top-2 under a window) in fp32 on the CPU against the JAX package,
weights bridged from the reference's ``init_params``: ``loss_and_metrics``
(loss, ce, z_loss and the summed MoE aux loss, 1e-5 relative), every
gradient leaf (1e-4 of the leaf's largest |grad|; a router leaf far off
reports its closest top-k margins), three AdamW steps (loss and grad norm
1e-4 relative); within torch, the three remat policies give equal
gradients. Score leaves (wq, wk, MLA's w_uk) are rescaled on both sides
(``test_torch_helpers.bridged_training``)."""
import pytest

from repro_torch.data import DataConfig, SyntheticPipeline
from test_torch_helpers import (bridged_training, check_adamw_steps_match_jax,
                                check_gradients_match_jax, check_loss_matches_jax,
                                check_remat_policies_agree)
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["deepseek-v2-lite-16b", "mixtral-8x22b"]


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    """(jax cfg, port cfg, numpy params, pipeline batches 0..2)."""
    jcfg, cfg, tree = bridged_training(request.param)
    pipe = SyntheticPipeline(cfg, DataConfig(seq_len=64, global_batch=2, seed=3))
    return jcfg, cfg, tree, [pipe.batch_at(s) for s in range(3)]


def test_loss_and_metrics_match_jax(bridged):
    jcfg, cfg, tree, batches = bridged
    check_loss_matches_jax(jcfg, cfg, tree, batches[0], expect_aux=True)


def test_gradients_match_jax(bridged):
    jcfg, cfg, tree, batches = bridged
    check_gradients_match_jax(jcfg, cfg, tree, batches[0])


def test_three_adamw_steps_match_jax(bridged):
    jcfg, cfg, tree, batches = bridged
    check_adamw_steps_match_jax(jcfg, cfg, tree, batches)


def test_remat_policies_give_equal_gradients(bridged):
    _, cfg, tree, batches = bridged
    check_remat_policies_agree(cfg, tree, batches[1])
