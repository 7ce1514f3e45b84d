"""The port's training path with the frontends' inputs, in fp32 on the CPU
against the JAX package, weights bridged from the reference's
``init_params``: reduced musicgen-large on the pipeline's (B, S, 4)
codebook batches (the summed codebook embeddings in, one head and one CE
term per codebook out) and reduced internvl2-76b on ``sample_batch``'s
image embeds (8 patch embeddings in front of the text, never scored).
``loss_and_metrics`` 1e-5 relative, every gradient leaf 1e-4 of its
largest |grad|, three AdamW steps 1e-4 relative; within torch, the three
remat policies give equal gradients. wq and wk are rescaled on both sides
(``test_torch_helpers.bridged_training``)."""
import numpy as np
import pytest

from repro.models import frontends as jfrontends
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.models import frontends
from test_torch_helpers import (bridged_training, check_adamw_steps_match_jax,
                                check_gradients_match_jax, check_loss_matches_jax,
                                check_remat_policies_agree)
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["musicgen-large", "internvl2-76b"]
SEQ = 64


def _batches(jcfg, cfg):
    if cfg.n_codebooks > 1:
        pipe = SyntheticPipeline(cfg, DataConfig(seq_len=SEQ, global_batch=2, seed=3))
        return [pipe.batch_at(s) for s in range(3)]
    out = []
    for seed in (3, 4, 5):   # S counts the image rows: SEQ text tokens each
        b = {k: v.numpy() for k, v in frontends.sample_batch(
            cfg, 2, SEQ + cfg.n_frontend_tokens, seed=seed).items()}
        want = jfrontends.sample_batch(jcfg, 2, SEQ + cfg.n_frontend_tokens, seed=seed)
        assert b.keys() == want.keys()
        assert all(np.array_equal(b[k], np.asarray(want[k])) for k in b)
        out.append(b)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    """(jax cfg, port cfg, numpy params, batches 0..2)."""
    jcfg, cfg, tree = bridged_training(request.param)
    return jcfg, cfg, tree, _batches(jcfg, cfg)


def test_batches_carry_the_frontends_inputs(bridged):
    _, cfg, _, batches = bridged
    if cfg.n_codebooks > 1:
        assert batches[0]["tokens"].shape == batches[0]["labels"].shape == (2, SEQ, 4)
    else:
        assert batches[0]["tokens"].shape == batches[0]["labels"].shape == (2, SEQ)
        assert batches[0]["image_embeds"].shape == (2, cfg.n_frontend_tokens, cfg.d_model)


def test_loss_and_metrics_match_jax(bridged):
    jcfg, cfg, tree, batches = bridged
    check_loss_matches_jax(jcfg, cfg, tree, batches[0], expect_aux=False)


def test_gradients_match_jax(bridged):
    jcfg, cfg, tree, batches = bridged
    check_gradients_match_jax(jcfg, cfg, tree, batches[0])


def test_three_adamw_steps_match_jax(bridged):
    jcfg, cfg, tree, batches = bridged
    check_adamw_steps_match_jax(jcfg, cfg, tree, batches)


def test_remat_policies_give_equal_gradients(bridged):
    _, cfg, tree, batches = bridged
    check_remat_policies_agree(cfg, tree, batches[1])
