"""Training step: forward and backward over the chunked-CE loss, then
AdamW (port of ``repro.train.step``).

``make_train_step(cfg, oc)`` returns ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)`` with metrics ``loss``, ``ce``,
``z_loss``, ``aux``, ``tokens``, ``grad_norm`` and ``lr`` (0-d tensors on
the parameters' device). Parameters and moments are updated in place
(``optim.adamw``). ``batch`` holds ``tokens`` and ``labels`` (B, S) int
tensors on that device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.models.transformer import loss_and_metrics
from repro_torch.optim.adamw import OptConfig, adamw_update
from repro_torch.runtime.sharding import like


def value_and_grad(cfg: ModelConfig, params, batch):
    """(loss, metrics, grads): grads a tree congruent with ``params`` in
    the parameters' dtypes (and, for DTensor parameters, placements)."""
    with torch.enable_grad():
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = loss_and_metrics(cfg, leaves, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda p: like(next(grads), p), params)


def make_train_step(cfg: ModelConfig, oc: OptConfig):
    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(cfg, params, batch)
        params, opt_state, stats = adamw_update(oc, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss, **stats)

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_and_metrics(cfg, params, batch)
        return dict(metrics, loss=loss)
    return eval_step
