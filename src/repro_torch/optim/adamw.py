"""AdamW with fp32 moments and global-norm clipping (port of
``repro.optim.adamw``).

Parameters stay in their dtype (bf16); moments and the update math run in
fp32, in the reference's order: clip the gradients and cast them back to
their dtype, then update. Unlike the JAX package, ``adamw_update`` writes
the parameters and moments IN PLACE (and returns the same tensors): at
gemma-2b's 2.5B parameters a second copy of the 30 GB training state would
not fit beside the first on one card. The optimizer state is a tree
congruent with the parameters: ``{"m", "v", "step"}``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.models.param import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def lr_at(oc: OptConfig, step):
    """Linear warmup + cosine decay, in fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - oc.warmup_steps)
                    / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return oc.lr * warm * cos


def init_opt_state(params) -> dict:
    """fp32 zero moments beside every parameter, and step 0 (int32)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(leaf²), in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global norm is at most ``max_norm``, cast
    back to their dtypes; the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(oc: OptConfig, params, grads, opt_state) -> Tuple[Any, dict, dict]:
    """One AdamW step. Returns (params, opt_state, {"grad_norm", "lr"});
    params, m and v are the input tensors, updated in place."""
    grads, gnorm = clip_by_global_norm(grads, oc.grad_clip)
    step = opt_state["step"] + 1
    lr = lr_at(oc, step)
    b1, b2 = oc.b1, oc.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
        g32 = g.float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        del g32
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(oc.eps))
        p32 = p.float()
        delta.add_(oc.weight_decay * p32)
        p.copy_(p32.sub_(lr * delta))
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
