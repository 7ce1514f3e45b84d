"""Gradient compression with error feedback (port of
``repro.optim.compress``): int8 (per-tensor symmetric scale) and top-k
sparsification, each round trip returning the decompressed gradients and
the new fp32 residuals that feed the next step (EF-SGD).

  comp_state = init_state(grads_like)
  grads, comp_state = compress_decompress(grads, comp_state, scheme)
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.param import tree_leaves, tree_map


def init_state(grads_like) -> Any:
    """Error-feedback residual buffers (fp32), congruent with grads."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def _int8_roundtrip(g):
    """Per-tensor scale symmetric int8 quantization."""
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def _topk_roundtrip(g, frac: float):
    g32 = g.float()
    flat = g32.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    kept = torch.where(torch.abs(flat) >= thresh, flat, 0.0)
    return kept.reshape(g32.shape)


def compress_decompress(grads, ef_state, scheme: str = "int8",
                        topk_frac: float = 0.05) -> Tuple[Any, Any]:
    """Returns (decompressed grads as seen post-allreduce, new EF state)."""
    def one(g, e):
        g32 = g.float() + e
        if scheme == "int8":
            out = _int8_roundtrip(g32)
        elif scheme == "topk":
            out = _topk_roundtrip(g32, topk_frac)
        elif scheme == "none":
            out = g32
        else:
            raise ValueError(scheme)
        return out.to(g.dtype), g32 - out

    pairs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(ef_state))]
    outs, errs = iter([o for o, _ in pairs]), iter([e for _, e in pairs])
    return (tree_map(lambda _: next(outs), grads),
            tree_map(lambda _: next(errs), grads))


def wire_bytes(grads, scheme: str = "int8", topk_frac: float = 0.05) -> float:
    """Bytes on the wire for one DP all-reduce of these grads."""
    total_elems = sum(g.numel() for g in tree_leaves(grads))
    if scheme == "int8":
        return total_elems * 1.0
    if scheme == "topk":
        return total_elems * topk_frac * 8.0  # value + index
    return total_elems * 2.0  # bf16
