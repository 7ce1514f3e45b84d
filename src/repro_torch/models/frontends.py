"""Modality-frontend stubs: the ``[audio]`` and ``[vlm]`` architectures
specify the transformer backbone only, and their inputs stand in for the
frontend — multi-codebook tokens for audio, precomputed patch embeddings
for vision — as ``repro.models.frontends`` builds them.

``input_specs`` / ``decode_input_specs`` give the abstract inputs of an
(arch x shape) cell as tensors on the ``meta`` device (shape and dtype,
nothing allocated); ``sample_batch`` builds small concrete inputs from the
same ``np.random.default_rng(seed)`` draws, in the same order, so a seed
gives the reference's integers and, in float32, its normals.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models.param import torch_dtype


def token_shape(cfg: ModelConfig, batch: int, seq: int):
    if cfg.n_codebooks > 1:
        return (batch, seq, cfg.n_codebooks)
    return (batch, seq)


def _text_len(cfg: ModelConfig, seq: int) -> int:
    return seq - (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Abstract inputs for train/prefill steps (``meta`` tensors)."""
    B, S = shape.global_batch, shape.seq_len
    text = token_shape(cfg, B, _text_len(cfg, S))
    specs = {"tokens": _spec(text, torch.int32)}
    if shape.kind == "train":
        specs["labels"] = _spec(text, torch.int32)
    if cfg.frontend == "vision":
        specs["image_embeds"] = _spec((B, cfg.n_frontend_tokens, cfg.d_model),
                                      torch_dtype(cfg.dtype))
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Abstract inputs for one serve/decode step (token + position)."""
    return {
        "last_tokens": _spec(token_shape(cfg, shape.global_batch, 1), torch.int32),
        "cur_pos": _spec((), torch.int32),
    }


def sample_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 with_labels: bool = True, device="cpu") -> Dict[str, torch.Tensor]:
    """Small concrete batch for smoke tests (deterministic), on ``device``."""
    rng = np.random.default_rng(seed)
    tshape = token_shape(cfg, batch, _text_len(cfg, seq))

    def ints():
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, tshape),
                               dtype=torch.int32, device=device)

    out = {"tokens": ints()}
    if with_labels:
        out["labels"] = ints()
    if cfg.frontend == "vision":
        emb = rng.normal(0, 0.02, (batch, cfg.n_frontend_tokens, cfg.d_model))
        # float64 -> float32 as numpy rounds it, then the model dtype
        out["image_embeds"] = torch.as_tensor(emb.astype(np.float32)).to(
            device=device, dtype=torch_dtype(cfg.dtype))
    return out
