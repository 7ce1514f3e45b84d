"""Shared layer primitives: RMSNorm, RoPE, activations, (gated) MLPs,
embeddings and LM heads. Plain functions over ParamDef-described
parameter dicts, rounding where ``repro.models.layers`` rounds (norms and
RoPE compute in fp32 and cast back to the input dtype)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamDef

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_def(dim: int, axis_name: str = "embed") -> ParamDef:
    return ParamDef((dim,), (axis_name,), init="zeros")  # (1+g) parameterization


def rmsnorm(x, gamma, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + gamma.float())).to(dt)


# ---------------------------------------------------------------------------
# RoPE (NeoX half-rotation style)
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    # a Python scalar base: no host-to-device copy (and stream sync) per call
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: scalar, (S,), or (B, S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)  # (d/2,)
    pos = torch.as_tensor(positions, device=x.device).to(torch.float32)
    ang = pos[..., None] * inv  # (..., d/2)
    # normalize to broadcast against (B, S, H, d/2)
    if pos.ndim == 0:
        ang = ang.reshape(1, 1, 1, -1)
    elif pos.ndim == 1:  # (S,)
        ang = ang[None, :, None, :]
    elif pos.ndim == 2:  # (B, S)
        ang = ang[:, :, None, :]
    else:
        raise ValueError(f"positions rank {pos.ndim}")
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / softcap
# ---------------------------------------------------------------------------


def activation(name: str):
    if name in ("silu",):
        return F.silu
    if name in ("gelu", "gelu_plain"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain)
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig, d_ff: int) -> dict:
    d = cfg.d_model
    gated = cfg.act in ("silu", "gelu")
    defs = {
        "w_up": ParamDef((d, d_ff), ("embed", "ff")),
        "w_down": ParamDef((d_ff, d), ("ff", "embed")),
    }
    if gated:
        defs["w_gate"] = ParamDef((d, d_ff), ("embed", "ff"))
    return defs


def mlp(cfg: ModelConfig, p: dict, x):
    act = activation(cfg.act)
    up = x @ p["w_up"]
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * up
    else:
        h = act(up)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------


def embed_defs(cfg: ModelConfig) -> dict:
    v, d, k = cfg.padded_vocab, cfg.d_model, cfg.n_codebooks
    shape = (k, v, d) if k > 1 else (v, d)
    axes = ("codebooks", "vocab", "embed") if k > 1 else ("vocab", "embed")
    emb_std = d ** -0.5 if cfg.tie_embeddings else 1.0
    defs = {"embedding": ParamDef(shape, axes, std=emb_std)}
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef(shape, axes)
    return defs


def embed(cfg: ModelConfig, p: dict, tokens):
    """tokens: (B, S) int or (B, S, K) for multi-codebook audio."""
    e = p["embedding"]
    tokens = tokens.long()
    if cfg.n_codebooks > 1:
        # sum codebook embeddings: e (K, V, D), tokens (B, S, K)
        out = torch.zeros(tokens.shape[:2] + (cfg.d_model,), dtype=e.dtype,
                          device=e.device)
        for k in range(cfg.n_codebooks):
            out = out + e[k][tokens[..., k]]
    else:
        out = e[tokens]
    if cfg.scale_embeddings:
        out = out * torch.tensor(math.sqrt(cfg.d_model), dtype=out.dtype,
                                 device=out.device)
    return out


def lm_logits(cfg: ModelConfig, p: dict, x):
    """x: (..., D) -> logits (..., V) or (..., K, V) for multi-codebook."""
    table = p["embedding"] if cfg.tie_embeddings else p["lm_head"]
    if cfg.n_codebooks > 1:
        logits = torch.einsum("...d,kvd->...kv", x, table)
    else:
        logits = x @ table.T
    return softcap(logits, cfg.final_softcap)
