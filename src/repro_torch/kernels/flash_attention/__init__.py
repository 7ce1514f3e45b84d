"""Flash attention, forward and backward: the causal (windowed,
softcapped) attention of the training path, one forward kernel and two
backward kernels (dK/dV and dQ) under one autograd function."""
from .ops import (FlashAttention, flash_attention_bwd, flash_attention_bwd_dkdv,
                  flash_attention_bwd_dq, flash_attention_fwd)
from .ref import attention_ref, flash_bwd_ref, flash_fwd_ref

__all__ = [
    "FlashAttention", "flash_attention_fwd", "flash_attention_bwd",
    "flash_attention_bwd_dkdv", "flash_attention_bwd_dq", "attention_ref",
    "flash_fwd_ref", "flash_bwd_ref",
]
