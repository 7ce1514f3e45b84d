"""Assigned input-shape sets.

LM transformer shapes are seq_len x global_batch. ``decode_*``/``long_*``
lower ``serve_step`` (one new token against a KV cache of seq_len), NOT
``train_step``. ``long_500k`` is only applicable to sub-quadratic archs
(SSM / hybrid / windowed attention) — see DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs that may run long_500k (sub-quadratic / bounded-KV state)
LONG_CONTEXT_OK = frozenset({
    "mamba2-2.7b",      # SSM: O(1) state
    "hymba-1.5b",       # hybrid: SWA + 3 global layers
    "mixtral-8x22b",    # SWA window 4096 -> bounded KV
    "gemma2-27b",       # alternating local/global; global KV seq-sharded
})

# archs skipped for long_500k, with the DESIGN.md §Arch-applicability reason
LONG_CONTEXT_SKIP = {
    "deepseek-7b": "pure full attention (MHA)",
    "gemma-2b": "pure full attention (MQA, global)",
    "qwen3-8b": "pure full attention (GQA)",
    "deepseek-v2-lite-16b": "MLA is full attention over compressed KV",
    "musicgen-large": "pure full attention (MHA)",
    "internvl2-76b": "pure full attention (GQA)",
}


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def cells(arch_names):
    """Yield every applicable (arch, shape) dry-run cell."""
    for a in arch_names:
        for s in SHAPES.values():
            if s.name == "long_500k" and a not in LONG_CONTEXT_OK:
                continue
            yield a, s.name
