"""Ragged paged attention: one kernel for prefill-extend and batched
decode, reading KV page-by-page straight off the paged plane."""
from .ops import ragged_paged_attention
from .ref import (
    interleave_kv,
    paged_attention_rows,
    ragged_paged_attention_ref,
    split_kv,
    write_tokens_to_pages,
)

__all__ = [
    "ragged_paged_attention",
    "ragged_paged_attention_ref",
    "paged_attention_rows",
    "interleave_kv",
    "split_kv",
    "write_tokens_to_pages",
]
