"""Ring-cache attention as a view onto the ragged paged-attention kernel's
explicit-position mode (see ``ops`` for the mapping)."""
from .ops import decode_attention, extend_attention, ring_page_size, ring_pages

__all__ = ["decode_attention", "extend_attention", "ring_page_size", "ring_pages"]
