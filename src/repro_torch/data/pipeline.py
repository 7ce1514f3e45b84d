"""Deterministic synthetic data pipeline.

Host-sharded, step-indexed, and fully resumable: batch contents are a pure
function of (seed, step, host) — restart from a checkpoint at step N and the
stream continues identically, which the fault-tolerance tests rely on.

The synthetic corpus is a mixture of short/long "documents" drawn from a
hash-based stream with mild Markov structure (so tiny models can actually
reduce loss), packed into fixed-length rows with next-token labels and
document-boundary masking.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 1234
    doc_len_lo: int = 16
    doc_len_hi: int = 192
    n_hosts: int = 1
    host_id: int = 0


def _doc_tokens(rng: np.random.Generator, length: int, vocab: int,
                base: np.ndarray) -> np.ndarray:
    """A 'document': 2nd-order pattern over a CORPUS-SHARED base table, so
    the structure generalizes across fresh batches (loss can decrease on
    held-out steps, not just on memorized ones). Documents differ by their
    random starting state."""
    out = np.empty(length, np.int64)
    x = int(rng.integers(2, vocab))
    for i in range(length):
        x = int(base[(x + i) % len(base)] + (x * 31 + i) % 7) % vocab
        out[i] = max(x, 2)
    return out


class SyntheticPipeline:
    """Iterator of {tokens, labels} batches for one host."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig):
        self.cfg = cfg
        self.dc = dc
        assert dc.global_batch % dc.n_hosts == 0
        self.host_batch = dc.global_batch // dc.n_hosts
        # corpus-level pattern table (function of the seed only; the second
        # component is a fixed tag — str.__hash__ is process-salted and
        # would break cross-process determinism)
        self._base = np.random.default_rng(
            (dc.seed, 0xC0DE)).integers(2, cfg.vocab_size, size=16)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        dc, cfg = self.dc, self.cfg
        B, S = self.host_batch, dc.seq_len
        K = cfg.n_codebooks
        shape = (B, S + 1) if K == 1 else (B, S + 1, K)
        toks = np.zeros(shape, np.int64)
        for b in range(B):
            rng = np.random.default_rng(
                (dc.seed, step, dc.host_id, b))  # pure function of indices
            row = np.zeros((S + 1, K), np.int64)
            fill = 0
            while fill < S + 1:
                L = int(rng.integers(dc.doc_len_lo, dc.doc_len_hi))
                L = min(L, S + 1 - fill)
                for k in range(K):
                    row[fill:fill + L, k] = _doc_tokens(rng, L, cfg.vocab_size,
                                                        self._base)
                if fill + L < S + 1:
                    row[fill + L - 1, :] = 1  # EOS boundary
                fill += L
            toks[b] = row if K > 1 else row[:, 0]
        tokens = toks[:, :-1]
        labels = toks[:, 1:].copy()
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1
