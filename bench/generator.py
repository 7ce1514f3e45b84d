"""The one traffic generator: reads a mix's parameters from
``bench/traffic/<name>.json`` and yields requests from ``--seed``.

Every seed gets the same set of sizes, in another order: lengths are the
distribution's quantiles at (i + 1/2) / ``block`` for i < ``block``,
shuffled anew in each block of ``block`` requests. The seed draws the
token ids and the orders. A mix's keys:

- ``loop``: ``"closed"`` (the only loop the harness drives); ``clients``:
  closed-loop clients (one request each in flight, no think time);
  ``max_cache_len``: the engine's bound on a request's positions;
  ``block``: requests a block of sizes (default 64);
- ``prompt`` / ``output``: ``{"uniform": [lo, hi]}`` or ``{"lognormal":
  {"median", "sigma"}, "clip": [lo, hi]}``, token counts.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from statistics import NormalDist

import numpy as np


@dataclasses.dataclass
class Request:
    prompt: list
    max_new: int


def load(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def _quantiles(spec: dict, n: int) -> list:
    qs = [(i + 0.5) / n for i in range(n)]
    if "uniform" in spec:
        lo, hi = spec["uniform"]
        return [int(round(lo + q * (hi - lo))) for q in qs]
    if "lognormal" in spec:
        ln, (lo, hi) = spec["lognormal"], spec["clip"]
        nd = NormalDist()
        vals = [ln["median"] * float(np.exp(ln["sigma"] * nd.inv_cdf(q))) for q in qs]
        return [int(min(max(round(v), lo), hi)) for v in vals]
    raise ValueError(f"unknown length distribution {spec!r}")


class Stream:
    """An endless request stream of a mix, for one seed and vocabulary."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec = spec
        self.rng = np.random.default_rng([int(seed), 0x7af1c])
        self.vocab = int(vocab)
        self.block = int(spec.get("block", 64))
        self._pending: list = []

    def _refill(self) -> None:
        prompts = _quantiles(self.spec["prompt"], self.block)
        outputs = _quantiles(self.spec["output"], self.block)
        self.rng.shuffle(prompts)
        self.rng.shuffle(outputs)
        self._pending = list(zip(prompts, outputs))

    def next(self) -> Request:
        if not self._pending:
            self._refill()
        p, o = self._pending.pop(0)
        return Request(prompt=self.rng.integers(2, self.vocab, int(p)).tolist(), max_new=o)
