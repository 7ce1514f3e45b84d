"""Faults planted underneath the timed path, to see the check come out not
correct: ``control.py --fault <name>`` reads one on the card at a cell's
own size, ``bench/tests`` on the CPU at a tiny one. Each replaces a
function of the program for the life of a ``Patch``:

- ``token_altered``: every sampled token moved to the next id, where it is
  produced;
- ``state_unchanged``: the state pages are never written, so each step
  starts from the state the pages already held;
- ``half_batch``: the upper half of every decode batch's rows gets the mean
  of all rows' logits instead of its own.
"""
from __future__ import annotations


class Patch:
    """``setattr`` that ``undo`` takes back, in reverse order."""

    def __init__(self):
        self._saved: list = []

    def setattr(self, obj, name: str, value) -> None:
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)


def token_altered(mp) -> None:
    from repro_torch.serving.engine import ComputeBackend
    orig = ComputeBackend.sample
    mp.setattr(ComputeBackend, "sample",
               lambda self, logits: (orig(self, logits) + 1) % logits.shape[-1])


def state_unchanged(mp) -> None:
    from repro_torch.models import ssm
    mp.setattr(ssm, "_write_state_pages", lambda pages, pid, ok, new: None)


def half_batch(mp) -> None:
    import torch

    from repro_torch.models import transformer as tfm
    orig = tfm.paged_decode

    def decode(cfg, params, caches, last_tokens, cur_pos, page_table, active=None,
               page_tokens=None):
        logits, caches = orig(cfg, params, caches, last_tokens, cur_pos, page_table,
                              active=active, page_tokens=page_tokens)
        keep = torch.arange(logits.shape[0], device=logits.device) < logits.shape[0] // 2
        return torch.where(keep[:, None], logits, logits.mean(0, keepdim=True)), caches
    mp.setattr(tfm, "paged_decode", decode)


FAULTS = {"token_altered": token_altered, "state_unchanged": state_unchanged,
          "half_batch": half_batch}
