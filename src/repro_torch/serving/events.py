"""Serving events. The port carries only what the engine raises so far:
the event-driven fleet plumbing of ``repro.serving.events`` comes with the
cluster slice."""
from __future__ import annotations

from typing import Optional


class NonQuiescentError(RuntimeError):
    """A simulation run exhausted its step/event budget with requests
    still queued or resident. Carries the partial report so callers that
    *expect* truncation (``on_stall="report"``) can still inspect it."""

    def __init__(self, msg: str, report: Optional[dict] = None):
        super().__init__(msg)
        self.report = report
