"""In-memory spans and counters inside the port: where the host's time
goes in the engine, the compute backend, the model and the kernels' set-up.

One process-wide ``TRACER`` (the model's free functions take no engine
handle, as ``kernels/_work.py``'s ``TRACE`` is process-wide for the same
reason). It is off by default. A span site reads one attribute when off
and enters the shared no-op context, allocating nothing and reading no
clock::

    with TRACER.span("engine.plan") if TRACER.on else NOOP:
        ...

Turning it on is an API call, made by whoever drives the engine::

    TRACER.enable()
    for _ in range(n):
        engine.step()
    TRACER.disable()
    spans, counters = TRACER.drain()

A span holds its name, start and end (``time.time_ns()``, the epoch clock
the benchmark's own spans use), its id, the id of the span open around it
when it started (its cause; 0 at the top), the request id where one
applies, and a few attributes (tokens, rows, the layer index, a chunk's
offset). Spans are kept in the order they start. Nothing is written out:
``drain()`` hands over what was recorded and empties the buffer.
"""
from __future__ import annotations

from time import time_ns
from typing import Dict, List, NamedTuple, Optional


class Span(NamedTuple):
    name: str
    start: int              # ns, ``time.time_ns()``
    end: int
    id: int
    parent: int             # the span open around it when it started; 0: none
    rid: Optional[int]      # the request it served, where one applies
    attrs: dict


class Drained(NamedTuple):
    spans: List[Span]
    counters: Dict[str, int]


class _Noop:
    """The shared context a span site enters while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):     # named: ``*exc`` would build a tuple
        return False


NOOP = _Noop()


class Tracer:
    """Spans and counters, kept in memory while ``on``. The tracer is the
    context a span site enters: ``span()`` readies one record and the
    ``with`` statement that called it opens it at once, so spans close in
    the order of a stack and no object is made for one. Each record, the
    ``Span``'s fields in a list, joins the buffer when its span starts and
    gets its end when it closes; ``drain()`` makes it a ``Span``. One
    thread records at a time."""

    def __init__(self):
        self.on = False
        self.counters: Dict[str, int] = {}
        self._buf: List[list] = []          # records in the order spans start
        self._stack: List[list] = []        # the records of the open spans
        self._next = 0
        self._ready: Optional[list] = None

    def span(self, name: str, rid: Optional[int] = None, **attrs) -> "Tracer":
        """The context of one span, for a ``with`` statement to enter at
        once. Call it only while ``on`` (sites guard with ``if TRACER.on
        else NOOP``)."""
        self._ready = [name, 0, 0, 0, 0, rid, attrs]
        return self

    def __enter__(self):
        rec, stack = self._ready, self._stack
        rec[3] = self._next = self._next + 1
        rec[4] = stack[-1][3] if stack else 0
        stack.append(rec)
        self._buf.append(rec)
        rec[1] = time_ns()
        return self

    def __exit__(self, typ, value, tb):
        self._stack.pop()[2] = time_ns()
        return False

    def annotate(self, **attrs) -> None:
        """Add ``attrs`` to the innermost open span (sites guard with ``if
        TRACER.on``)."""
        if self._stack:
            self._stack[-1][6].update(attrs)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` (sites guard with ``if TRACER.on``)."""
        self.counters[name] = self.counters.get(name, 0) + n

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        """Stop recording; spans still open are recorded when they close,
        and what was recorded stays until ``drain()``."""
        self.on = False

    def drain(self) -> Drained:
        """The spans closed and the counts made since the last drain, the
        spans in the order they started; spans still open stay for the
        next drain."""
        done = [Span(*r) for r in self._buf if r[2]]
        out = Drained(done, self.counters)
        self._buf = [r for r in self._buf if not r[2]]
        self.counters = {}
        return out


TRACER = Tracer()
