"""Spans of the program's layers, on the host clock and the profiler's.

``span(name, **ids)`` is a context manager put where a layer's work starts
and ends (the training iteration's phases, the stages' dispatches, the
model's sublayers, AdamW, the decode step).  Tracing is off by default:
``span`` then returns one shared no-op context, so a span costs one flag
test, the call, and the keyword dict of its ``ids``; it reads no clock,
enters no profiler range and synchronizes nothing.

``enable()`` turns tracing on for the process.  Each span is then:

* a :class:`Span` record kept in memory: its name, its start and end on
  ``time.perf_counter_ns``, its parent (the span open around it on the same
  thread, or ``None``) and its ids, which it takes from its parent and adds
  its own to (a training iteration's spans all carry ``iteration``, a
  ``generate`` call's ``request``, a decode step's ``step``);
* while a profiler runs (``torch.profiler``), a ``record_function`` range
  named ``PREFIX + name``, so that every span sits on the same clock as
  the device work it launched.  Without a profiler no range is entered:
  a range costs the host many times what the record does, and only a
  profiler reads it.

``drain()`` returns the records made since the last drain (in the order
the spans opened; a span still open has ``end_ns`` None) and forgets them;
``disable()`` turns tracing off again.  Nothing here reads the environment.
"""
from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from typing import Dict, List, Optional

import torch

PREFIX = "repro_torch/"

_OFF = nullcontext()
_on = False
_records: List["Span"] = []
_local = threading.local()


class Span:
    """One span: a record while tracing, and its own context manager."""
    __slots__ = ("name", "ids", "start_ns", "end_ns", "parent", "_range")

    def __init__(self, name: str, ids: Dict[str, object]):
        self.name = name
        self.ids = ids
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None
        self.parent: Optional[Span] = None

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent = stack[-1]
            self.ids = {**self.parent.ids, **self.ids}
        stack.append(self)
        _records.append(self)
        self._range = (torch.profiler.record_function(PREFIX + self.name)
                       if torch._C._autograd._profiler_enabled() else _OFF)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _stack().pop()
        return False


def _stack() -> List[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, **ids: object):
    """A span named ``name`` with ``ids``, or, with tracing off, a shared
    context that does nothing."""
    if not _on:
        return _OFF
    return Span(name, ids)


def ids() -> Dict[str, object]:
    """The ids of the innermost span open on this thread ({} if none)."""
    stack = _stack()
    return stack[-1].ids if stack else {}


def enabled() -> bool:
    """Whether tracing is on."""
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> List[Span]:
    """The records made since the last drain, in the order their spans
    opened; they are forgotten here."""
    out = _records[:]
    del _records[:len(out)]
    return out
