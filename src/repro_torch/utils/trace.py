"""Spans of the port's read and write paths, kept in memory on the
profiler's clock.

Tracing is on exactly while a ``torch.profiler`` records
(``torch.autograd.profiler._is_profiler_enabled``), so a profile taken
around the port turns it on and nothing else does.  A span records its
``name``, ``start_ns`` and ``end_ns`` from :func:`time.time_ns`, the index
of the span open around it (``parent``, None for a root), a ``request`` id
shared by every span under one root (one read, one fence), and ``attrs``,
a small dict: the keywords it was opened with, and counts (:func:`add`).

**The shared clock.**  The profiler stamps each raw event at
``kineto_results.trace_start_ns() + time_range.start * 1000``, in Unix
nanoseconds, the clock :func:`time.time_ns` reads: spans and the profiler's
events join by time, so an idle gap of a device trace can be put down to
the innermost span open over it.  Nothing is added to the profiler's
trace: the port calls no ``record_function``, whose ranges the profiler
also mirrors onto the device's timeline.

**The record** holds the most recent stretch of time in which a profiler
recorded: a span that finds tracing off marks the stretch as over, and the
next span that finds it on drops the old records.  :func:`spans` returns
them.

**Device work** is queued, so a span times what its host code waits for,
not what it launched.  :func:`settle` waits for a CUDA device while
tracing is on, so that the span after it holds its own work alone.

**Counts read later.**  :func:`add_later` adds to a span a count that
would cost a device sync to read now (the live slabs of a kernel's map);
it is read when :func:`spans` returns the record, after the traced work.

**Cost when off.**  :func:`span` returns one shared do-nothing context:
one flag test and one store, with no allocation and no clock read.
:func:`add`, :func:`add_later`, :func:`settle` and :func:`on` are one flag
test.

The read and write paths run on the caller's thread, and spans nest on one
stack: spans of concurrent threads would nest wrongly.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler


class Span:
    """One span's record, and the ``with`` block that times it; ``end_ns``
    is None while it is open."""

    __slots__ = ("name", "index", "parent", "request", "start_ns", "end_ns",
                 "attrs")

    def __init__(self, name: str, index: int, parent: Optional[int],
                 request: int, attrs: Dict[str, object]):
        self.name, self.index = name, index
        self.parent, self.request = parent, request
        self.start_ns = self.end_ns = None
        self.attrs = attrs

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        _open.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, kind, value, tb):
        self.end_ns = time.time_ns()
        if _open and _open[-1] is self:
            _open.pop()
        return False


class _Off:
    """What :func:`span` returns while tracing is off: a ``with`` block
    that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        return False


_OFF = _Off()
_records: List[Span] = []
_open: List[Span] = []      # the open spans, innermost last
_requests = 0
_stale = True               # a span found tracing off since the last record
# counts of add_later not read yet: (the span's attrs, key, count)
_later: List[Tuple[Dict[str, object], str, Callable[[], float]]] = []


def span(name: str, **attrs):
    """A ``with`` block recorded as the span ``name``, with ``attrs``, while
    tracing is on."""
    global _stale, _requests
    if not _profiler._is_profiler_enabled:
        _stale = True
        return _OFF
    if _stale:                   # a new stretch: drop the last one's record
        _records.clear()
        _open.clear()
        _later.clear()
        _stale = False
    if _open:
        up = _open[-1]
        rec = Span(name, len(_records), up.index, up.request, attrs)
    else:
        _requests += 1
        rec = Span(name, len(_records), None, _requests, attrs)
    _records.append(rec)
    return rec


def on() -> bool:
    """Is tracing on: does a profiler record?"""
    return _profiler._is_profiler_enabled


def settle(device) -> None:
    """While tracing is on, wait for the work queued on ``device`` if it is
    a CUDA device, so that the span opened next does not wait for it."""
    if _profiler._is_profiler_enabled and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def add(key: str, n) -> None:
    """Add ``n`` to the count ``key`` of the innermost open span."""
    if _profiler._is_profiler_enabled and _open:
        attrs = _open[-1].attrs
        attrs[key] = attrs.get(key, 0) + n


def add_later(key: str, count: Callable[[], float]) -> None:
    """Add ``count()`` to the count ``key`` of the innermost open span,
    calling it when :func:`spans` next returns the record."""
    if _profiler._is_profiler_enabled and _open:
        _later.append((_open[-1].attrs, key, count))


def spans() -> List[Span]:
    """The record: every span of the latest traced stretch, in the order
    they opened, with the counts of :func:`add_later` added."""
    for attrs, key, count in _later:
        attrs[key] = attrs.get(key, 0) + count()
    _later.clear()
    return list(_records)
