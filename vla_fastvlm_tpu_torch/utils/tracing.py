"""Spans and counters inside the port, on the profiler's clock.

``span(name, **attrs)`` marks a block of the program: the policy API's
host preparation, the paged server's admission and decode tick, the
trainer's feed and step (PERF.md §3 lists every name and what reads it).
``count(name, n)`` adds to a named counter. Both record only while tracing
is on (``on()``):

- while a ``torch.profiler`` records (``torch.autograd._profiler_enabled()``),
  and then each span also opens ``torch.profiler.record_function("vft." +
  name)``, so the profiler's trace holds it on its own clock, beside the
  kernels and copies its calls launched;
- after ``enable()``, until ``disable()``.

Off, ``span`` returns one shared no-op context manager: no range, no clock
read, nothing stored. On, a span keeps a ``Span`` (its index, name,
``time.perf_counter_ns()`` stamps, the index of the enclosing open span on
the same thread, attrs) in a buffer that holds the newest ``CAPACITY``.
``spans()``, ``counters()`` and ``reset()`` read and clear what was kept.
There is no exporter: a profiler's trace is the export.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple

import torch

PREFIX = "vft."
CAPACITY = 1 << 16


class Span(NamedTuple):
    index: int  # in opening order, from 0 after ``reset()``
    name: str
    start_ns: int
    end_ns: int
    parent: int  # index of the enclosing open span on the same thread; -1 for none
    attrs: dict

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


_profiling = torch.autograd._profiler_enabled
_enabled = False
_spans: collections.deque = collections.deque(maxlen=CAPACITY)
_counts: Dict[str, int] = {}
_indices = itertools.count()
_local = threading.local()


def _open_stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "attrs", "index", "parent", "start", "range")

    def __init__(self, name: str, attrs: dict) -> None:
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _open_stack()
        self.parent = stack[-1] if stack else -1
        self.index = next(_indices)
        stack.append(self.index)
        self.range = torch.profiler.record_function(PREFIX + self.name) if _profiling() else None
        if self.range is not None:
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _open_stack().pop()
        _spans.append(Span(self.index, self.name, self.start, end, self.parent, self.attrs))
        return False


def on() -> bool:
    """Whether spans and counters record: a profiler records or ``enable()`` was called."""
    return _enabled or _profiling()


def span(name: str, **attrs):
    """A context manager over one block of the program, named ``name``."""
    if not on():
        return _OFF
    return _On(name, attrs)


def traced(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if on():
        _counts[name] = _counts.get(name, 0) + n


def spans() -> List[Span]:
    """The kept spans, in the order they closed."""
    return list(_spans)


def counters() -> Dict[str, int]:
    return dict(_counts)


def reset() -> None:
    """Forget every kept span and counter; indices start again at 0."""
    global _indices
    _spans.clear()
    _counts.clear()
    _indices = itertools.count()


def enable() -> None:
    """Record with no profiler running, until ``disable()``."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False
