"""Helpers for the readers of the port's own spans and counters
(``vla_fastvlm_tpu_torch/utils/tracing.py``): the ``program_span`` and
``program_counter`` metrics.

The port's tracer records only while a profiler records, and in a run of
the benchmark that is the traced run's profiled segment alone: what
``recorded()`` returns is that segment's spans and counters. A program
without the tracer records nothing, and every reader then returns None.
A span is read as the port keeps it: ``name``, ``ms``, ``index`` and
``parent`` (the index of the enclosing span, -1 for none).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .common import median


def recorded() -> Tuple[list, Dict[str, int]]:
    """The port tracer's kept spans and its counters."""
    try:
        from vla_fastvlm_tpu_torch.utils import tracing
    except ImportError:
        return [], {}
    return tracing.spans(), tracing.counters()


class Tree:
    """Spans by index, with their children."""

    def __init__(self, spans: list) -> None:
        self.by_index = {s.index: s for s in spans}
        self.children: Dict[int, list] = defaultdict(list)
        for s in spans:
            self.children[s.parent].append(s)

    def outermost(self, name: str) -> list:
        """Spans named ``name`` inside no other span of that name, in opening order."""
        out = []
        for s in self.by_index.values():
            if s.name == name and not any(a.name == name for a in self.ancestors(s)):
                out.append(s)
        return sorted(out, key=lambda s: s.index)

    def ancestors(self, span):
        parent = self.by_index.get(span.parent)
        while parent is not None:
            yield parent
            parent = self.by_index.get(parent.parent)

    def below(self, span, names) -> List:
        """Every span named ``names`` (a name or a tuple of them) under ``span``, at any depth."""
        names = (names,) if isinstance(names, str) else names
        out, todo = [], list(self.children.get(span.index, ()))
        while todo:
            s = todo.pop()
            if s.name in names:
                out.append(s)
            todo.extend(self.children.get(s.index, ()))
        return out


def median_ms_below(unit: str, names, need: Optional[str] = None) -> Optional[float]:
    """Median over the outermost ``unit`` spans (ticks, steps) that hold a
    ``need`` span (any, without ``need``) of the milliseconds they spent
    in spans named ``names`` (a name or a tuple of them); None where there
    is no such unit."""
    tree = Tree(recorded()[0])
    units = [u for u in tree.outermost(unit) if need is None or tree.below(u, need)]
    return median([sum(s.ms for s in tree.below(u, names)) for u in units])


def ms_per_unit(unit: str, name: str) -> Optional[float]:
    """Milliseconds in ``name`` spans over the number of ``unit`` spans
    (for work a unit causes but does not enclose); None without both."""
    spans = recorded()[0]
    units = sum(s.name == unit for s in spans)
    inside = [s.ms for s in spans if s.name == name]
    return sum(inside) / units if units and inside else None
