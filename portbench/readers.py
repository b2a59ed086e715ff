"""Helpers the per-layer metric readers (``portbench/metrics/<name>.py``)
share. A reader is ``read(run) -> float | None``; ``run`` has ``window``
(``common.Window``: host seconds by label, FLOPs, seconds), ``summary``
(``trace.Summary`` of the profiled segment), ``ranges`` (``trace.Ranges``:
least seconds by range) and ``units`` (ticks, cycles or steps profiled).
A reader that finds nothing to read returns None and the metric is left
out of the result line."""

from __future__ import annotations

from typing import Optional

from .common import median
from .reference.bounds import PEAK_BF16_FLOPS


def device_ms_per_unit(run, name: str) -> Optional[float]:
    """Device milliseconds a profiled unit inside range ``name``."""
    s = run.summary.device_s.get(name) if run.summary else None
    return None if not s or not run.units else s / run.units * 1e3


def roofline(run, name: str) -> Optional[float]:
    """Per cent: least seconds of range ``name``'s calls over their device seconds."""
    s = run.summary.device_s.get(name) if run.summary else None
    least = run.ranges.bound_s.get(name) if run.ranges else None
    return None if not s or not least else 100.0 * least / s


def host_median_ms(run, label: str) -> Optional[float]:
    m = median(run.window.host_s.get(label) or [])
    return None if m is None else m * 1e3


def step_mfu(run) -> Optional[float]:
    """Per cent of the dense bf16 peak: model FLOPs of the window's work over
    the window's seconds."""
    if not run.window.flops or not run.window.seconds:
        return None
    return 100.0 * run.window.flops / run.window.seconds / PEAK_BF16_FLOPS


def device_idle(run) -> Optional[float]:
    """Per cent of the untraced window with nothing running on the card:
    1 - device-busy seconds a profiled unit (the union of device intervals)
    / the window's seconds a unit. The profiled segment's own span is left
    out: the profiler's host overhead stretches it. Noise can take it
    below 0 where the card is busy all through."""
    s, w = run.summary, run.window
    if not s or not s.device_events or not run.units or not w.units or w.seconds <= 0:
        return None
    return 100.0 * (1.0 - (s.busy_s / run.units) / (w.seconds / w.units))
