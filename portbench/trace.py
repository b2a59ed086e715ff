"""Ranges the harness opens around calls into the program, the profiler over
a traced segment, and the reduction of its trace.

``Ranges`` swaps a method of an object (or a function of a module) for a
wrapper that opens a ``torch.profiler.record_function`` range named
``pb.<name>``, records the call's host seconds and, while ``bounds_on`` is
set, sums the least time of its work (a bound of ``reference/bounds.py``).
``restore()`` puts every original back.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities) inside a ``pb.profiled`` range that starts and ends with a
synchronisation, exports the Chrome trace to a temporary file, reads it
with ``summarize`` and deletes it:

- a kernel, copy or memset belongs to every harness range in which the host
  call that launched it ran (matched by the trace's correlation ids), so a
  range's device time is the work its calls enqueued, wherever and whenever
  it ran on the card;
- ``busy_s`` is the union of the device intervals inside the profiled
  range, not a sum of durations, and ``window_s`` that range's length;
- ``device_ops``: device seconds by operation name, the ten largest;
  ``idle_gaps``: the ten longest stretches with nothing on the card, each
  named by the innermost harness range the host was in at its middle (what
  the card was waiting for).
"""

from __future__ import annotations

import bisect
import functools
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "pb."
PROFILED = "profiled"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Ranges:
    def __init__(self) -> None:
        self._saved: List[Tuple[object, str, object, bool]] = []
        self.host_s: Dict[str, List[float]] = defaultdict(list)
        self.bound_s: Dict[str, float] = defaultdict(float)
        self.bounds_on = False
        self._depth: Dict[str, int] = defaultdict(int)

    def wrap(self, obj, attr: str, name: str, bound: Optional[Callable] = None) -> None:
        """Open range ``name`` around every call of ``obj.attr``. ``bound(args,
        kwargs, out)`` gives the call's least seconds. Host seconds are kept
        for the outermost call of a name only, so nested calls of wrapped
        methods under one name count once."""
        had = attr in vars(obj)
        original = getattr(obj, attr)
        label = PREFIX + name

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            self._depth[name] += 1
            try:
                with torch.profiler.record_function(label):
                    out = original(*args, **kwargs)
            finally:
                self._depth[name] -= 1
            if not self._depth[name]:
                self.host_s[name].append(time.perf_counter() - t0)
            if self.bounds_on and bound is not None:
                self.bound_s[name] += bound(args, kwargs, out)
            return out

        setattr(obj, attr, wrapper)
        self._saved.append((obj, attr, original, had))

    def restore(self) -> None:
        for obj, attr, original, had in reversed(self._saved):
            if had:
                setattr(obj, attr, original)
            else:
                delattr(obj, attr)
        self._saved.clear()


def span(name: str):
    """A harness range around a block of the benchmark's own code."""
    return torch.profiler.record_function(PREFIX + name)


@dataclass
class Summary:
    window_s: float
    busy_s: float
    device_s: Dict[str, float] = field(default_factory=dict)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)
    device_events: int = 0


def _inside(starts: List[float], intervals: List[Tuple[float, float]], t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def summarize(trace: dict) -> Summary:
    """Reduce a Chrome trace of ``torch.profiler`` (times in microseconds)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    launch_ts: Dict[int, float] = {}
    device = []
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and name.startswith(PREFIX):
            ranges[name[len(PREFIX):]].append((e["ts"], e["ts"] + e.get("dur", 0.0)))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = e["ts"]
        elif cat in DEVICE_CATS:
            device.append(e)
    if not ranges.get(PROFILED):
        raise ValueError("the trace holds no pb.profiled range")
    t0, t1 = max(ranges.pop(PROFILED), key=lambda r: r[1] - r[0])
    for name in ranges:
        ranges[name].sort()
    starts = {name: [s for s, _ in iv] for name, iv in ranges.items()}

    device_us: Dict[str, float] = defaultdict(float)
    ops_us: Dict[str, float] = defaultdict(float)
    clipped = []
    for e in device:
        a, b = e["ts"], e["ts"] + e.get("dur", 0.0)
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        clipped.append((a, b))
        ops_us[e.get("name", "?")[:160]] += b - a
        launched = launch_ts.get(e.get("args", {}).get("correlation"))
        if launched is None:
            continue
        for name, iv in ranges.items():
            if _inside(starts[name], iv, launched):
                device_us[name] += b - a

    merged: List[List[float]] = []
    for a, b in sorted(clipped):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def host_at(t: float) -> str:
        best, width = "outside", float("inf")
        for name, iv in ranges.items():
            i = bisect.bisect_right(starts[name], t) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1] and iv[i][1] - iv[i][0] < width:
                best, width = name, iv[i][1] - iv[i][0]
        return best

    top_ops = sorted(ops_us.items(), key=lambda kv: -kv[1])[:10]
    return Summary(
        window_s=(t1 - t0) * 1e-6, busy_s=busy * 1e-6,
        device_s={name: us * 1e-6 for name, us in device_us.items()},
        device_ops=[[name, us * 1e-6] for name, us in top_ops],
        idle_gaps=[[host_at((a + b) / 2), (b - a) * 1e-6] for a, b in gaps[:10]],
        device_events=len(clipped),
    )


def profile(fn: Callable[[], None], device) -> Summary:
    """Run ``fn`` under the profiler and reduce its trace."""
    from torch.profiler import ProfilerActivity

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with torch.profiler.profile(activities=activities) as prof:
        with span(PROFILED):
            sync()
            fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="pb-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return summarize(trace)
