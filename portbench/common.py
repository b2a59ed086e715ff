"""Small pieces every traffic kind uses: sub-seeds, statistics, the window's
record and the loop that fills it."""

from __future__ import annotations

import hashlib
import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one stream of the run (inputs, sampling ...)."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}/{what}".encode()).digest()[:8], "little") & (2 ** 63 - 1)


def rng(seed: int, what: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, what))


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value with at least
    95% of the values at or below it."""
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


@dataclass
class Window:
    """What the measured window gave: its seconds, the end-to-end metrics by
    name, requests attempted and failed, host seconds by label, and the
    units it ran (ticks, admission cycles or steps: the profiled segment's
    unit)."""

    seconds: float = 0.0
    metrics: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    host_s: Dict[str, List[float]] = field(default_factory=dict)
    flops: float = 0.0
    units: int = 0


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_loop(seconds: float, step: Callable[[int], bool]) -> float:
    """Call ``step(i)`` for i = 0, 1, ... until ``seconds`` have passed and
    ``step`` returned True (a boundary where the window may close); returns
    the window's seconds."""
    t0 = time.perf_counter()
    i = 0
    while True:
        at_boundary = step(i)
        i += 1
        if at_boundary and time.perf_counter() - t0 >= seconds:
            return time.perf_counter() - t0
