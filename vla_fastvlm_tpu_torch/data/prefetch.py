"""Device prefetching: overlap host->device copies with the step on the card
(counterpart of ``vla_fastvlm_tpu/data/prefetch.py``).

``device_prefetch`` wraps a host batch iterator and keeps ``size`` batches
already submitted to the device: numpy arrays and CPU tensors are pinned and
copied with ``.to(device, non_blocking=True)``, so the copy runs while the
previous step computes; task strings and metadata pass through untouched.
On a mesh the trainer's placer is ``parallel/sharding.py::shard_batch``:
each rank submits its ``data`` rows.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch


def to_device(value, device: torch.device):
    """An array or tensor -> a tensor on ``device`` (pinned, non-blocking
    from host memory to the card); anything else unchanged."""
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    if not isinstance(value, torch.Tensor):
        return value
    if device.type == "cuda" and value.device.type == "cpu":
        value = value.pin_memory()
    return value.to(device, non_blocking=True)


def device_prefetch(
    iterator: Iterable[Dict[str, Any]],
    size: int = 2,
    placer: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
    device: Optional[torch.device] = None,
) -> Iterator[Dict[str, Any]]:
    """Yield batches with up to ``size`` already submitted to the device.

    ``placer`` maps a host batch to device tensors; by default every array
    goes to ``device`` through ``to_device``.
    """
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    if placer is None:
        if device is None:
            raise ValueError("device_prefetch needs a placer or a device")

        def placer(batch):
            return {key: to_device(value, device) for key, value in batch.items()}

    queue: collections.deque = collections.deque()
    it = iter(iterator)

    def fill():
        while len(queue) < size:
            try:
                batch = next(it)
            except StopIteration:
                return
            queue.append(placer(batch))

    fill()
    while queue:
        yield queue.popleft()
        fill()
