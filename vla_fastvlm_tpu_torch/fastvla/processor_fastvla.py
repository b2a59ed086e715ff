"""FastVLA processor: task/image/state preparation (counterpart of
``vla_fastvlm_tpu/fastvla/processor_fastvla.py``).

Task broadcast + trailing newline, time-major squeeze (the last step of
``(B, T, ...)``), image layout normalization delegated to the backbone.
Host input stays numpy and tensors stay on their device; the device work
happens in the backbone.
"""

from __future__ import annotations

from typing import List

from ..model.fastvlm_adapter import FastVLMBackbone, as_float32
from .configuration_fastvla import FastVLAConfig


class FastVLAProcessor:
    def __init__(self, config: FastVLAConfig, backbone: FastVLMBackbone) -> None:
        self.config = config
        self.backbone = backbone

    def normalize_tasks(self, tasks: List[str] | str, batch_size: int) -> List[str]:
        if isinstance(tasks, str):
            tasks = [tasks]
        tasks = list(tasks)
        if len(tasks) == 1 and batch_size > 1:
            tasks = [tasks[0] for _ in range(batch_size)]
        if self.config.add_trailing_newline:
            tasks = [task if task.endswith("\n") else f"{task}\n" for task in tasks]
        return tasks

    def prepare_images(self, images):
        images = as_float32(images)
        if self.config.num_cameras > 1:
            if images.ndim == 6:  # (B, T, ncam, C, H, W): keep the latest step
                images = images[:, -1]
        elif images.ndim == 5:  # (B, T, C, H, W): keep the latest step
            images = images[:, -1]
        return self.backbone._as_bchw(images)

    def prepare_states(self, states):
        states = as_float32(states)
        if states.ndim == 3:  # (B, T, D): keep the latest step
            states = states[:, -1]
        return states

    def prepare_tasks(self, tasks: List[str] | str, batch_size: int) -> List[str]:
        return self.normalize_tasks(tasks, batch_size)
