"""FastVLA policy: processor + FastVLMWithExpert + inference API (counterpart
of ``vla_fastvlm_tpu/fastvla/modeling_fastvla.py``).

``forward``, ``select_action`` and ``reset`` are ported; ``compute_loss`` and
the training ``loss_fn`` wait for the training slice.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..device import DeviceLike
from ..model.fastvlm_adapter import as_float32
from .configuration_fastvla import FastVLAConfig
from .fastvlm_with_expert import FastVLMWithExpert
from .processor_fastvla import FastVLAProcessor


class FastVLAPolicy:
    """FastVLM -> VLA policy (config + processor + backbone-with-expert)."""

    config_class = FastVLAConfig
    name = "fastvla"

    def __init__(self, config: Optional[FastVLAConfig] = None, device: DeviceLike = None) -> None:
        self.config = config or FastVLAConfig()
        self.model = FastVLMWithExpert(self.config, device=device)
        self.device = self.model.device
        self.processor = FastVLAProcessor(self.config, self.model.backbone)

    def forward(self, images, states, tasks: List[str] | str, device: DeviceLike = None) -> torch.Tensor:
        """Compute actions for a batch of observations."""
        images = self.processor.prepare_images(images)
        states = self.processor.prepare_states(states)
        tasks = self.processor.prepare_tasks(tasks, batch_size=images.shape[0])
        return self.model.forward(images, states, tasks, device=device)

    def select_action(self, image, state, task: str, device: DeviceLike = None) -> torch.Tensor:
        """Produce a single action for inference scenarios."""
        image_batch = as_float32(image)[None]
        state_batch = as_float32(state)[None]
        tasks = self.processor.prepare_tasks(task, batch_size=1)
        return self.forward(image_batch, state_batch, tasks, device=device)[0]

    def reset(self) -> None:
        """Included for API compatibility."""
        return
