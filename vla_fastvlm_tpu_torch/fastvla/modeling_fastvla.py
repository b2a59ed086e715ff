"""FastVLA policy: processor + FastVLMWithExpert + loss/inference API
(counterpart of ``vla_fastvlm_tpu/fastvla/modeling_fastvla.py``).

``forward``, ``select_action``, ``reset``, ``prepare_batch``, ``loss_fn`` and
``compute_loss`` (returning ``{"loss", "mse"}``) as in JAX. The parameters
live in the modules, so ``loss_fn`` takes the batch only where JAX takes
``(trainable, frozen, arrays)``: autograd differentiates what requires grad.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.prefetch import to_device
from ..device import DeviceLike
from ..model.fastvlm_adapter import as_float32
from ..utils import tracing
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

    # ------------------------------------------------------------------
    # parameters (delegated)

    @property
    def params(self) -> Dict:
        return self.model.params

    def load_jax_params(self, params: Mapping) -> None:
        self.model.load_jax_params(params)

    def jax_params(self, as_numpy: bool = True) -> Dict:
        return self.model.jax_params(as_numpy)

    def trainable_params(self) -> Dict:
        return self.model.trainable_params()

    def frozen_params(self) -> Dict:
        trainable = self.trainable_params()
        return {k: v for k, v in self.params.items() if k not in trainable}

    def merge_trainable(self, trainable: Mapping) -> Dict:
        return self.model.merge_trainable(trainable)

    # ------------------------------------------------------------------
    # host-side batch prep

    def prepare_batch(self, batch: Mapping) -> Dict[str, np.ndarray]:
        """Collated batch (images/states/actions/tasks) -> fixed-shape arrays."""
        images = self.processor.prepare_images(batch["images"])
        states = self.processor.prepare_states(batch["states"])
        tasks = self.processor.prepare_tasks(batch["tasks"], batch_size=images.shape[0])
        ids, mask = self.model.backbone._prep_text(tasks)
        out = {"images": images, "states": states, "input_ids": ids, "attention_mask": mask}
        if "actions" in batch:
            actions = as_float32(batch["actions"])
            if self.config.chunk_size == 1 and actions.ndim == 3:
                actions = actions[:, 0]
            out["actions"] = actions
        return out

    # ------------------------------------------------------------------
    # compute

    def loss_fn(self, arrays: Mapping[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """MSE of predicted against target actions, in the predictions' dtype:
        ``(loss, {"loss", "mse"})``. ``arrays`` are device tensors of
        ``prepare_batch``'s keys. ``train`` records the graph and runs the
        head's dropout from ``generator``; without it the step runs under
        ``torch.inference_mode()``."""
        preds = self.model.apply_fn(
            arrays["images"], arrays["input_ids"], arrays["attention_mask"], arrays["states"],
            train=train, generator=generator,
        )
        mse = torch.mean(torch.square(preds - arrays["actions"].to(preds.dtype)))
        return mse, {"loss": mse, "mse": mse}

    def to_device(self, arrays: Mapping) -> Dict:
        """Host arrays -> tensors on the policy's device (strings pass through)."""
        return {k: to_device(v, self.device) for k, v in arrays.items()}

    def compute_loss(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """Regression MSE between predicted actions and targets (no gradient)."""
        _, metrics = self.loss_fn(self.to_device(self.prepare_batch(batch)))
        return metrics

    def forward(self, images, states, tasks: List[str] | str, device: DeviceLike = None) -> torch.Tensor:
        """Compute actions for a batch of observations."""
        with tracing.span("policy.forward"):
            with tracing.span("policy.prep.frames"):
                images = self.processor.prepare_images(images)
                states = self.processor.prepare_states(states)
            with tracing.span("policy.prep.text"):
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
