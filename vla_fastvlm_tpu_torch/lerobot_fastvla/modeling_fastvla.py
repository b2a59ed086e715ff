"""LeRobot policy over the port's ``FastVLMWithExpert`` (counterpart of
``vla_fastvlm_tpu/lerobot_fastvla/modeling_fastvla.py``).

``PreTrainedPolicy`` subclass named "fastvla", with the JAX plugin's key
resolution from ``input_features``, dimension inference, action queue
(``select_action`` / ``predict_action_chunk``) and training
``forward(batch) -> (loss, {"loss", "mse"})``.

Native torch: the backbone's ``FastVLM`` and the action head are this
module's submodules (``vlm``, ``head``), so ``state_dict()`` holds the real
module tree. As in the JAX plugin only the head trains: the backbone is
frozen (``requires_grad=False``) and runs without a graph, and
``get_optim_params()`` yields the head's parameters; the loss's graph
starts at the head. The head runs deterministically, as the JAX plugin's
loss does, whatever ``train()`` / ``eval()`` say. The policy lives on
``config.device``, the card when that is ``None``.

One deviation from the JAX plugin: with ``chunk_size`` above 1 the target
chunk is kept whole (JAX takes its first step, which does not broadcast
against the predicted chunk); at chunk 1 both take ``actions[:, 0]``.
"""

from __future__ import annotations

from collections import deque
from typing import Any

import torch
from torch import Tensor

from lerobot.configs.types import FeatureType
from lerobot.policies.pretrained import PreTrainedPolicy
from lerobot.utils.constants import ACTION

from ..fastvla.configuration_fastvla import FastVLAConfig as CoreFastVLAConfig
from ..fastvla.fastvlm_with_expert import FastVLMWithExpert
from .configuration_fastvla import FastVLAConfig


class FastVLAPolicy(PreTrainedPolicy):
    """LeRobot policy wrapper for the port's FastVLMWithExpert."""

    config_class = FastVLAConfig
    name = "fastvla"

    def __init__(self, config: FastVLAConfig, **kwargs: Any):
        super().__init__(config)
        config.validate_features()
        self.config = config

        self._state_key, self._image_keys = self._resolve_input_keys()
        self._infer_io_dims_from_features()

        core_cfg = CoreFastVLAConfig(
            vlm_model_name=config.vlm_model_name,
            bootstrap_model_name=config.bootstrap_model_name,
            state_dim=config.state_dim,
            action_dim=config.action_dim,
            hidden_dim=config.hidden_dim,
            fusion_dim=config.fusion_dim,
            dropout=config.dropout,
            freeze_backbone=config.freeze_backbone,
            tokenizer_max_length=config.tokenizer_max_length,
            tokenizer_padding_side=config.tokenizer_padding_side,
            pad_to_max_length=config.pad_to_max_length,
            resize_with_padding=config.resize_with_padding,
            image_size=config.image_size,
            pad_value=config.pad_value,
            add_trailing_newline=config.add_trailing_newline,
            image_token_mode=config.image_token_mode,
            dtype=config.jax_dtype,
            chunk_size=config.chunk_size,
        )
        self.model = FastVLMWithExpert(core_cfg, device=config.device)
        self.device = self.model.device
        self.vlm = self.model.backbone.model.requires_grad_(False)
        self.head = self.model.head
        self.reset()

    # ------------------------------------------------------------------

    def _resolve_input_keys(self) -> tuple[str, list[str]]:
        if not self.config.input_features:
            raise ValueError("FastVLA requires input_features to be set.")
        state_keys = [key for key, ft in self.config.input_features.items() if ft.type is FeatureType.STATE]
        image_keys = [key for key, ft in self.config.input_features.items() if ft.type is FeatureType.VISUAL]
        if not state_keys:
            raise ValueError("No state feature found in input_features.")
        if not image_keys:
            raise ValueError("No visual feature found in input_features.")
        return state_keys[0], image_keys

    def _infer_io_dims_from_features(self) -> None:
        if self.config.input_features and self._state_key in self.config.input_features:
            self.config.state_dim = self.config.input_features[self._state_key].shape[0]
        if self.config.action_feature is not None:
            self.config.action_dim = self.config.action_feature.shape[0]

    def get_optim_params(self):
        return self.head.parameters()

    def reset(self):
        self._action_queue: deque[Tensor] = deque([], maxlen=self.config.n_action_steps)

    # ------------------------------------------------------------------

    def _prepare_inputs(self, batch: dict[str, Tensor]):
        images = batch[self._image_keys[0]]
        if images.ndim == 5:
            images = images[:, -1]
        states = batch[self._state_key]
        if states.ndim == 3:
            states = states[:, -1]

        task = batch.get("task")
        batch_size = images.shape[0]
        if task is None:
            tasks = [""] * batch_size
        elif isinstance(task, str):
            tasks = [task] * batch_size
        elif isinstance(task, (list, tuple)):
            tasks = [str(t) for t in task]
            if len(tasks) == 1 and batch_size > 1:
                tasks = tasks * batch_size
        else:
            tasks = [str(task)] * batch_size

        if self.config.add_trailing_newline:
            tasks = [t if t.endswith("\n") else f"{t}\n" for t in tasks]
        return images, states, tasks

    def _arrays_from_batch(self, batch: dict[str, Tensor], with_actions: bool) -> dict[str, Tensor]:
        """The batch as device tensors: images (B, C, H, W), float states,
        token ids and mask, and the target actions."""
        images, states, tasks = self._prepare_inputs(batch)
        backbone = self.model.backbone
        ids, mask = backbone._prep_text(tasks)
        to = backbone.to_device
        arrays = {
            "images": to(backbone._as_bchw(images.detach())),
            "states": to(states.detach().float()),
            "input_ids": to(ids),
            "attention_mask": to(mask),
        }
        if with_actions:
            gt = batch[ACTION]
            if gt.ndim == 3 and self.config.chunk_size == 1:
                gt = gt[:, 0]
            arrays["actions"] = to(gt.detach().float())
        return arrays

    def _actions(self, arrays: dict[str, Tensor]) -> Tensor:
        """The head's actions on the frozen backbone's features: the
        backbone records no graph; the head does where grad is enabled."""
        feats = self.model.backbone.features_fn(arrays["images"], arrays["input_ids"], arrays["attention_mask"])
        return self.head(feats, arrays["states"], train=False)

    @torch.no_grad()
    def predict_action_chunk(self, batch: dict[str, Tensor]) -> Tensor:
        self.eval()
        actions = self._actions(self._arrays_from_batch(batch, with_actions=False)).float()
        if actions.ndim == 2:
            actions = actions.unsqueeze(1)  # [B, chunk=1, D]
        return actions

    @torch.no_grad()
    def select_action(self, batch: dict[str, Tensor]) -> Tensor:
        self.eval()
        if len(self._action_queue) == 0:
            chunk = self.predict_action_chunk(batch)[:, : self.config.n_action_steps]
            self._action_queue.extend(chunk.transpose(0, 1))
        return self._action_queue.popleft()

    def forward(self, batch: dict[str, Tensor]) -> tuple[Tensor, dict]:
        arrays = self._arrays_from_batch(batch, with_actions=True)
        preds = self._actions(arrays)
        loss = torch.mean(torch.square(preds - arrays["actions"].to(preds.dtype))).float()
        value = loss.item()
        return loss, {"loss": value, "mse": value}
