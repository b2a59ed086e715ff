"""Legacy FastVLM policy, the first-generation stack (counterpart of
``vla_fastvlm_tpu/model/policy.py``).

The same config (a nested ``backbone: FastVLMBackboneConfig``), head and
surface as in JAX: ``forward`` / ``compute_loss`` / ``select_action`` /
``reset``. The checkpoint loader builds it for configs without a
``vlm_model_name`` key (``io/checkpoint.py``).

The policy runs where its backbone lives: the card unless ``device="cpu"``
is passed. The head computes in the backbone's text dtype, its weights
random from ``backbone.seed + 1`` through an explicit ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

import torch

from ..device import DeviceLike
from ..io.bridge import jax_params_to_torch, torch_params_to_jax
from ..models.action_head import ActionExpertHead
from ..models.layers import init_weights
from ..utils import tracing
from .fastvlm_adapter import FastVLMBackbone, FastVLMBackboneConfig, as_float32


@dataclass
class FastVLMPolicyConfig:
    backbone: FastVLMBackboneConfig = field(default_factory=FastVLMBackboneConfig)
    state_dim: int = 14
    action_dim: int = 14
    hidden_dim: int = 1024
    fusion_dim: int = 1024
    dropout: float = 0.1
    freeze_backbone: bool = True


class FastVLMPolicy:
    """Vision-Language-Action policy composed of FastVLM backbone + action head."""

    def __init__(self, config: Optional[FastVLMPolicyConfig] = None, device: DeviceLike = None) -> None:
        self.config = config or FastVLMPolicyConfig()
        cfg = self.config
        self.backbone = FastVLMBackbone(cfg.backbone, device=device)
        self.device = self.backbone.device
        text = self.backbone.model_config.text
        with torch.device(self.device):
            self.head = ActionExpertHead(
                feature_dim=self.backbone.output_dim,
                state_dim=cfg.state_dim,
                action_dim=cfg.action_dim,
                hidden_dim=cfg.hidden_dim,
                fusion_dim=cfg.fusion_dim,
                dropout=cfg.dropout,
                dtype=text.dtype,
                param_dtype=text.param_dtype,
            )
        self.head.eval()
        if self.device.type != "meta":
            init_weights(self.head, torch.Generator(device=self.device).manual_seed(cfg.backbone.seed + 1))

    # ------------------------------------------------------------------
    # parameters

    @property
    def params(self) -> Dict[str, Dict[str, torch.nn.Parameter]]:
        return {"backbone": dict(self.backbone.model.named_parameters()),
                "head": dict(self.head.named_parameters())}

    def load_jax_params(self, params: Mapping) -> None:
        """Load ``{"backbone": ..., "head": ...}`` from the JAX package (numpy leaves)."""
        self.backbone.load_jax_params(params["backbone"])
        self.head.load_state_dict(jax_params_to_torch(params["head"]), strict=True)

    def jax_params(self, as_numpy: bool = True) -> Dict:
        """The JAX package's ``{"backbone": ..., "head": ...}`` tree of these parameters."""
        scanned = self.backbone.model_config.text.scan_layers
        return {"backbone": torch_params_to_jax(self.backbone.model, scanned, as_numpy),
                "head": torch_params_to_jax(self.head, scanned, as_numpy)}

    # ------------------------------------------------------------------
    # compute

    def apply_fn(self, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 states: torch.Tensor) -> torch.Tensor:
        """Device tensors -> (B, action_dim) actions, deterministic, no graph."""
        with torch.inference_mode():
            feats = self.backbone.features_fn(images, input_ids, attention_mask)
            return self.head(feats, states, train=False)

    def _normalize_tasks(self, tasks: List[str] | str, batch_size: int) -> List[str]:
        """Broadcast a single task string and force a trailing newline."""
        if isinstance(tasks, str):
            tasks = [tasks]
        tasks = list(tasks)
        if len(tasks) == 1 and batch_size > 1:
            tasks = [tasks[0] for _ in range(batch_size)]
        return [task if task.endswith("\n") else f"{task}\n" for task in tasks]

    def forward(self, images, states, tasks: List[str] | str, device: DeviceLike = None) -> torch.Tensor:
        """(B, C, H, W) images -- or (B, T, C, H, W), the last step kept --
        states (B, D) or (B, T, D) and tasks -> (B, action_dim) actions.
        Host input stays numpy until the copy; tensors stay on their device."""
        self.backbone.check_device(device)
        with tracing.span("policy.forward"):
            with tracing.span("policy.prep.frames"):
                images = as_float32(images)
                if images.ndim == 5:
                    images = images[:, -1]
                if images.ndim != 4:
                    raise ValueError(f"Expected images to be (B,C,H,W) got {tuple(images.shape)}")
                states = as_float32(states)
                if states.ndim == 3:
                    states = states[:, -1]
                images = self.backbone._as_bchw(images)
            with tracing.span("policy.prep.text"):
                tasks = self._normalize_tasks(tasks, batch_size=images.shape[0])
                ids, mask = self.backbone._prep_text(tasks)
            to = self.backbone.to_device
            with tracing.span("policy.prep.upload"):
                arrays = to(images), to(ids), to(mask), to(states)
            return self.apply_fn(*arrays)

    __call__ = forward

    def compute_loss(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """Regression MSE of a batch, in the predictions' dtype: ``{"loss", "mse"}``."""
        predictions = self.forward(batch["images"], batch["states"], batch["tasks"])
        actions = self.backbone.to_device(as_float32(batch["actions"]))
        mse = torch.mean(torch.square(predictions - actions.to(predictions.dtype)))
        return {"loss": mse, "mse": mse}

    def select_action(self, image, state, task: str, device: DeviceLike = None) -> torch.Tensor:
        """Produce a single action for inference scenarios."""
        image_batch = as_float32(image)[None]
        state_batch = as_float32(state)[None]
        tasks = self._normalize_tasks(task, batch_size=1)
        return self.forward(image_batch, state_batch, tasks, device=device)[0]

    def reset(self) -> None:
        """Provided for API compatibility with LeRobot."""
        return
