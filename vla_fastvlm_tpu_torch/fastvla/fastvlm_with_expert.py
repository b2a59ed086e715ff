"""FastVLM backbone + action expert head (counterpart of
``vla_fastvlm_tpu/fastvla/fastvlm_with_expert.py``).

``apply_fn(images, input_ids, attention_mask, states)`` is the policy step on
device tensors (what the JAX package jits); ``forward(images, states, tasks)``
is the eager API that takes host inputs (numpy, PIL, lists) or tensors, which
stay on their device. Parameters live in the backbone's
``FastVLM`` module and the head module, on the backbone's device.
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import torch

from ..device import DeviceLike, resolve_dtype
from ..io.bridge import jax_params_to_torch
from ..model.fastvlm_adapter import FastVLMBackbone, as_float32
from ..models.action_head import ActionChunkHead, ActionExpertHead
from ..models.layers import init_weights
from .configuration_fastvla import FastVLAConfig


def _check_supported(cfg: FastVLAConfig) -> None:
    if cfg.lora_rank > 0:
        raise NotImplementedError("LoRA adapters are not ported to PyTorch yet")
    if cfg.action_head != "mlp":
        raise NotImplementedError(f"action_head={cfg.action_head!r} is not ported to PyTorch yet")


class FastVLMWithExpert:
    """FastVLM backbone plus a lightweight MLP action expert head."""

    def __init__(self, config: Optional[FastVLAConfig] = None, device: DeviceLike = None) -> None:
        self.config = config or FastVLAConfig()
        cfg = self.config
        _check_supported(cfg)
        self.backbone = FastVLMBackbone(cfg.to_backbone_config(), device=device)
        self.device = self.backbone.device
        head_kwargs = dict(
            feature_dim=self.backbone.output_dim,
            state_dim=cfg.state_dim,
            action_dim=cfg.action_dim,
            hidden_dim=cfg.hidden_dim,
            fusion_dim=cfg.fusion_dim,
            dropout=cfg.dropout,
            dtype=resolve_dtype(cfg.dtype),
            param_dtype=resolve_dtype(cfg.param_dtype),
        )
        with torch.device(self.device):
            if cfg.chunk_size > 1:
                self.head = ActionChunkHead(chunk_size=cfg.chunk_size, **head_kwargs)
            else:
                self.head = ActionExpertHead(**head_kwargs)
        self.head.eval().requires_grad_(False)
        if self.device.type != "meta":
            init_weights(self.head, torch.Generator(device=self.device).manual_seed(cfg.seed + 1))

    def load_jax_params(self, params: Mapping) -> None:
        """Load ``{"backbone": ..., "head": ...}`` from the JAX package (numpy leaves)."""
        self.backbone.load_jax_params(params["backbone"])
        self.head.load_state_dict(jax_params_to_torch(params["head"]), strict=True)

    def apply_fn(self, images: torch.Tensor, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor, states: torch.Tensor) -> torch.Tensor:
        """Device tensors -> actions: (B, action_dim), or (B, chunk, action_dim)."""
        feats = self.backbone.features_fn(images, input_ids, attention_mask)
        with torch.inference_mode():
            return self.head(feats, states)

    def forward(self, images, states, tasks: List[str], device: DeviceLike = None) -> torch.Tensor:
        self.backbone.check_device(device)
        to = self.backbone.to_device
        images = to(self.backbone._as_bchw(images))
        ids, mask = self.backbone._prep_text(tasks)
        states = to(as_float32(states))
        return self.apply_fn(images, to(ids), to(mask), states)

    __call__ = forward
