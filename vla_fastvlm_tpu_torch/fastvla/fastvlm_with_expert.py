"""FastVLM backbone + action expert head (counterpart of
``vla_fastvlm_tpu/fastvla/fastvlm_with_expert.py``).

``apply_fn(images, input_ids, attention_mask, states, train, generator)`` is
the policy step on device tensors (what the JAX package jits): with
``train=False`` it runs under ``torch.inference_mode()``; with ``train=True``
autograd records it and the head's dropout draws its mask from
``generator``. ``forward(images, states, tasks)`` is the eager API that takes
host inputs (numpy, PIL, lists) or tensors, which stay on their device.

Parameters live in the backbone's ``FastVLM`` module and the head module, on
the backbone's device. ``params`` is the JAX package's split of them,
``{"backbone": {name: parameter}, "head": {...}}``, and
``trainable_params()`` the sub-tree the optimizer updates: the head, or
everything with ``train_backbone`` and not ``freeze_backbone``.

With ``lora_rank > 0`` LoRA adapters (``io/lora.py``, seeded from
``seed + 2``) mount on the decoder's projections: ``params`` and the
trainable sub-tree gain ``"lora"`` (flat names of the adapter tree), which
trains with the head while the base stays frozen, and the JAX layout
carries the JAX package's ``"lora"`` tree. Combined with full backbone
training it raises, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from ..device import DeviceLike, resolve_dtype
from ..io.bridge import flatten_params, jax_params_to_torch, torch_lora_to_jax, torch_params_to_jax
from ..io.lora import init_lora, load_lora_params, lora_parameters
from ..model.fastvlm_adapter import FastVLMBackbone, as_float32
from ..models.action_head import ActionChunkHead, ActionExpertHead
from ..models.layers import init_weights
from ..utils import tracing
from .configuration_fastvla import FastVLAConfig


def check_lora(cfg: FastVLAConfig) -> None:
    if cfg.lora_rank > 0 and cfg.train_backbone and not cfg.freeze_backbone:
        raise ValueError("lora_rank > 0 with full backbone training is contradictory: LoRA exists to avoid "
                         "training the base")


def build_lora(cfg: FastVLAConfig, backbone: FastVLMBackbone) -> Optional[Dict]:
    """The policy's adapter parameters when ``lora_rank > 0``, else None."""
    if cfg.lora_rank <= 0:
        return None
    return lora_parameters(init_lora(backbone.model, cfg.lora_rank, seed=cfg.seed + 2, alpha=cfg.lora_alpha))


def build_head(cfg: FastVLAConfig, feature_dim: int, device) -> torch.nn.Module:
    """The policy's action head on ``device``, uninitialized, in eval mode."""
    head_kwargs = dict(
        feature_dim=feature_dim,
        state_dim=cfg.state_dim,
        action_dim=cfg.action_dim,
        hidden_dim=cfg.hidden_dim,
        fusion_dim=cfg.fusion_dim,
        dropout=cfg.dropout,
        dtype=resolve_dtype(cfg.dtype),
        param_dtype=resolve_dtype(cfg.param_dtype),
    )
    with torch.device(device):
        if cfg.chunk_size > 1:
            head = ActionChunkHead(chunk_size=cfg.chunk_size, **head_kwargs)
        else:
            head = ActionExpertHead(**head_kwargs)
    return head.eval()


def _check_supported(cfg: FastVLAConfig) -> None:
    check_lora(cfg)
    if cfg.action_head != "mlp":
        raise ValueError(f"FastVLMWithExpert is the MLP head's stack, got action_head={cfg.action_head!r}; "
                         "the token head is fastvla.FastVLMTokenPolicy")


class FastVLMWithExpert:
    """FastVLM backbone plus a lightweight MLP action expert head."""

    def __init__(self, config: Optional[FastVLAConfig] = None, device: DeviceLike = None) -> None:
        self.config = config or FastVLAConfig()
        cfg = self.config
        _check_supported(cfg)
        self.backbone = FastVLMBackbone(cfg.to_backbone_config(), device=device)
        self.device = self.backbone.device
        self.head = build_head(cfg, self.backbone.output_dim, self.device)
        if self.device.type != "meta":
            init_weights(self.head, torch.Generator(device=self.device).manual_seed(cfg.seed + 1))
        self.lora = build_lora(cfg, self.backbone)

    def load_jax_params(self, params: Mapping) -> None:
        """Load ``{"backbone": ..., "head": ...[, "lora": ...]}`` from the JAX package (numpy leaves)."""
        self.backbone.load_jax_params(params["backbone"])
        self.head.load_state_dict(jax_params_to_torch(params["head"]), strict=True)
        if "lora" in params:
            self.lora = load_lora_params(self.lora, params["lora"], self.device)

    def jax_params(self, as_numpy: bool = True) -> Dict:
        """The JAX package's ``{"backbone": ..., "head": ...[, "lora": ...]}``
        tree of these parameters (``io/bridge.py``)."""
        scanned = self.backbone.model_config.text.scan_layers
        out = {"backbone": torch_params_to_jax(self.backbone.model, scanned, as_numpy),
               "head": torch_params_to_jax(self.head, scanned, as_numpy)}
        if self.lora is not None:
            out["lora"] = torch_lora_to_jax(self.lora, scanned, as_numpy)
        return out

    @property
    def params(self) -> Dict[str, Dict[str, torch.nn.Parameter]]:
        out = {"backbone": dict(self.backbone.model.named_parameters()),
               "head": dict(self.head.named_parameters())}
        if self.lora is not None:
            out["lora"] = flatten_params(self.lora)
        return out

    def trainable_params(self) -> Dict[str, Dict[str, torch.nn.Parameter]]:
        """The head (with the adapters when mounted), or everything with
        ``train_backbone`` and not ``freeze_backbone``."""
        if self.config.train_backbone and not self.config.freeze_backbone:
            return self.params
        out = {"head": dict(self.head.named_parameters())}
        if self.lora is not None:
            out["lora"] = flatten_params(self.lora)
        return out

    def merge_trainable(self, trainable: Mapping) -> Dict:
        return {**self.params, **trainable}

    def apply_fn(self, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 states: torch.Tensor, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Device tensors -> actions: (B, action_dim), or (B, chunk, action_dim)."""
        if not train:
            with torch.inference_mode():
                feats = self.backbone.features_fn(images, input_ids, attention_mask, lora=self.lora)
                return self.head(feats, states, train=False)
        feats = self.backbone.features_fn(images, input_ids, attention_mask, lora=self.lora)
        return self.head(feats, states, train=True, generator=generator)

    def forward(self, images, states, tasks: List[str], device: DeviceLike = None) -> torch.Tensor:
        self.backbone.check_device(device)
        to = self.backbone.to_device
        with tracing.span("policy.prep.frames"):
            images = self.backbone._as_bchw(images)
            states = as_float32(states)
        with tracing.span("policy.prep.upload"):
            images = to(images)
        with tracing.span("policy.prep.text"):
            ids, mask = self.backbone._prep_text(tasks)
        with tracing.span("policy.prep.upload"):
            ids, mask, states = to(ids), to(mask), to(states)
        return self.apply_fn(images, ids, mask, states)

    __call__ = forward
