"""FastVLM backbone adapter: images + task strings -> pooled features
(counterpart of ``vla_fastvlm_tpu/model/fastvlm_adapter.py``).

Same public surface: ``FastVLMBackboneConfig``, ``prepare_policy_images``,
``FastVLMBackbone.forward(images, tasks, device) -> (B, H)``. The backbone
owns a ``FastVLM`` module on one device (the card unless ``device="cpu"`` is
passed), its tokenizer, and the host-side input normalization. Its forward
runs under ``torch.inference_mode()``, which is the port's form of the JAX
``stop_gradient`` on the pooled features (the reference backbone is
``@torch.no_grad()``).

Weights are random from ``seed`` (presets only); ``load_jax_params`` takes
the JAX package's parameters through the weight bridge.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, resolve_dtype, same_device
from ..io.bridge import jax_params_to_torch
from ..io.presets import resolve_fastvlm_config
from ..io.tokenizer import load_tokenizer
from ..models.fastvlm import FastVLM, pool_hidden, pool_last_text_token
from ..models.layers import init_weights
from ..ops.image import prepare_image_batch, resize_with_pad  # noqa: F401  (re-export)

logger = logging.getLogger(__name__)


@dataclass
class FastVLMBackboneConfig:
    """Same fields as the JAX package's config."""

    model_id: str = "apple/FastVLM-0.5B"
    bootstrap_model_id: str = "apple/FastVLM-0.5B"
    freeze_backbone: bool = True
    image_feature_pool: str = "last_token"  # "last_token" | "mean_pool"
    fallback_image_size: int = 512
    force_image_size: Optional[int] = None
    normalize_imagenet: bool = False
    resize_with_padding: bool = True
    pad_value: float = 0.0
    tokenizer_max_length: int = 64
    pad_to_max_length: bool = False
    tokenizer_padding_side: str = "right"
    image_key_order: Tuple[str, ...] = ("images", "pixel_values", "pixel_values_vit")
    image_token_mode: str = "prefix"
    dtype: str = "float32"
    param_dtype: str = "float32"
    attention_impl: str = "auto"  # "auto" | "flash" | "xla"
    vision_block_impl: str = "auto"  # "auto" | "fused" | "xla"
    fused_projections: bool = True
    quantization: str = "none"
    kv_cache_quantization: str = "none"
    gradient_checkpointing: bool = False
    train_backbone: bool = False
    fabricate_params: bool = False
    num_cameras: int = 1
    seed: int = 0


def _check_supported(cfg: FastVLMBackboneConfig) -> None:
    unported = {
        "quantization": cfg.quantization != "none",
        "kv_cache_quantization": cfg.kv_cache_quantization != "none",
        "train_backbone": cfg.train_backbone,
        "gradient_checkpointing": cfg.gradient_checkpointing,
    }
    named = [k for k, on in unported.items() if on]
    if named:
        raise NotImplementedError(
            f"{', '.join(named)}: not ported to PyTorch yet (the port serves the "
            "frozen-backbone forward)"
        )


def as_float32(x):
    """float32 view of host or device input: numpy for host input (lists,
    PIL, numpy), a tensor on its own device for a tensor or a list of them."""
    if isinstance(x, (list, tuple)) and x and all(isinstance(e, torch.Tensor) for e in x):
        x = torch.stack(list(x))
    if isinstance(x, torch.Tensor):
        return x.detach().float()
    return np.asarray(x, dtype=np.float32)


def _permute(x, axes):
    return x.permute(*axes) if isinstance(x, torch.Tensor) else np.transpose(x, axes)


def prepare_policy_images(images: torch.Tensor, mcfg, cfg: FastVLMBackboneConfig):
    """(B, 3, H, W) -- or (B, ncam, 3, H, W) -- float in [0,1] -> the letterboxed,
    normalized batch at the tower resolution in the model dtype; ``None`` for
    text-only configs. Runs on the tensor's device."""
    if mcfg.num_image_tokens == 0:
        return None
    prep = lambda x: prepare_image_batch(
        x,
        size=mcfg.image_size,
        resize_with_padding=cfg.resize_with_padding,
        pad_value=cfg.pad_value,
        normalize=cfg.normalize_imagenet,
        dtype=mcfg.text.dtype,
    )
    if mcfg.num_cameras > 1:
        b, ncam = images.shape[:2]
        folded = prep(images.reshape((b * ncam,) + tuple(images.shape[2:])))
        return folded.reshape((b, ncam) + tuple(folded.shape[1:]))
    return prep(images)


class FastVLMBackbone:
    """Host-side wrapper owning the FastVLM module, its device and tokenizer."""

    def __init__(self, config: Optional[FastVLMBackboneConfig] = None, device: DeviceLike = None) -> None:
        self.config = config or FastVLMBackboneConfig()
        cfg = self.config
        _check_supported(cfg)
        self.device = resolve_device(device)
        self.model_config, self._raw_hf_config = resolve_fastvlm_config(
            cfg.model_id,
            bootstrap_model_id=cfg.bootstrap_model_id,
            dtype=resolve_dtype(cfg.dtype),
            param_dtype=resolve_dtype(cfg.param_dtype),
            image_token_mode=cfg.image_token_mode,
        )
        self.expected_size = self._resolve_expected_image_size()
        self.model_config = self.model_config.replace(
            image_size=int(self.expected_size),
            num_cameras=int(cfg.num_cameras),
            text=self.model_config.text.replace(
                attention_impl=cfg.attention_impl,
                fused_projections=cfg.fused_projections,
            ),
            vision=self.model_config.vision.replace(block_impl=cfg.vision_block_impl),
        )
        with torch.device(self.device):
            self.model = FastVLM(self.model_config)
        self.model.eval().requires_grad_(False)
        if self.device.type != "meta":
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
            init_weights(self.model, generator)
        self.tokenizer = load_tokenizer(cfg.model_id, padding_side=cfg.tokenizer_padding_side)
        self.output_dim = int(self.model_config.text.hidden_size)
        logger.info("[FastVLMBackbone] expected (S,S) = (%d,%d) on %s",
                    self.expected_size, self.expected_size, self.device)

    def _resolve_expected_image_size(self) -> int:
        """Preset chain: ``force_image_size`` when set, else the preset's size."""
        if self.config.force_image_size is not None:
            return int(self.config.force_image_size)
        return int(self.model_config.image_size)

    def load_jax_params(self, params: Mapping) -> None:
        """Load the JAX package's FastVLM parameters (numpy leaves)."""
        self.model.load_state_dict(jax_params_to_torch(params), strict=True)

    # ------------------------------------------------------------------
    # host-side inputs

    def _prep_text(self, tasks: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenize tasks to static (B, tokenizer_max_length) int32 ids + mask."""
        batch = self.tokenizer(
            tasks, padding="max_length", truncation=True,
            max_length=self.config.tokenizer_max_length,
        )
        return batch.input_ids, batch.attention_mask

    def _as_bchw(self, images):
        """PIL / numpy / torch (BCHW/BHWC/CHW/HWC/lists) -> float32 BCHW.

        Host input becomes numpy; a tensor stays a tensor on its own device,
        so images already on the card are not copied through the host.
        """

        def one_to_chw(x):
            arr = as_float32(x)
            if arr.ndim == 3:
                if arr.shape[0] in (1, 3):
                    return arr
                if arr.shape[-1] in (1, 3):
                    return _permute(arr, (2, 0, 1))
                raise ValueError(f"Unsupported array shape: {tuple(arr.shape)}")
            if arr.ndim == 2:
                return arr[None]
            raise ValueError(f"Unsupported tensor shape: {tuple(arr.shape)}")

        if isinstance(images, (list, tuple)):
            chw = [one_to_chw(img) for img in images]
            if all(isinstance(c, torch.Tensor) for c in chw):
                return torch.stack(chw)
            return np.stack([c.cpu().numpy() if isinstance(c, torch.Tensor) else c for c in chw])
        arr = as_float32(images)
        if arr.ndim == 5:  # (B, ncam, C, H, W) multi-camera batch
            if arr.shape[-1] in (1, 3) and arr.shape[2] not in (1, 3):
                arr = _permute(arr, (0, 1, 4, 2, 3))
            return arr
        if arr.ndim == 4:
            if arr.shape[-1] in (1, 3) and arr.shape[1] not in (1, 3):
                arr = _permute(arr, (0, 3, 1, 2))
            return arr
        return one_to_chw(arr)[None]

    # ------------------------------------------------------------------
    # forward

    def features_fn(self, images: torch.Tensor, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        """Device tensors -> (B, H) pooled features, gradient-free."""
        cfg = self.config
        with torch.inference_mode():
            prepared = prepare_policy_images(images, self.model_config, cfg)
            hidden, _, text_mask = self.model(prepared, input_ids, attention_mask)
            if cfg.image_feature_pool == "mean_pool":
                return pool_hidden(hidden, text_mask, "mean_pool")
            return pool_last_text_token(hidden, text_mask)

    def to_device(self, array) -> torch.Tensor:
        return torch.as_tensor(array).to(self.device, non_blocking=True)

    def check_device(self, device: DeviceLike) -> None:
        """A ``device`` passed to forward must name the one the model lives on."""
        if device is not None and not same_device(self.device, torch.device(device)):
            raise ValueError(f"model lives on {self.device}, forward was asked for {device}")

    def forward(self, images, tasks: List[str], device: DeviceLike = None) -> torch.Tensor:
        """(images, task strings) -> (B, H) pooled features."""
        self.check_device(device)
        img = self.to_device(self._as_bchw(images))
        ids, mask = self._prep_text(tasks)
        return self.features_fn(img, self.to_device(ids), self.to_device(mask))

    __call__ = forward

    def backbone(self, images, tasks, device=None, **kwargs):
        """Compat with the older call style ``backbone(images, tasks, device=...)``."""
        return self.forward(images, tasks, device=device)
