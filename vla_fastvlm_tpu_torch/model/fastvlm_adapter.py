"""FastVLM backbone adapter: images + task strings -> pooled features
(counterpart of ``vla_fastvlm_tpu/model/fastvlm_adapter.py``).

Same public surface: ``FastVLMBackboneConfig``, ``prepare_policy_images``,
``FastVLMBackbone.forward(images, tasks, device) -> (B, H)``. The backbone
owns a ``FastVLM`` module on one device (the card unless ``device="cpu"`` is
passed), its tokenizer, and the host-side input normalization.

Gradients, as in JAX: ``features_fn`` runs under ``torch.no_grad()`` unless
``train_backbone`` or LoRA adapters are mounted (the JAX ``stop_gradient``
on the pooled features; the reference backbone is ``@torch.no_grad()``).
With adapters the graph reaches them through the frozen decoder; the base
does not require gradients and the images do not, so the vision tower
records no graph and runs no backward. With ``train_backbone`` the
graph is recorded, the backbone's parameters take gradients when
``freeze_backbone`` is off, and ``gradient_checkpointing`` rematerializes
the decoder blocks. The eager ``forward`` runs under
``torch.inference_mode()``.

Weights are made in JAX's order (``_load_or_init_params``): random from
``seed``; then, for a ``model_id`` that names a local HF-layout directory
(its ``config.json`` resolved by ``io/presets.py``, the image size by JAX's
priority chain), the converted leaves of its ``*.safetensors``
(``io/model_loader.py``) copied over the init on the backbone's device in
the model's dtype, so a partial checkpoint still runs; with no shards the
weights stay random, with JAX's warning; ``fabricate_params`` keeps the
seeded init. Then ``quantization`` ("int8", "int4", "w8a8") quantizes the
decoder's projections on the model's device (``io/quantize.py``; JAX
quantizes after load, int4 on the host), and refuses ``train_backbone``;
the quantized backbone loads a JAX tree quantized the same way. LoRA
adapters come last, mounted by the policies. ``load_seconds`` holds the
directory load's parts: "read", "decoder", "fold" and "copy" (to the
device).
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.prefetch import to_device
from ..device import DeviceLike, resolve_device, resolve_dtype, same_device
from ..io.bridge import jax_params_to_torch
from ..io.model_loader import load_fastvlm_params
from ..io.presets import infer_size_from_tower_name, resolve_fastvlm_config
from ..io.quantize import quantize_params
from ..io.tokenizer import load_tokenizer
from ..models.fastvlm import FastVLM, pool_hidden, pool_last_text_token
from ..models.layers import init_weights
from ..ops.image import prepare_image_batch, resize_with_pad  # noqa: F401  (re-export)
from ..utils import tracing

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
    if cfg.kv_cache_quantization not in ("none", "int8"):
        raise ValueError(f"unknown kv_cache_quantization {cfg.kv_cache_quantization!r}")
    if cfg.quantization != "none" and cfg.train_backbone:
        raise ValueError("quantization is inference-only: incompatible with train_backbone=True")


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
        declared_size, tower_name = self._resolve_declared_tower_size()
        if declared_size is not None and cfg.force_image_size is not None and self.expected_size < declared_size:
            raise ValueError(
                "Configured image_size is too small for this FastVLM vision tower. "
                f"force_image_size={self.expected_size}, tower={tower_name}, "
                f"required>={declared_size}. Set image_size to the declared tower "
                "size (e.g. 1024) or leave it unset (None) for auto-detection."
            )
        self.model_config = self.model_config.replace(
            image_size=int(self.expected_size),
            num_cameras=int(cfg.num_cameras),
            text=self.model_config.text.replace(
                attention_impl=cfg.attention_impl,
                remat=cfg.gradient_checkpointing,
                fused_projections=cfg.fused_projections,
                quantization=cfg.quantization,
                kv_cache_quantization=cfg.kv_cache_quantization,
            ),
            vision=self.model_config.vision.replace(block_impl=cfg.vision_block_impl),
        )
        with torch.device(self.device):
            self.model = FastVLM(self.model_config)
        self.model.eval().requires_grad_(cfg.train_backbone and not cfg.freeze_backbone)
        self.load_seconds: dict = {}
        if self.device.type != "meta":
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
            init_weights(self.model, generator)
            if Path(cfg.model_id).is_dir() and not cfg.fabricate_params:
                self._overlay_directory_weights(cfg.model_id)
        if cfg.quantization != "none":
            # On the model's device, projection by projection: the card holds
            # the float 7B, and each float weight goes once it is replaced.
            quantize_params(self.model, mode=cfg.quantization)
        self.tokenizer = load_tokenizer(cfg.model_id, padding_side=cfg.tokenizer_padding_side)
        self.output_dim = int(self.model_config.text.hidden_size)
        logger.info("[FastVLMBackbone] expected (S,S) = (%d,%d) on %s",
                    self.expected_size, self.expected_size, self.device)

    def _overlay_directory_weights(self, model_dir: str) -> None:
        """The directory's converted weights over the seeded init, copied
        leaf by leaf onto the model's device and dtype."""
        params = load_fastvlm_params(model_dir, self.model_config, dtype=self.model_config.text.param_dtype,
                                     timings=self.load_seconds)
        if params is None:
            return
        t0 = time.perf_counter()
        unexpected = self.model.load_state_dict(params, strict=False).unexpected_keys
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_seconds["copy"] = time.perf_counter() - t0
        if unexpected:
            raise KeyError(f"{model_dir}: converted names the model does not hold: {unexpected[:5]}")
        logger.info("[FastVLMBackbone] loaded %d tensors from %s (seconds: %s)", len(params), model_dir,
                    {k: round(v, 3) for k, v in self.load_seconds.items()})

    def _resolve_expected_image_size(self) -> int:
        """JAX's priority chain: ``force_image_size``; then the directory's
        ``vision_config.image_size``, the tower name's size, its
        ``preprocessor_config.json``; the preset's own size; else
        ``fallback_image_size``."""
        cfg = self.config
        if cfg.force_image_size is not None:
            return int(cfg.force_image_size)
        raw = self._raw_hf_config or {}
        img_size = (raw.get("vision_config") or {}).get("image_size")
        if isinstance(img_size, (int, float)):
            return int(img_size)
        if isinstance(img_size, (tuple, list)) and len(img_size) > 0:
            return int(img_size[0])
        tower_size, _ = self._resolve_declared_tower_size()
        if tower_size is not None:
            return int(tower_size)
        proc_size = self._resolve_processor_size()
        if proc_size is not None:
            return int(proc_size)
        if self._raw_hf_config is None:
            return int(self.model_config.image_size)
        return int(cfg.fallback_image_size)

    def _resolve_processor_size(self) -> Optional[int]:
        proc_path = Path(self.config.model_id) / "preprocessor_config.json"
        if not proc_path.is_file():
            return None
        try:
            with open(proc_path, encoding="utf-8") as f:
                size = json.load(f).get("size")
        except (OSError, ValueError, AttributeError):
            return None
        if isinstance(size, dict):
            h = size.get("height") or size.get("shortest_edge") or size.get("max_height")
            if isinstance(h, (int, float)):
                return int(h)
        if isinstance(size, (int, float)):
            return int(size)
        return None

    def _resolve_declared_tower_size(self) -> Tuple[Optional[int], Optional[str]]:
        raw = self._raw_hf_config or {}
        vision_cfg = raw.get("vision_config") or {}
        for tower_name in (raw.get("mm_vision_tower"), raw.get("vision_tower"),
                           vision_cfg.get("model_name"), vision_cfg.get("name_or_path")):
            tower_size = infer_size_from_tower_name(tower_name)
            if tower_size is not None:
                return tower_size, str(tower_name)
        return None, None

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
                    attention_mask: torch.Tensor, lora=None) -> torch.Tensor:
        """Device tensors -> (B, H) pooled features; gradient-free unless
        ``train_backbone`` or ``lora`` (an adapter tree, ``io/lora.py``) is given."""
        cfg = self.config
        with contextlib.nullcontext() if cfg.train_backbone or lora is not None else torch.no_grad():
            prepared = prepare_policy_images(images, self.model_config, cfg)
            hidden, _, text_mask = self.model(prepared, input_ids, attention_mask, lora=lora)
            if cfg.image_feature_pool == "mean_pool":
                return pool_hidden(hidden, text_mask, "mean_pool")
            return pool_last_text_token(hidden, text_mask)

    def to_device(self, array) -> torch.Tensor:
        """Host array or tensor -> tensor on the backbone's device. Host
        memory goes through pinned memory (``data/prefetch.py::to_device``),
        so the copy neither waits for the card's queued work nor holds the
        host."""
        return to_device(array if isinstance(array, torch.Tensor) else np.asarray(array), self.device)

    def check_device(self, device: DeviceLike) -> None:
        """A ``device`` passed to forward must name the one the model lives on."""
        if device is not None and not same_device(self.device, torch.device(device)):
            raise ValueError(f"model lives on {self.device}, forward was asked for {device}")

    def forward(self, images, tasks: List[str], device: DeviceLike = None) -> torch.Tensor:
        """(images, task strings) -> (B, H) pooled features."""
        self.check_device(device)
        with tracing.span("policy.prep.frames"):
            img = self._as_bchw(images)
        with tracing.span("policy.prep.upload"):
            img = self.to_device(img)
        with tracing.span("policy.prep.text"):
            ids, mask = self._prep_text(tasks)
        with tracing.span("policy.prep.upload"):
            ids, mask = self.to_device(ids), self.to_device(mask)
        with torch.inference_mode():
            return self.features_fn(img, ids, mask)

    __call__ = forward

    def backbone(self, images, tasks, device=None, **kwargs):
        """Compat with the older call style ``backbone(images, tasks, device=...)``."""
        return self.forward(images, tasks, device=device)
