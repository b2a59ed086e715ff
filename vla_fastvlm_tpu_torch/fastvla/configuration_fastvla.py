"""FastVLA policy configuration (counterpart of
``vla_fastvlm_tpu/fastvla/configuration_fastvla.py``): the same field set and
the same ``to_backbone_config()`` translation. Fields of paths that are not
ported yet (quantization, LoRA, training, the token head) are kept for
config parity and rejected by the policy when set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..model.fastvlm_adapter import FastVLMBackboneConfig


@dataclass
class FastVLAConfig:
    """Configuration for adapting FastVLM into a VLA policy."""

    vlm_model_name: str = "apple/FastVLM-0.5B"
    bootstrap_model_name: str = "apple/FastVLM-0.5B"
    state_dim: int = 14
    action_dim: int = 14
    hidden_dim: int = 1024
    fusion_dim: int = 1024
    dropout: float = 0.1
    freeze_backbone: bool = True

    # Preprocessing
    tokenizer_max_length: int = 64
    tokenizer_padding_side: str = "right"
    pad_to_max_length: bool = False
    resize_with_padding: bool = True
    image_size: Optional[int] = None
    pad_value: float = 0.0
    add_trailing_newline: bool = True

    # Model knobs
    image_token_mode: str = "prefix"  # "prefix" | "none"
    dtype: str = "float32"
    param_dtype: str = "float32"
    attention_impl: str = "auto"  # "auto" | "flash" | "xla"
    vision_block_impl: str = "auto"  # "auto" | "fused" | "xla"
    fused_projections: bool = True
    quantization: str = "none"
    kv_cache_quantization: str = "none"
    train_backbone: bool = False
    fabricate_params: bool = False
    gradient_checkpointing: bool = False
    lora_rank: int = 0
    lora_alpha: Optional[float] = None
    chunk_size: int = 1  # > 1 emits (chunk, action_dim) per forward
    action_head: str = "mlp"  # "mlp" ("token" is not ported yet)
    action_bins: int = 256
    action_token_low: float = -1.0
    action_token_high: float = 1.0
    num_cameras: int = 1
    seed: int = 0

    def to_backbone_config(self) -> FastVLMBackboneConfig:
        """Translate to the backbone adapter config."""
        return FastVLMBackboneConfig(
            model_id=self.vlm_model_name,
            bootstrap_model_id=self.bootstrap_model_name,
            freeze_backbone=self.freeze_backbone,
            force_image_size=self.image_size,
            resize_with_padding=self.resize_with_padding,
            pad_value=self.pad_value,
            tokenizer_max_length=self.tokenizer_max_length,
            tokenizer_padding_side=self.tokenizer_padding_side,
            pad_to_max_length=self.pad_to_max_length,
            image_token_mode=self.image_token_mode,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            attention_impl=self.attention_impl,
            vision_block_impl=self.vision_block_impl,
            fused_projections=self.fused_projections,
            quantization=self.quantization,
            kv_cache_quantization=self.kv_cache_quantization,
            train_backbone=self.train_backbone,
            fabricate_params=self.fabricate_params,
            gradient_checkpointing=(
                self.gradient_checkpointing or self.train_backbone or self.lora_rank > 0
            ),
            num_cameras=self.num_cameras,
            seed=self.seed,
        )
