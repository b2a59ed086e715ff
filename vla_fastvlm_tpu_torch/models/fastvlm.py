"""FastVLM (llava_qwen2) composition: FastViTHD + mm projector + Qwen2
(counterpart of ``vla_fastvlm_tpu/models/fastvlm.py``, prefill path).

``image_token_mode="prefix"`` prepends the projected image tokens to the text
sequence; ``"none"`` is text-only and does not build the vision tower.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from .fastvit import FastViTHD, FastViTHDConfig, fastvithd, fastvithd_tiny, gelu
from .layers import Dense
from .qwen2 import Qwen2Config, Qwen2Model, qwen2_0_5b, qwen2_1_5b, qwen2_7b, qwen2_tiny


@dataclasses.dataclass(frozen=True)
class FastVLMConfig:
    """Composite config: vision tower + text decoder + projector + splice."""

    vision: FastViTHDConfig = dataclasses.field(default_factory=fastvithd)
    text: Qwen2Config = dataclasses.field(default_factory=qwen2_0_5b)
    image_size: int = 1024
    image_token_mode: str = "prefix"  # "prefix" | "none"
    num_cameras: int = 1

    @property
    def num_image_tokens(self) -> int:
        if self.image_token_mode == "none":
            return 0
        side = self.image_size // self.vision.downsample_factor
        return self.num_cameras * side * side

    @property
    def hidden_size(self) -> int:
        return self.text.hidden_size

    def replace(self, **kw) -> "FastVLMConfig":
        return dataclasses.replace(self, **kw)


def fastvlm_0_5b(**kw) -> FastVLMConfig:
    return FastVLMConfig(vision=fastvithd(), text=qwen2_0_5b(), **kw)


def fastvlm_1_5b(**kw) -> FastVLMConfig:
    return FastVLMConfig(vision=fastvithd(), text=qwen2_1_5b(), **kw)


def fastvlm_7b(**kw) -> FastVLMConfig:
    return FastVLMConfig(vision=fastvithd(), text=qwen2_7b(), **kw)


def fastvlm_tiny(**kw) -> FastVLMConfig:
    """Tiny composite for tests: 2-layer decoder, 8..48-wide tower, 64px."""
    kw.setdefault("image_size", 64)
    return FastVLMConfig(vision=fastvithd_tiny(), text=qwen2_tiny(), **kw)


class MMProjector(nn.Module):
    """LLaVA mlp2x_gelu projector: vision width -> decoder hidden size."""

    def __init__(self, in_features: int, hidden_size: int, dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_size, True, dtype, param_dtype)
        self.fc2 = Dense(hidden_size, hidden_size, True, dtype, param_dtype)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class FastVLM(nn.Module):
    """Pixels + tokenized instruction -> decoder hidden states.

    ``forward`` returns ``(hidden, seq_mask, text_mask)``: the post-final-norm
    hidden sequence, the validity of every position of the multimodal
    sequence, and the text positions within it.
    """

    def __init__(self, cfg: FastVLMConfig):
        super().__init__()
        self.cfg = cfg
        self.language_model = Qwen2Model(cfg.text)
        if cfg.num_image_tokens > 0:
            self.vision_tower = FastViTHD(cfg.vision)
            self.mm_projector = MMProjector(
                cfg.vision.out_channels, cfg.text.hidden_size, cfg.text.dtype, cfg.text.param_dtype
            )
        if not cfg.text.tie_word_embeddings:
            self.lm_head = Dense(
                cfg.text.hidden_size, cfg.text.vocab_size, False, cfg.text.dtype, cfg.text.param_dtype
            )

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) or (B, ncam, 3, S, S) -> (B, N_img, H) visual tokens."""
        if images.ndim == 5:
            b, ncam = images.shape[:2]
            tokens = self.vision_tower(images.reshape((b * ncam,) + tuple(images.shape[2:])))
            tokens = tokens.reshape(b, ncam * tokens.shape[1], tokens.shape[2])
        else:
            tokens = self.vision_tower(images)
        return self.mm_projector(tokens)

    def _splice(self, images, input_ids, attention_mask):
        b, t = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, t), dtype=torch.int32, device=input_ids.device)
        attention_mask = attention_mask.to(torch.int32)
        text_embeds = self.language_model.embed(input_ids)
        n_img = self.cfg.num_image_tokens
        if n_img == 0:
            return text_embeds, attention_mask, attention_mask
        if images is None:
            raise ValueError("image_token_mode='prefix' requires images")
        image_embeds = self.encode_images(images)
        inputs_embeds = torch.cat([image_embeds.to(text_embeds.dtype), text_embeds], dim=1)
        ones = torch.ones((b, n_img), dtype=torch.int32, device=input_ids.device)
        seq_mask = torch.cat([ones, attention_mask], dim=1)
        text_mask = torch.cat([torch.zeros_like(ones), attention_mask], dim=1)
        return inputs_embeds, seq_mask, text_mask

    def forward(
        self,
        images: Optional[torch.Tensor],  # (B, 3, S, S) or (B, S, S, 3); None ok for "none"
        input_ids: torch.Tensor,  # (B, T)
        attention_mask: Optional[torch.Tensor] = None,  # (B, T), 1 = real
    ):
        inputs_embeds, seq_mask, text_mask = self._splice(images, input_ids, attention_mask)
        hidden, _, _ = self.language_model(inputs_embeds=inputs_embeds, attention_mask=seq_mask, causal=True)
        return hidden, seq_mask, text_mask

    def forward_logits(self, images, input_ids, attention_mask=None):
        """Full-sequence lm_head logits: ``(logits (B, N_img + T, V), seq_mask, text_mask)``."""
        inputs_embeds, seq_mask, text_mask = self._splice(images, input_ids, attention_mask)
        tied = self.cfg.text.tie_word_embeddings
        hidden, _, tied_logits = self.language_model(
            inputs_embeds=inputs_embeds, attention_mask=seq_mask, causal=True,
            compute_tied_logits=tied,
        )
        logits = tied_logits if tied else self.lm_head(hidden)
        return logits, seq_mask, text_mask


def pool_hidden(hidden: torch.Tensor, mask: Optional[torch.Tensor], mode: str) -> torch.Tensor:
    """Masked pooling over the sequence axis: (B, T, H) -> (B, H).

    ``mean_pool`` is a mask-weighted mean with the denominator clamped at
    1e-6; ``last_token`` gathers at ``sum(mask) - 1`` (clamped at 0), or the
    final position when no mask is given.
    """
    if mode == "mean_pool":
        if mask is None:
            return hidden.mean(dim=1)
        m = mask.to(hidden.dtype)[..., None]
        return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-6)
    if mode != "last_token":
        raise ValueError(f"unknown pooling mode {mode!r}")
    if mask is None:
        return hidden[:, -1, :]
    idx = (mask.to(torch.int64).sum(dim=1) - 1).clamp_min(0)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]


def pool_last_text_token(hidden: torch.Tensor, text_mask: torch.Tensor) -> torch.Tensor:
    """Pool at the last text token of the multimodal sequence (argmax of position*mask)."""
    positions = torch.arange(hidden.shape[1], device=hidden.device)[None, :]
    last = torch.where(text_mask > 0, positions, torch.full_like(positions, -1)).argmax(dim=1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
