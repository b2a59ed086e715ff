"""FastVLM (llava_qwen2) composition: FastViTHD + mm projector + Qwen2
(counterpart of ``vla_fastvlm_tpu/models/fastvlm.py``).

``image_token_mode="prefix"`` prepends the projected image tokens to the text
sequence; ``"none"`` is text-only and does not build the vision tower. Besides
the cache-free forward, ``prefill`` / ``decode_step`` run against a dense KV
cache (``models/qwen2.py::init_kv_cache``) and ``decode_step_paged`` against
a paged pool (``serving/paged_kv.py``); ``verify_step`` and
``verify_step_paged`` are their multi-token forms for the speculative
verify window (``serving/speculative.py``, ``serving/speculative_paged.py``);
``prefill_image_chunk`` and ``prefill_text_chunk`` split ``prefill`` into
the image rows and prompt chunks (the paged server's chunked admission and
prefix-cache tails). Every method that runs the decoder takes ``lora=``:
an adapter tree of this model (``io/lora.py``; its ``language_model``
sub-tree mounts on the decoder), single or multi-LoRA with per-row ids, or
None.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from .fastvit import FastViTHD, FastViTHDConfig, fastvithd, fastvithd_tiny, gelu
from .layers import Dense
from .qwen2 import Qwen2Config, Qwen2Model, lm_head_logits, qwen2_0_5b, qwen2_1_5b, qwen2_7b, qwen2_tiny


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


def _decoder_lora(lora: Optional[dict]) -> Optional[dict]:
    return lora["language_model"] if lora else None


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
        lora: Optional[dict] = None,
    ):
        inputs_embeds, seq_mask, text_mask = self._splice(images, input_ids, attention_mask)
        hidden, _, _ = self.language_model(inputs_embeds=inputs_embeds, attention_mask=seq_mask, causal=True,
                                           lora=_decoder_lora(lora))
        return hidden, seq_mask, text_mask

    def forward_logits(self, images, input_ids, attention_mask=None, lora=None):
        """Full-sequence lm_head logits: ``(logits (B, N_img + T, V), seq_mask, text_mask)``."""
        hidden, seq_mask, text_mask = self(images, input_ids, attention_mask, lora=lora)
        return self._logits(hidden), seq_mask, text_mask

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """LM head: the tied embedding's ``attend`` or the untied ``lm_head``."""
        if self.cfg.text.tie_word_embeddings:
            return self.language_model.embed_tokens.attend(hidden)
        return lm_head_logits(self.lm_head, hidden)

    def prefill(self, images, input_ids, attention_mask, cache: dict, lora=None):
        """Multimodal prefill into a dense KV cache (written in place).

        Returns ``(last_logits, hidden, new_cache, seq_mask, text_mask)`` with
        ``last_logits`` (B, V) at each sequence's true last position. The LM
        head runs on those positions only (JAX computes every position's
        logits and keeps the last; the numbers are the same). The cursor
        advances by the PADDED width, so pad slots are dead but stored; the
        cache mask keeps them out of attention and RoPE counts true lengths.
        """
        inputs_embeds, seq_mask, text_mask = self._splice(images, input_ids, attention_mask)
        hidden, new_cache, _ = self.language_model(
            inputs_embeds=inputs_embeds, attention_mask=seq_mask, cache=cache, causal=True, lora=_decoder_lora(lora),
        )
        idx = (seq_mask.sum(dim=1) - 1).clamp_min(0)
        last = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
        return self._logits(last), hidden, new_cache, seq_mask, text_mask

    def decode_step(self, input_ids: torch.Tensor, cache: dict, lora=None):
        """One KV-cached decode step: (B, 1) token ids -> ((B, V) logits, new_cache)."""
        hidden, new_cache, _ = self.language_model(
            input_ids=input_ids, attention_mask=torch.ones_like(input_ids, dtype=torch.int32),
            cache=cache, causal=True, lora=_decoder_lora(lora),
        )
        return self._logits(hidden[:, -1]), new_cache

    def decode_step_paged(self, input_ids: torch.Tensor, cache: dict, lora=None):
        """One decode step against a paged KV pool, which it only reads.

        ``cache``: ``{"pool_k","pool_v"}`` (L, P, K, page, D), ``"tables"``
        (B, P_slot), ``"mask"`` (B, S_max) stored validity, ``"index"`` (B,)
        write cursors; int8 pools add ``{"pool_k_scale","pool_v_scale"}``
        (L, P, K, page). Returns ``(logits (B, V), rows)`` with ``rows``
        ``{"k_rows","v_rows"}`` (L, B, K, D) for the server to scatter
        (+ ``{"k_scale_rows","v_scale_rows"}`` (L, B, K) for int8 pools).
        """
        hidden, rows, _ = self.language_model(
            input_ids=input_ids, attention_mask=torch.ones_like(input_ids, dtype=torch.int32),
            cache=cache, causal=True, lora=_decoder_lora(lora),
        )
        return self._logits(hidden[:, -1]), rows

    def prefill_image_chunk(self, images: torch.Tensor, cache: dict, lora=None) -> dict:
        """Chunked prefill, stage 0: write the image rows into a dense cache.

        The vision encode and the projector run as their own cached step: the
        ``num_image_tokens`` projected embeddings land at cache slots
        ``[0, N_img)`` (the cursor starts at 0) with RoPE positions
        ``0..N_img-1``, where ``prefill``'s front splice puts them. Returns
        the cache, written in place.
        """
        image_embeds = self.encode_images(images)
        ones = torch.ones(image_embeds.shape[:2], dtype=torch.int32, device=image_embeds.device)
        _, new_cache, _ = self.language_model(inputs_embeds=image_embeds, attention_mask=ones, cache=cache, causal=True,
                                              lora=_decoder_lora(lora))
        return new_cache

    def prefill_text_chunk(self, input_ids: torch.Tensor, attention_mask: torch.Tensor, cache: dict, lora=None):
        """Chunked prefill, stage 1 on: one (B, C) prompt chunk against a
        dense cache -> ``((B, C, V) logits, new_cache)``.

        The cached branch of ``Qwen2Model`` gives prefill semantics chunk by
        chunk: the rows land at slots ``[index, index + C)``, causality runs
        on slot indices, and RoPE positions continue each row's true valid
        count (``cache["mask"]``), so pads advance the cursor but stay
        masked, as in the one-shot padded ``prefill``.
        """
        hidden, new_cache, _ = self.language_model(
            input_ids=input_ids, attention_mask=attention_mask, cache=cache, causal=True, lora=_decoder_lora(lora),
        )
        return self._logits(hidden), new_cache

    def verify_step(self, input_ids: torch.Tensor, cache: dict, lora=None):
        """The speculative verify pass: multi-token cached decode returning
        every position's logits. (B, W) window ids -> ``(logits (B, W, V),
        second)``. Window position ``i`` attends the cache plus window
        positions ``<= i``, so the target's continuation of each accepted
        prefix is read from one forward.

        - Dense cache (``serving/speculative.py``): the slot-causal bias of
          the dense branch; ``second`` is the cache advanced by W, and the
          caller rolls back the rejected suffix (``_rollback``).
        - Paged pool, the cache of ``decode_step_paged``
          (``serving/speculative_paged.py``; also called as
          ``verify_step_paged``): ``ops.attention.paged_attention`` with W
          queries, the window kernel on the card at W > 1; the pool is only
          read, and ``second`` is the window's K/V, ``{"k_rows","v_rows"}``
          (L, B, W, K, D) (+ (L, B, W, K) scales for int8 pools; the window
          axis is squeezed at W = 1, as in ``decode_step_paged``), for the
          server to scatter before it advances masks and cursors only
          ``accepted + 1`` positions.
        """
        hidden, second, _ = self.language_model(
            input_ids=input_ids, attention_mask=torch.ones_like(input_ids, dtype=torch.int32),
            cache=cache, causal=True, lora=_decoder_lora(lora),
        )
        return self._logits(hidden), second

    verify_step_paged = verify_step

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
