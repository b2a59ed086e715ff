"""Qwen2 decoder, prefill path (counterpart of ``vla_fastvlm_tpu/models/qwen2.py``).

Same config fields and presets as the JAX module. Differences in form, not
in numbers:

- The JAX ``nn.scan`` over layers is an ``nn.ModuleList`` loop here.
- q/k/v are stored as one fused ``qkv_proj`` (q, k, v order) and gate/up as
  one ``gate_up_proj`` (gate, up order): the JAX package concatenates them
  at apply time when ``fused_projections`` is on (``qwen2.py:224-228,368-371``);
  the weight bridge concatenates them once instead.
- Prefill only: no KV cache, quantization or LoRA yet. Fields for those are
  kept for config parity and rejected when set.

The prefill attention goes through ``ops.attention.attention`` with the
structured mask, which launches the port's flash kernel on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_cos_sin
from .layers import Dense, Embed


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151936
    hidden_size: int = 896
    num_hidden_layers: int = 24
    num_attention_heads: int = 14
    num_key_value_heads: int = 2
    intermediate_size: int = 4864
    head_dim: Optional[int] = None
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 32768
    # runtime knobs (not part of the checkpoint contract)
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    # JAX-only layout knobs, kept for config parity: the port always loops
    # an nn.ModuleList and always stores fused projections.
    scan_layers: bool = True
    remat: bool = False
    attention_impl: str = "auto"  # "auto" | "xla" | "flash"
    fused_projections: bool = True
    # Not ported yet: must stay "none".
    quantization: str = "none"
    kv_cache_quantization: str = "none"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    def replace(self, **kw) -> "Qwen2Config":
        return dataclasses.replace(self, **kw)


def qwen2_0_5b(**kw) -> Qwen2Config:
    return Qwen2Config(**kw)


def qwen2_1_5b(**kw) -> Qwen2Config:
    return Qwen2Config(
        hidden_size=1536, num_hidden_layers=28, num_attention_heads=12,
        num_key_value_heads=2, intermediate_size=8960, **kw,
    )


def qwen2_7b(**kw) -> Qwen2Config:
    return Qwen2Config(
        vocab_size=152064, hidden_size=3584, num_hidden_layers=28,
        num_attention_heads=28, num_key_value_heads=4, intermediate_size=18944,
        tie_word_embeddings=False, **kw,
    )


def qwen2_tiny(**kw) -> Qwen2Config:
    """Small config for tests."""
    return Qwen2Config(
        vocab_size=512, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        **kw,
    )


def _check_supported(cfg: Qwen2Config) -> None:
    if cfg.quantization != "none" or cfg.kv_cache_quantization != "none":
        raise NotImplementedError(
            "quantized weights and KV caches are not ported to PyTorch yet"
        )


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=param_dtype))

    def init_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        n, k, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.resolved_head_dim
        self.qkv_proj = Dense(cfg.hidden_size, (n + 2 * k) * d, True, cfg.dtype, cfg.param_dtype)
        self.o_proj = Dense(n * d, cfg.hidden_size, False, cfg.dtype, cfg.param_dtype)

    def forward(self, x, kv_mask, cos, sin, causal: bool = True):
        cfg = self.cfg
        b, t, _ = x.shape
        n, kh, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.resolved_head_dim
        q, k, v = self.qkv_proj(x).split([n * d, kh * d, kh * d], dim=-1)
        q, k = apply_rope(q.reshape(b, t, n, d), k.reshape(b, t, kh, d), cos, sin)
        v = v.reshape(b, t, kh, d).contiguous()
        out = attention(
            q.contiguous(), k.to(q.dtype).contiguous(), v.to(q.dtype),
            kv_mask=kv_mask, causal=causal, impl=cfg.attention_impl,
        )
        return self.o_proj(out.reshape(b, t, n * d))


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.gate_up_proj = Dense(cfg.hidden_size, 2 * cfg.intermediate_size, False, cfg.dtype, cfg.param_dtype)
        self.down_proj = Dense(cfg.intermediate_size, cfg.hidden_size, False, cfg.dtype, cfg.param_dtype)

    def forward(self, x):
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(F.silu(gate) * up)


class Qwen2Block(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype)
        self.self_attn = Qwen2Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype)
        self.mlp = Qwen2MLP(cfg)

    def forward(self, x, kv_mask, cos, sin, causal: bool = True):
        x = x + self.self_attn(self.input_layernorm(x), kv_mask, cos, sin, causal)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen2Model(nn.Module):
    """Decoder stack: embeddings + blocks + final norm.

    ``forward`` returns ``(hidden, None, logits)`` like the JAX module's
    ``(x, new_cache, logits)`` (no cache in the prefill slice); logits are the
    tied-embedding logits when ``compute_tied_logits`` is set, else None.
    """

    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype, cfg.param_dtype)
        self.layers = nn.ModuleList(Qwen2Block(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,  # (B, T)
        inputs_embeds: Optional[torch.Tensor] = None,  # (B, T, H)
        attention_mask: Optional[torch.Tensor] = None,  # (B, T) 1 = real token
        positions: Optional[torch.Tensor] = None,  # (B, T)
        causal: bool = True,
        compute_tied_logits: bool = False,
    ):
        cfg = self.cfg
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        x = inputs_embeds.to(cfg.dtype)
        b, t, _ = x.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, t), dtype=torch.int32, device=x.device)
        if positions is None:
            positions = torch.arange(t, device=x.device)[None, :].expand(b, t)
        cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta, cfg.dtype)
        kv_mask = attention_mask.to(torch.int32)
        for layer in self.layers:
            x = layer(x, kv_mask, cos, sin, causal)
        x = self.norm(x)
        logits = self.embed_tokens.attend(x) if compute_tied_logits else None
        return x, None, logits


class Qwen2ForCausalLM(nn.Module):
    """LM head on top of Qwen2Model (tied embeddings for 0.5B/1.5B)."""

    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        self.model = Qwen2Model(cfg)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, False, cfg.dtype, cfg.param_dtype)

    def forward(self, input_ids=None, inputs_embeds=None, attention_mask=None,
                positions=None, causal: bool = True):
        hidden, _, tied_logits = self.model(
            input_ids=input_ids, inputs_embeds=inputs_embeds,
            attention_mask=attention_mask, positions=positions, causal=causal,
            compute_tied_logits=self.cfg.tie_word_embeddings,
        )
        logits = tied_logits if self.cfg.tie_word_embeddings else self.lm_head(hidden)
        return logits, hidden, None
