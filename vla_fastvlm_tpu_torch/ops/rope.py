"""Rotary position embeddings, matching HF's default Qwen2 RoPE
(counterpart of ``vla_fastvlm_tpu/ops/rope.py``).

cos and sin are built in float32 and then cast to the activation dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_cos_sin(
    positions: torch.Tensor,  # (B, T) or (T,) integer
    head_dim: int,
    theta: float = 1_000_000.0,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin), each of shape ``positions.shape + (head_dim,)``."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (exponent / head_dim))
    freqs = positions.float()[..., None] * inv_freq  # (..., d/2)
    emb = torch.cat([freqs, freqs], dim=-1)  # (..., d)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor,  # (B, T, N, D)
    k: torch.Tensor,  # (B, T, K, D)
    cos: torch.Tensor,  # (B, T, D) or (T, D)
    sin: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply rotary embedding to query/key tensors laid out (B, T, heads, D)."""
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    q_out = q * cos + _rotate_half(q) * sin
    k_out = k * cos + _rotate_half(k) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
