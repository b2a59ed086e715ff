"""Action expert heads: pooled VLM features + robot state -> actions
(counterpart of ``vla_fastvlm_tpu/models/action_head.py``).

    state_projection = LayerNorm -> Linear(state_dim -> hidden) -> SiLU
    fusion           = Linear(feat+hidden -> fusion) -> LayerNorm -> SiLU
                       -> Dropout -> Linear(fusion -> fusion) -> SiLU
    action_head      = Linear(fusion -> action_dim)

LayerNorms use Flax's epsilon 1e-6. The feature width is a constructor
argument here (Flax infers it from the first call).

Dropout runs when ``train`` (default: the module's ``training`` flag) is
set, as Flax's ``deterministic=False``: the keep mask is drawn from the
``generator`` the caller passes (the JAX step's ``dropout_rng``; the
default generator when None) and kept values are scaled by 1 / (1 - p).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dense, LayerNorm


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep each element with probability 1 - rate,
    scale kept ones by 1 / (1 - rate); the mask comes from ``generator``."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate, generator=generator).bool()
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class ActionExpertHead(nn.Module):
    def __init__(self, feature_dim: int, state_dim: int, action_dim: int, hidden_dim: int = 1024,
                 fusion_dim: int = 1024, dropout: float = 0.1, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.state_norm = LayerNorm(state_dim, 1e-6, dtype, param_dtype)
        self.state_proj = Dense(state_dim, hidden_dim, True, dtype, param_dtype)
        self.fusion_fc1 = Dense(feature_dim + hidden_dim, fusion_dim, True, dtype, param_dtype)
        self.fusion_norm = LayerNorm(fusion_dim, 1e-6, dtype, param_dtype)
        self.fusion_fc2 = Dense(fusion_dim, fusion_dim, True, dtype, param_dtype)
        self.action_head = Dense(fusion_dim, action_dim, True, dtype, param_dtype)

    def forward(self, features: torch.Tensor, states: torch.Tensor, train: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        s = F.silu(self.state_proj(self.state_norm(states.to(self.dtype))))
        fused = self.fusion_fc1(torch.cat([features.to(self.dtype), s], dim=-1))
        fused = F.silu(self.fusion_norm(fused))
        if (self.training if train is None else train) and self.dropout > 0:
            fused = dropout(fused, self.dropout, generator)
        fused = F.silu(self.fusion_fc2(fused))
        return self.action_head(fused)


class ActionChunkHead(nn.Module):
    """Chunked action head: one forward emits ``chunk_size`` future actions."""

    def __init__(self, feature_dim: int, state_dim: int, action_dim: int, chunk_size: int = 1,
                 hidden_dim: int = 1024, fusion_dim: int = 1024, dropout: float = 0.1,
                 dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        self.chunk_size, self.action_dim = chunk_size, action_dim
        self.trunk = ActionExpertHead(
            feature_dim, state_dim, chunk_size * action_dim, hidden_dim, fusion_dim,
            dropout, dtype, param_dtype,
        )

    def forward(self, features: torch.Tensor, states: torch.Tensor, train: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        flat = self.trunk(features, states, self.training if train is None else train, generator)
        return flat.reshape(flat.shape[0], self.chunk_size, self.action_dim)
