"""Discrete action/state tokens for autoregressive decoding (counterpart of
``vla_fastvlm_tpu/models/action_tokens.py``).

Each action (and state) dimension is clipped to ``[low, high]`` and cut into
``num_bins`` uniform bins that occupy the TAIL of the language model's
vocabulary, ids ``[vocab_size - num_bins, vocab_size)``; a token decodes to
its bin's center, so the quantization error is at most half a bin,
``(high - low) / (2 * num_bins)``. Ids outside the codebook (greedy decoding
over the whole vocabulary may emit them) clip to the nearest bin.

``encode`` / ``decode`` run in numpy on the host (batch prep, server
outputs); ``decode_torch`` decodes a tensor on its own device (the policy's
``forward``), where JAX has ``decode_jnp``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ActionTokenizer:
    """Uniform-bin value <-> vocab-tail token codec."""

    vocab_size: int
    num_bins: int = 256
    low: float = -1.0
    high: float = 1.0

    def __post_init__(self):
        if self.num_bins < 2:
            raise ValueError(f"num_bins must be >= 2, got {self.num_bins}")
        if self.num_bins > self.vocab_size:
            raise ValueError(f"num_bins {self.num_bins} exceeds vocab {self.vocab_size}")
        if not self.high > self.low:
            raise ValueError(f"need high > low, got [{self.low}, {self.high}]")

    @property
    def base_id(self) -> int:
        return self.vocab_size - self.num_bins

    @property
    def bin_width(self) -> float:
        return (self.high - self.low) / self.num_bins

    def encode(self, values) -> np.ndarray:
        """(..., D) float values -> (..., D) int32 token ids."""
        x = np.clip(np.asarray(values, np.float32), self.low, self.high)
        b = np.floor((x - self.low) / self.bin_width).astype(np.int64)
        b = np.clip(b, 0, self.num_bins - 1)
        return (self.base_id + b).astype(np.int32)

    def decode(self, tokens) -> np.ndarray:
        """(..., D) token ids -> (..., D) float32 bin centers."""
        b = np.clip(np.asarray(tokens, np.int64) - self.base_id, 0, self.num_bins - 1).astype(np.float32)
        return (self.low + (b + 0.5) * self.bin_width).astype(np.float32)

    def decode_torch(self, tokens: torch.Tensor) -> torch.Tensor:
        """``decode`` of a tensor, on its device: float32 bin centers."""
        b = (tokens.to(torch.int64) - self.base_id).clamp(0, self.num_bins - 1).to(torch.float32)
        return self.low + (b + 0.5) * self.bin_width
