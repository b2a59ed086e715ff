"""Token sampling for the generation paths: greedy, temperature, top-p
(counterpart of ``warp_logits`` / ``sample_tokens`` in
``vla_fastvlm_tpu/serving/sampling.py``).

A ``torch.Generator`` takes the place of the JAX key. The two draw different
numbers from the same seed, so temperature sampling is the same distribution
as the JAX package's, not the same tokens; greedy is the same argmax.
"""

from __future__ import annotations

from typing import Optional

import torch


def warp_logits(logits: torch.Tensor, temperature: float, top_p: float = 1.0) -> torch.Tensor:
    """Temperature scale plus nucleus filter: fp32 logits whose softmax is
    the sampling distribution. ``temperature`` must be > 0."""
    if temperature <= 0.0:
        raise ValueError("warp_logits requires temperature > 0")
    logits = logits.float() / temperature
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # First sorted position whose cumulative mass reaches top_p; tokens
        # with logits below that position's logit are dropped.
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp_max(logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, torch.full_like(logits, -torch.inf), logits)
    return logits


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator], temperature: float = 0.0,
                  top_p: float = 1.0) -> torch.Tensor:
    """(..., V) logits -> (...,) int32 token ids.

    ``temperature <= 0`` is greedy argmax (first maximum; no generator
    needed); otherwise one draw from ``softmax(warp_logits(...))`` with
    ``generator``, which must live on the logits' device.
    """
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("temperature sampling requires a torch.Generator")
    probs = torch.softmax(warp_logits(logits, temperature, top_p), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1]).to(torch.int32)
