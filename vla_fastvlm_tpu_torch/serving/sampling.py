"""Token sampling for the generation paths: greedy, temperature, top-p, and
the speculative rejection-sampling rule (counterpart of ``warp_logits`` /
``sample_tokens`` / ``speculative_accept`` in
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


def speculative_accept(
    draft_tokens: torch.Tensor,  # (B, k) proposals sampled from the draft
    draft_logits: torch.Tensor,  # (B, k, V) raw draft logits they came from
    target_logits: torch.Tensor,  # (B, k+1, V) raw target verify logits
    generator: torch.Generator,
    temperature: float,
    top_p: float = 1.0,
):
    """Rejection-sampling acceptance (Leviathan et al. speculative sampling).

    Returns ``(a, correction)``: ``a`` (B,) is the accepted-prefix length in
    ``[0, k]``, ``correction`` (B,) the token each row emits after it.
    Proposal ``i`` is accepted with probability ``min(1, p_i(d_i) / q_i(d_i))``
    over the warped (temperature + top-p) target / draft distributions; the
    first rejection resamples from the residual ``max(p_a - q_a, 0)``
    (renormalized), and full acceptance samples the target's own ``p_k``
    (``q`` padded with a zeros row). The emitted stream is distributed
    exactly like plain sampling from the target. ``generator`` takes the
    place of the JAX key and must live on the logits' device.
    """
    b, k = draft_tokens.shape
    dtoks = draft_tokens.long()
    p = torch.softmax(warp_logits(target_logits, temperature, top_p), dim=-1)
    q = torch.softmax(warp_logits(draft_logits, temperature, top_p), dim=-1)
    p_at_d = torch.gather(p[:, :k], -1, dtoks[..., None])[..., 0]
    q_at_d = torch.gather(q, -1, dtoks[..., None])[..., 0]
    u = torch.rand((b, k), generator=generator, device=p.device)
    # u < p/q, written q-multiplied so q ~ 0 (never sampled) stays safe.
    accept = (u * q_at_d < p_at_d).to(torch.int32)
    a = torch.cumprod(accept, dim=1).sum(dim=1)  # (B,) in [0, k]

    rows = torch.arange(b, device=p.device)
    q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
    p_a, q_a = p[rows, a], q_pad[rows, a]  # (B, V)
    res = (p_a - q_a).clamp_min(0.0)
    # Degenerate guard (p <= q everywhere is measure-zero, but rounding can
    # collapse the difference): fall back to the target distribution.
    res = torch.where(res.sum(dim=-1, keepdim=True) > 0, res, p_a)
    correction = torch.multinomial(res, 1, generator=generator)[:, 0]
    return a.to(torch.int32), correction.to(torch.int32)
