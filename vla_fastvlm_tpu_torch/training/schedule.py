"""Learning-rate schedule and global-norm clip of the port's trainer
(counterparts of ``_linear_warmup_decay`` in
``vla_fastvlm_tpu/training/trainer.py`` and of ``optax.clip_by_global_norm``).

The schedule is indexed by optimizer updates, not batches: with gradient
accumulation ``global_step`` counts batches while the schedule counts
updates, the reference's dual-clock quirk, which the JAX package keeps.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def linear_warmup_decay(peak_lr: float, total_steps: int, warmup_steps: int) -> Callable[[int], float]:
    """lr = peak * update / warmup during warmup, then linear to 0 at ``total_steps``."""

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_lr * count / max(1.0, warmup_steps)
        return peak_lr * max(0.0, (total_steps - count) / max(1.0, total_steps - warmup_steps))

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32, on the tensors'
    device (no host sync)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(tensors: Sequence[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale ``tensors`` in place by ``max_norm / norm`` when their global
    norm reaches ``max_norm`` (``optax.clip_by_global_norm``: no epsilon, the
    tensors untouched below the limit). Returns the norm before clipping.
    ``norm``: the global norm when the caller computed it (a sharded run's
    tensors are this rank's pieces, scaled through their local tensors)."""
    if norm is None:
        norm = global_norm(tensors)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_([t.to_local() if hasattr(t, "to_local") else t for t in tensors], scale)
    return norm
