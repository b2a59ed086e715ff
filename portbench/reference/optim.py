"""The update a training step applies, written out: the global-norm clip and
AdamW with decoupled weight decay (PyTorch's and optax's form)."""

from __future__ import annotations

import math
from typing import Dict

import torch


def clip_global_norm(grads: Dict[str, torch.Tensor], max_norm: float) -> float:
    """Scale every gradient by ``max_norm / norm`` when the global norm
    reaches ``max_norm``; returns the norm before clipping."""
    norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
    if norm >= max_norm:
        for g in grads.values():
            g.mul_(max_norm / norm)
    return norm


class AdamW:
    def __init__(self, lr: float, betas, eps: float, weight_decay: float) -> None:
        self.lr, (self.b1, self.b2), self.eps, self.wd = lr, betas, eps, weight_decay
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for name, p in params.items():
            g = grads[name]
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            p.mul_(1 - lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))
