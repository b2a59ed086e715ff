"""Normalization ops (counterpart of ``vla_fastvlm_tpu/ops/norms.py``).

All reductions run in float32 regardless of the input dtype, and the output
is cast back to the input dtype, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Root-mean-square layer norm: ``x * rsqrt(mean(x^2) + eps) * weight``."""
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(dtype)


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Standard layer norm with optional affine, fp32 internal math."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)
