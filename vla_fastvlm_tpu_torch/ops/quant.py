"""int8 KV-cache quantization (counterpart of ``quantize_kv`` / ``dequantize_kv``
in ``vla_fastvlm_tpu/ops/quant.py``; the rest of that module is not ported yet).
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0


def quantize_kv(x: torch.Tensor):
    """(..., D) float K/V values -> (int8 values, (...,) float32 scales).

    Symmetric absmax over the head dim: one scale per (position, kv head);
    the scale is 1 where the absmax is 0. Rounds half to even, as
    ``jnp.round`` does.
    """
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / INT8_MAX, torch.ones_like(absmax))
    q = torch.round(x32 / scale).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale[..., 0]


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``quantize_kv``: int8 (..., D) + (...,) scales -> ``dtype``."""
    return q.to(dtype) * scale[..., None].to(dtype)
