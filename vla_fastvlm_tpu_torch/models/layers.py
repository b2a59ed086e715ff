"""Parameterized layers with Flax's conventions, for the port's models.

Flax's ``nn.Dense``, ``nn.Conv``, ``nn.LayerNorm`` and ``nn.Embed`` differ from
their torch counterparts in ways that change numbers, so the port builds its
models from these instead:

- ``Dense`` computes in ``dtype`` (input and parameters cast, like Flax's
  ``dtype=``) with lecun-normal init and zero bias.
- ``Conv2d`` takes and returns NHWC and pads like XLA's ``"SAME"``: for a
  stride-2 conv on an even input the padding is asymmetric, (0, 1) for k=3
  and (2, 3) for k=7, which ``torch.nn.Conv2d(padding=k//2)`` would shift by
  a pixel. Grouped convs keep Flax's grouping of output channels (output
  channel o belongs to group o // (out / groups), as in torch).
- ``LayerNorm`` defaults to Flax's ``epsilon=1e-6`` (torch's is 1e-5).

Every module with parameters has ``init_(generator)``, which fills them the
way the JAX initializers do; ``init_weights`` walks a model and calls it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.norms import layer_norm

# Flax's truncated-normal variance scaling divides by this so the truncated
# distribution keeps the requested variance.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of ``module`` as the JAX initializers do.

    Children are filled before their parents, so a parent's ``init_`` may
    override what its children chose (``RepDWConv``'s dirac kernel).
    """
    if any(p.is_meta for p in module.parameters()):
        return
    with torch.no_grad():
        for m in reversed(list(module.modules())):
            init = getattr(m, "init_", None)
            if init is not None:
                init(generator)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's "SAME" for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Dense(nn.Module):
    """``y = x @ W^T + b`` in ``dtype``; weight stored (out, in) as torch does."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features, self.out_features, self.dtype = in_features, out_features, dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=param_dtype))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_features, dtype=param_dtype))
        else:
            self.register_parameter("bias", None)

    def init_(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Conv2d(nn.Module):
    """NHWC conv with XLA "SAME" padding; weight stored OIHW."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.stride, self.groups, self.dtype = kernel, stride, groups, dtype
        self.fan_in = kernel * kernel * (in_channels // groups)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel, kernel, dtype=param_dtype)
        )
        if bias:
            self.bias = nn.Parameter(torch.empty(out_channels, dtype=param_dtype))
        else:
            self.register_parameter("bias", None)

    def init_(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.fan_in, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        xc = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last strides
        ph = same_padding(xc.shape[2], self.kernel, self.stride)
        pw = same_padding(xc.shape[3], self.kernel, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
            padding = (0, 0)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(xc, self.weight.to(self.dtype), bias, self.stride, padding, 1, self.groups)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm``: fp32 statistics, epsilon 1e-6, output in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.empty(dim, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(dim, dtype=param_dtype))

    def init_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.to(self.dtype), self.weight, self.bias, self.eps)


class Embed(nn.Module):
    """Flax ``nn.Embed``: table (V, H), lookup and ``attend`` in ``dtype``."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, features, dtype=param_dtype))

    def init_(self, generator: torch.Generator) -> None:
        # Flax default_embed_init: variance_scaling(1, fan_in, truncated normal,
        # out_axis=0), whose fan_in on a (V, H) table is H.
        lecun_normal_(self.weight, self.features, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.weight.to(self.dtype).t()
