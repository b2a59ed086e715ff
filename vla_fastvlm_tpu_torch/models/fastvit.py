"""FastViTHD hybrid vision encoder (counterpart of ``vla_fastvlm_tpu/models/fastvit.py``).

NHWC at every module boundary, like the JAX module; convs run through
``layers.Conv2d`` on a channels_last view with XLA "SAME" padding. Module
and parameter names follow the Flax tree (``stem_0``, ``stage1_block3``,
``patch_embed_2`` ...) so the weight bridge is a per-leaf layout change.

``RepMixerBlock`` dispatches on ``cfg.block_impl``: "auto" and "fused" are
one path, the port's fused RepMixer kernel (``ops/kernels/repmixer.py``: the
CUDA kernel on the card, raising where it does not take the shape, and its
plain version on the CPU); "xla" keeps the unfused composition.
``SpatialAttention`` (head_dim 32) stays plain torch, as it stays outside any
Pallas kernel in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from .layers import Conv2d, Dense


@dataclasses.dataclass(frozen=True)
class FastViTHDConfig:
    """FastViTHD hyperparameters (defaults = the FastVLM checkpoints' tower)."""

    embed_dims: Tuple[int, ...] = (96, 192, 384, 768, 1536)
    depths: Tuple[int, ...] = (2, 12, 24, 4, 2)
    token_mixers: Tuple[str, ...] = (
        "repmixer", "repmixer", "repmixer", "attention", "attention",
    )
    mlp_ratios: Tuple[float, ...] = (4.0, 4.0, 4.0, 4.0, 4.0)
    pos_embs: Tuple[bool, ...] = (False, False, False, True, True)
    attn_head_dim: int = 32
    final_expand_ratio: float = 2.0
    layer_scale_init: float = 1e-5
    block_impl: str = "auto"  # "auto" | "fused" | "xla"
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def out_channels(self) -> int:
        return int(self.embed_dims[-1] * self.final_expand_ratio)

    @property
    def downsample_factor(self) -> int:
        return 4 * (2 ** (len(self.depths) - 1))

    def replace(self, **kw) -> "FastViTHDConfig":
        return dataclasses.replace(self, **kw)


def fastvithd(**kw) -> FastViTHDConfig:
    return FastViTHDConfig(**kw)


def fastvithd_tiny(**kw) -> FastViTHDConfig:
    """Tiny variant for tests."""
    return FastViTHDConfig(
        embed_dims=(8, 16, 24, 32, 48),
        depths=(1, 1, 1, 1, 1),
        attn_head_dim=16,
        **kw,
    )


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Flax ``nn.gelu``: the tanh approximation (torch's default is exact)."""
    return F.gelu(x, approximate="tanh")


class ConvAct(nn.Module):
    """Conv + bias (+ GELU); a 1x1 ungrouped stride-1 conv is a Dense over C."""

    def __init__(self, in_channels: int, features: int, kernel: int, stride: int = 1,
                 groups: int = 1, act: bool = True, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        self.act = act
        if kernel == 1 and groups == 1 and stride == 1:
            self.conv = Dense(in_channels, features, True, dtype, param_dtype)
        else:
            self.conv = Conv2d(in_channels, features, kernel, stride, groups, True, dtype, param_dtype)

    def forward(self, x):
        x = self.conv(x)
        return gelu(x) if self.act else x


class RepDWConv(nn.Module):
    """Reparameterized depthwise conv that replaces its input (dirac init)."""

    def __init__(self, channels: int, kernel: int, dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, kernel, 1, channels, True, dtype, param_dtype)

    def init_(self, generator: torch.Generator) -> None:
        # Identity (dirac) kernel, zero bias; init_weights runs this after the
        # child conv's lecun init, which it overrides.
        w = self.conv.weight
        w.zero_()
        center = w.shape[-1] // 2
        w[:, 0, center, center] = 1.0
        self.conv.bias.zero_()

    def forward(self, x):
        return self.conv(x)


class PatchEmbed(nn.Module):
    """Stage-transition downsampler: 7x7 stride-2 grouped conv + pointwise."""

    def __init__(self, in_channels: int, features: int, cfg: FastViTHDConfig):
        super().__init__()
        groups = math.gcd(in_channels, features)
        self.large_kernel = ConvAct(in_channels, features, 7, 2, groups, True, cfg.dtype, cfg.param_dtype)
        self.pointwise = ConvAct(features, features, 1, 1, 1, True, cfg.dtype, cfg.param_dtype)

    def forward(self, x):
        return self.pointwise(self.large_kernel(x))


class ConvFFN(nn.Module):
    """FastViT ConvFFN: dw 7x7 + pointwise MLP with GELU, residual outside."""

    def __init__(self, channels: int, hidden: int, cfg: FastViTHDConfig):
        super().__init__()
        self.dw = ConvAct(channels, channels, 7, 1, channels, False, cfg.dtype, cfg.param_dtype)
        self.fc1 = ConvAct(channels, hidden, 1, 1, 1, True, cfg.dtype, cfg.param_dtype)
        self.fc2 = ConvAct(hidden, channels, 1, 1, 1, False, cfg.dtype, cfg.param_dtype)

    def forward(self, x):
        return self.fc2(self.fc1(self.dw(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float, param_dtype=torch.float32):
        super().__init__()
        self.init_value = init
        self.gamma = nn.Parameter(torch.empty(dim, dtype=param_dtype))

    def init_(self, generator: torch.Generator) -> None:
        self.gamma.fill_(self.init_value)

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class ChannelAffine(nn.Module):
    """Per-channel scale+shift: the inference form of BatchNorm."""

    def __init__(self, dim: int, param_dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(dim, dtype=param_dtype))

    def init_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return x * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class RepMixerBlock(nn.Module):
    """Token mixing via reparameterized dw conv + ConvFFN, layer-scaled."""

    def __init__(self, channels: int, cfg: FastViTHDConfig, mlp_ratio: float):
        super().__init__()
        self.cfg = cfg
        self.hidden = int(channels * mlp_ratio)
        self.token_mixer = RepDWConv(channels, 3, cfg.dtype, cfg.param_dtype)
        self.convffn = ConvFFN(channels, self.hidden, cfg)
        self.layer_scale = LayerScale(channels, cfg.layer_scale_init, cfg.param_dtype)

    def forward(self, x):
        x = x.to(self.cfg.dtype)
        impl = self.cfg.block_impl
        if impl not in ("auto", "fused", "xla"):
            raise ValueError(f"unknown block_impl {impl!r}")
        if impl != "xla":
            from ..ops.kernels.repmixer import repmixer_block

            ffn = self.convffn
            return repmixer_block(
                x.contiguous(),
                _hwc(self.token_mixer.conv.weight),
                self.token_mixer.conv.bias,
                _hwc(ffn.dw.conv.weight),
                ffn.dw.conv.bias,
                ffn.fc1.conv.weight.t(),
                ffn.fc1.conv.bias,
                ffn.fc2.conv.weight.t(),
                ffn.fc2.conv.bias,
                self.layer_scale.gamma,
            )
        x = self.token_mixer(x)
        return x + self.layer_scale(self.convffn(x))


def _hwc(depthwise_weight: torch.Tensor) -> torch.Tensor:
    """(C, 1, k, k) torch depthwise kernel -> (k, k, C), the kernel's layout."""
    return depthwise_weight[:, 0].permute(1, 2, 0)


class SpatialAttention(nn.Module):
    """MHSA over flattened spatial tokens (FastViT attention stages)."""

    def __init__(self, channels: int, cfg: FastViTHDConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = Dense(channels, 3 * channels, False, cfg.dtype, cfg.param_dtype)
        self.proj = Dense(channels, channels, True, cfg.dtype, cfg.param_dtype)

    def forward(self, x):
        b, h, w, c = x.shape
        d = self.cfg.attn_head_dim
        q, k, v = self.qkv(x.reshape(b, h * w, c)).chunk(3, dim=-1)
        shape = (b, h * w, c // d, d)
        out = dot_product_attention(q.reshape(shape), k.reshape(shape), v.reshape(shape))
        return self.proj(out.reshape(b, h * w, c)).reshape(b, h, w, c)


class AttentionBlock(nn.Module):
    """FastViT attention block: BN(affine) -> MHSA, then ConvFFN; layer-scaled."""

    def __init__(self, channels: int, cfg: FastViTHDConfig, mlp_ratio: float):
        super().__init__()
        self.norm = ChannelAffine(channels, cfg.param_dtype)
        self.token_mixer = SpatialAttention(channels, cfg)
        self.layer_scale_1 = LayerScale(channels, cfg.layer_scale_init, cfg.param_dtype)
        self.convffn = ConvFFN(channels, int(channels * mlp_ratio), cfg)
        self.layer_scale_2 = LayerScale(channels, cfg.layer_scale_init, cfg.param_dtype)

    def forward(self, x):
        x = x + self.layer_scale_1(self.token_mixer(self.norm(x)))
        return x + self.layer_scale_2(self.convffn(x))


class FastViTHD(nn.Module):
    """(B, H, W, 3) NHWC or (B, 3, H, W) NCHW in [0, 1] -> (B, N, C_out) tokens."""

    def __init__(self, cfg: FastViTHDConfig):
        super().__init__()
        self.cfg = cfg
        dt, pdt = cfg.dtype, cfg.param_dtype
        d0 = cfg.embed_dims[0]
        self.stem_0 = ConvAct(3, d0, 3, 2, 1, True, dt, pdt)
        self.stem_1 = ConvAct(d0, d0, 3, 2, d0, True, dt, pdt)
        self.stem_2 = ConvAct(d0, d0, 1, 1, 1, True, dt, pdt)
        self._order = []
        prev = d0
        for stage, (dim, depth, mixer, ratio, cpe) in enumerate(
            zip(cfg.embed_dims, cfg.depths, cfg.token_mixers, cfg.mlp_ratios, cfg.pos_embs)
        ):
            if stage > 0:
                self._add(f"patch_embed_{stage}", PatchEmbed(prev, dim, cfg))
            if cpe:
                self._add(f"pos_emb_{stage}", RepDWConv(dim, 7, dt, pdt))
            for blk in range(depth):
                if mixer == "repmixer":
                    block = RepMixerBlock(dim, cfg, ratio)
                elif mixer == "attention":
                    block = AttentionBlock(dim, cfg, ratio)
                else:
                    raise ValueError(f"unknown token mixer {mixer!r}")
                self._add(f"stage{stage}_block{blk}", block)
            prev = dim
        self.conv_exp = ConvAct(prev, cfg.out_channels, 3, 1, cfg.embed_dims[-1], True, dt, pdt)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self._order.append(name)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if images.ndim != 4:
            raise ValueError(f"expected 4D image batch, got {tuple(images.shape)}")
        if images.shape[1] == 3 and images.shape[-1] != 3:
            images = images.permute(0, 2, 3, 1)  # NCHW -> NHWC
        x = images.to(self.cfg.dtype)
        x = self.stem_2(self.stem_1(self.stem_0(x)))
        for name in self._order:
            x = getattr(self, name)(x)
        x = self.conv_exp(x)
        b, h, w, c = x.shape
        return x.reshape(b, h * w, c)  # row-major NHWC token order
