"""Structural reparameterization folds: train-time branches -> fused convs
(the port's copy of ``vla_fastvlm_tpu/io/reparam.py``, on torch tensors).

FastViT/MobileOne checkpoints store multi-branch train-time parameters
(k x k conv branches + 1x1 scale branch + BN identity; RepMixer's norm/mixer
pair; ReparamLargeKernelConv's large+small kernels). The port's modules are
the fused single-conv inference form (``models/fastvit.py``), so conversion
folds branches at load time:

    conv+BN    ->  w' = w * gamma/sqrt(var+eps),  b' = beta + (b-mean)*gamma/sqrt(var+eps)
    1x1 branch ->  zero-pad to k x k (center tap)
    BN identity->  dirac kernel folded through the BN
    sum all branches' (w, b)
    RepMixer   ->  w = I + ls * (w_mixer - w_norm),  b = ls * (b_mixer - b_norm)
    RepLKC     ->  large-kernel fold + center-padded small-kernel fold

Every function takes and returns float32 torch tensors in the torch
layout (O, I/g, kH, kW), which is also the port's own conv layout: no
transpose follows. BatchNorm eps is 1e-5. The operations and their order
are the JAX package's, each correctly rounded in float32, so each fold
gives JAX's values to the last bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .weights import fold_conv_bn, sqrt_rounded


def pad_kernel_to(w: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-pad a (O, I, kh, kw) kernel to (O, I, k, k) centered."""
    kh, kw = w.shape[2:]
    ph, pw = (k - kh) // 2, (k - kw) // 2
    return F.pad(w, (pw, k - kw - pw, ph, k - kh - ph))


def identity_kernel(channels: int, groups: int, k: int, dtype=torch.float32) -> torch.Tensor:
    """Dirac kernel: conv(x, w_id) == x, for (O=C, I=C/g, k, k) layout."""
    in_per_group = channels // groups
    w = torch.zeros((channels, in_per_group, k, k), dtype=dtype)
    rows = torch.arange(channels)
    w[rows, rows % in_per_group, k // 2, k // 2] = 1.0
    return w


def fold_bn_only(channels: int, groups: int, k: int, gamma, beta, mean, var, eps: float = 1e-5):
    """A BN-only (identity) branch folded into conv form."""
    return fold_conv_bn(identity_kernel(channels, groups, k), None, gamma, beta, mean, var, eps)


def _fold(conv_w: torch.Tensor, bn: dict, eps: float):
    return fold_conv_bn(conv_w, None, bn["weight"], bn["bias"], bn["running_mean"], bn["running_var"], eps)


def fuse_mobileone_block(
    conv_branches: list,
    scale_branch: Optional[tuple],
    skip_bn: Optional[dict],
    kernel_size: int,
    channels_out: int,
    groups: int,
    eps: float = 1e-5,
) -> tuple:
    """MobileOneBlock fold: sum of k x k conv+BN branches, a 1x1 conv+BN
    scale branch (padded to k x k), and a BN identity skip.

    Each branch is (conv_weight, bn_dict) where bn_dict has
    weight/bias/running_mean/running_var. Returns fused (w, b).
    """
    folded = [_fold(conv_w, bn, eps) for conv_w, bn in conv_branches]
    if scale_branch is not None:
        w, b = _fold(scale_branch[0], scale_branch[1], eps)
        folded.append((pad_kernel_to(w, kernel_size), b))
    if skip_bn is not None:
        folded.append(fold_bn_only(channels_out, groups, kernel_size, skip_bn["weight"], skip_bn["bias"],
                                   skip_bn["running_mean"], skip_bn["running_var"], eps))
    if not folded:
        return None, None
    w_total, b_total = folded[0]
    for w, b in folded[1:]:
        w_total, b_total = w_total + w, b_total + b
    return w_total, b_total


def fuse_repmixer(
    norm_w: torch.Tensor,
    norm_b: torch.Tensor,
    mixer_w: torch.Tensor,
    mixer_b: torch.Tensor,
    layer_scale: Optional[torch.Tensor],
    channels: int,
    kernel_size: int = 3,
) -> tuple:
    """RepMixer fold (FastViT eq.): out = x + ls*(mixer(x) - norm(x))
    -> single dw conv  w = I + ls*(w_mixer - w_norm).

    ``norm_w``/``mixer_w`` are the already-BN-folded depthwise branch kernels
    (``fuse_mobileone_block`` on each first). ``layer_scale`` is the
    per-channel gamma or None.
    """
    ident = identity_kernel(channels, channels, kernel_size)
    delta_w = mixer_w - norm_w
    delta_b = mixer_b - norm_b
    if layer_scale is not None:
        delta_w = delta_w * layer_scale.reshape(-1, 1, 1, 1)
        delta_b = delta_b * layer_scale.reshape(-1)
    return ident + delta_w, delta_b


def fuse_repcpe(pe_w: torch.Tensor, pe_b: torch.Tensor, channels: int, kernel_size: int = 7) -> tuple:
    """RepCPE fold: out = x + conv(x) -> w = I + w_pe."""
    return identity_kernel(channels, channels, kernel_size) + pe_w, pe_b


def fuse_large_kernel_conv(
    lkb_w: torch.Tensor,
    lkb_bn: dict,
    small_w: Optional[torch.Tensor],
    small_bn: Optional[dict],
    kernel_size: int,
    eps: float = 1e-5,
) -> tuple:
    """ReparamLargeKernelConv fold: 7x7 conv+BN plus center-padded 3x3 conv+BN."""
    w, b = _fold(lkb_w, lkb_bn, eps)
    if small_w is not None:
        ws, bs = _fold(small_w, small_bn, eps)
        w = w + pad_kernel_to(ws, kernel_size)
        b = b + bs
    return w, b


def bn_to_affine(bn: dict, eps: float = 1e-5) -> tuple:
    """Inference BatchNorm -> per-channel (scale, bias) for ChannelAffine."""
    scale = bn["weight"] / sqrt_rounded(bn["running_var"] + eps)
    bias = bn["bias"] - bn["running_mean"] * scale
    return scale, bias
