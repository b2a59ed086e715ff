"""Image preprocessing ops: letterbox resize + pad + normalize
(counterpart of ``vla_fastvlm_tpu/ops/image.py``).

Reproduces the reference letterbox math: ``ratio = max(w/W, h/H)``,
truncating-int resized dims, bilinear resize with half-pixel centers (torch
``align_corners=False``, no antialias) as two matmuls with static
interpolation matrices, then pad on the top and left to the square target.
Runs on the tensor's own device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _interp_matrix(in_size: int, out_size: int, dtype=np.float32) -> np.ndarray:
    """(out, in) bilinear interpolation matrix, half-pixel centers
    (torch ``align_corners=False``, no antialias)."""
    src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = src.astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (src - lo).astype(dtype)
    mat = np.zeros((out_size, in_size), dtype)
    rows = np.arange(out_size)
    mat[rows, lo] += 1.0 - w_hi
    mat[rows, hi] += w_hi
    return mat


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) as ``R_h @ img @ R_w^T`` in fp32."""
    _, _, in_h, in_w = img.shape
    if (in_h, in_w) == (out_h, out_w):
        return img
    r_h = torch.from_numpy(_interp_matrix(in_h, out_h)).to(img.device)
    r_w = torch.from_numpy(_interp_matrix(in_w, out_w)).to(img.device)
    out = torch.einsum("oh,bchw,pw->bcop", r_h, img.float(), r_w)
    return out.to(img.dtype)


def resize_with_pad(
    img: torch.Tensor, width: int, height: int, pad_value: float = 0.0
) -> torch.Tensor:
    """Resize preserving aspect ratio, then pad top/left to (height, width)."""
    if img.ndim != 4:
        raise ValueError(f"(B,C,H,W) expected, but got shape {tuple(img.shape)}")
    cur_height, cur_width = img.shape[2:]
    if (cur_height, cur_width) == (height, width):
        # Already target-sized: the resize would be an exact identity.
        return img
    ratio = max(cur_width / width, cur_height / height)
    resized_height = int(cur_height / ratio)
    resized_width = int(cur_width / ratio)
    resized = resize_bilinear(img, resized_height, resized_width)
    pad_height = max(0, int(height - resized_height))
    pad_width = max(0, int(width - resized_width))
    # F.pad order: (w_left, w_right, h_top, h_bottom)
    return F.pad(resized, (pad_width, 0, pad_height, 0), value=pad_value)


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize a [0,1] (B, 3, H, W) batch."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device).reshape(1, 3, 1, 1)
    return (img - mean) / std


def prepare_image_batch(
    img: torch.Tensor,
    size: int,
    resize_with_padding: bool = True,
    pad_value: float = 0.0,
    normalize: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """(B, C, H, W) float in [0,1] -> (B, 3, size, size), the model-facing layout.

    Grayscale is broadcast to 3 channels and extra channels truncated, then
    letterbox (or plain bilinear square resize), then optional ImageNet
    normalization, then the cast to ``dtype``.
    """
    if img.shape[1] == 1:
        img = img.expand(img.shape[0], 3, *img.shape[2:])
    elif img.shape[1] > 3:
        img = img[:, :3]

    if resize_with_padding:
        img = resize_with_pad(img, width=size, height=size, pad_value=pad_value)
    elif tuple(img.shape[-2:]) != (size, size):
        img = resize_bilinear(img, size, size)

    if normalize:
        img = normalize_imagenet(img)
    if dtype is not None:
        img = img.to(dtype)
    return img
