"""Ops of the port: norms, RoPE, attention, image prep, and the CUDA kernels.

The ``attention`` entry point is imported from ``ops.attention`` (the name
is left to the submodule here).
"""

from .attention import dot_product_attention, make_attention_bias, repeat_kv
from .image import normalize_imagenet, prepare_image_batch, resize_bilinear, resize_with_pad
from .norms import layer_norm, rms_norm
from .rope import apply_rope, rope_cos_sin

__all__ = [
    "apply_rope",
    "dot_product_attention",
    "layer_norm",
    "make_attention_bias",
    "normalize_imagenet",
    "prepare_image_batch",
    "repeat_kv",
    "resize_bilinear",
    "resize_with_pad",
    "rms_norm",
    "rope_cos_sin",
]
