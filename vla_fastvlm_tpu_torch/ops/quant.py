"""Weight and KV-cache quantization (counterpart of ``vla_fastvlm_tpu/ops/quant.py``).

Weights keep the port's ``(out, in)`` layout, where the JAX package stores
``(in, out)`` kernels:

- **int8**: symmetric absmax per output row, codes ``int8 (..., N, K)`` and
  scales ``float32 (..., N)`` (JAX: ``(..., K, N)`` and ``(..., 1, N)``).
  ``"w8a8"`` stores exactly this; only the apply differs.
- **int4**: symmetric absmax per (group of ``G`` input columns, output row),
  ``G = gcd(K, group_size)``. Two codes a byte in ``uint8 (..., N, K/2)``,
  the even k in the low nibble; scales ``float32 (..., K/G, N)``, JAX's
  shape. 4x fewer weight bytes than bf16.

Codes are bit-equal to JAX's on the same float weights: both divide in fp32
and round half to even.

The products are plain torch, as they are XLA ops (no Pallas kernel) in
JAX: the weight-only paths convert the codes to the compute dtype and run
one ``F.linear`` (or, for int4 below ``INT4_DEQUANT_MIN_TOKENS`` tokens, the
grouped partial sums of JAX's decode formulation); ``"w8a8"`` at or above
``W8A8_MIN_TOKENS`` tokens quantizes the activations per token and runs
int8 x int8 -> int32 through ``torch._int_mm``, then the fp32 rescale. A
shape that ``torch._int_mm`` refuses raises; nothing falls back silently.
Both gates are module constants read at each call, so tests can lower them.

``quantize_kv`` / ``dequantize_kv`` are the int8 KV cache's.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

INT8_MAX = 127.0
INT4_MAX = 7.0
# int4 scale group along the contraction axis (JAX's INT4_GROUP).
INT4_GROUP = 128
# Token count at which the int4 product switches from grouped partial sums
# to one contraction over the scaled weights (JAX ``ops/quant.py:161``).
INT4_DEQUANT_MIN_TOKENS = 256
# Token count at which "w8a8" runs the int8 x int8 product; below it the
# weight-only int8 path (JAX ``ops/quant.py:172``).
W8A8_MIN_TOKENS = 1024


def _absmax_quantize(x32: torch.Tensor, dim: int, qmax: float):
    """Symmetric absmax over ``dim`` -> (codes as float, scale with ``dim`` kept)."""
    absmax = x32.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    return torch.round(x32 / scale).clamp(-qmax, qmax), scale


def quantize_kernel(weight: torch.Tensor) -> dict:
    """Float weight ``(..., N, K)`` -> ``{"qweight": int8 (..., N, K), "scale": float32 (..., N)}``."""
    if weight.ndim < 2:
        raise ValueError(f"expected a matmul weight (..., N, K), got {tuple(weight.shape)}")
    q, scale = _absmax_quantize(weight.float(), -1, INT8_MAX)
    return {"qweight": q.to(torch.int8), "scale": scale[..., 0]}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 codes held in ``int8 (..., N, K)`` -> ``uint8 (..., N, K/2)``, the even k in the low nibble."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even input width, got K = {q.shape[-1]}")
    nib = (q.to(torch.int16) & 0xF).to(torch.uint8)
    return nib[..., 0::2] | (nib[..., 1::2] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: ``uint8 (..., N, K/2)`` -> sign-extended ``int8 (..., N, K)``.
    Arithmetic shifts of the bytes as int8 sign-extend each nibble."""
    p = packed.view(torch.int8)
    return torch.stack([(p << 4) >> 4, p >> 4], dim=-1).flatten(-2)


def quantize_kernel_int4(weight: torch.Tensor, group_size: int = INT4_GROUP) -> dict:
    """Float weight ``(..., N, K)`` -> ``{"qweight": uint8 (..., N, K/2), "scale": float32 (..., K/G, N)}``."""
    if weight.ndim < 2:
        raise ValueError(f"expected a matmul weight (..., N, K), got {tuple(weight.shape)}")
    *lead, n, k = weight.shape
    group = math.gcd(k, group_size)
    w = weight.float().reshape(*lead, n, k // group, group)
    q, scale = _absmax_quantize(w, -1, INT4_MAX)
    return {"qweight": pack_int4(q.reshape(weight.shape).to(torch.int8)),
            "scale": scale[..., 0].transpose(-1, -2).contiguous()}


def quantize_activations(x: torch.Tensor):
    """(..., K) float -> (int8 (..., K), float32 (..., 1)): dynamic absmax per row (token)."""
    q, scale = _absmax_quantize(x.float(), -1, INT8_MAX)
    return q.to(torch.int8), scale


def leaf_kind(leaf: Mapping) -> str:
    """"int8", "int4" or "float" for a leaf ``{"weight" | "qweight", ["scale"], ["bias"]}``."""
    if "qweight" not in leaf:
        return "float"
    return "int8" if leaf["qweight"].dtype == torch.int8 else "int4"


def _int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
                 k_offset: int | None = None, k_whole: int | None = None) -> torch.Tensor:
    """x @ dequant(W)^T with per-(group, row) scales, JAX's two formulations:
    grouped partial sums scaled before the sum over groups below
    ``INT4_DEQUANT_MIN_TOKENS`` tokens, else the scaled weights in one
    contraction. ``k_offset``: ``packed`` holds the input positions from
    ``k_offset`` on of a ``k_whole``-wide weight whose whole ``(K/G, N)``
    scales ``scale`` is (a rank's piece of a row-split kernel); its groups
    are then indexed by global position, in sub-groups that no group
    boundary crosses."""
    if packed.ndim != 2:
        raise ValueError(f"int4 apply expects a per-layer (N, K/2) weight, got {tuple(packed.shape)}")
    n = packed.shape[0]
    codes = unpack_int4(packed).to(dtype)
    k = codes.shape[1]
    if k_offset is not None:
        group = k_whole // scale.shape[-2]
        sub = math.gcd(group, k, k_offset)
        starts = torch.arange(k_offset, k_offset + k, sub, device=scale.device)
        scale = scale.index_select(-2, starts // group)
    kg = scale.shape[-2]
    x = x.to(dtype)
    tokens = math.prod(x.shape[:-1])
    sg = scale.to(dtype)  # (K/G, N)
    if tokens >= INT4_DEQUANT_MIN_TOKENS:
        w = (codes.reshape(n, kg, k // kg) * sg.t()[:, :, None]).reshape(n, k)
        return F.linear(x, w)
    xg = x.reshape(-1, kg, k // kg).transpose(0, 1)  # (K/G, M, G)
    partial = torch.bmm(xg, codes.reshape(n, kg, k // kg).permute(1, 2, 0))  # (K/G, M, N)
    y = (partial * sg[:, None, :]).sum(dim=0)
    return y.reshape(*x.shape[:-1], n)


def _int8_matmul_w8a8(x: torch.Tensor, qweight: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x @ dequant(W)^T as int8 x int8 -> int32 (``torch._int_mm``) at or
    above ``W8A8_MIN_TOKENS`` tokens, rescaled in fp32 by the per-token and
    per-row scales; the weight-only int8 product below."""
    if qweight.ndim != 2:
        raise ValueError(f"w8a8 apply expects a per-layer (N, K) weight, got {tuple(qweight.shape)}")
    if math.prod(x.shape[:-1]) < W8A8_MIN_TOKENS:
        return F.linear(x.to(dtype), qweight.to(dtype)) * scale.to(dtype)
    xq, xscale = quantize_activations(x)
    lead = x.shape[:-1]
    acc = torch._int_mm(xq.reshape(-1, xq.shape[-1]), qweight.t())
    y = acc.reshape(*lead, -1).float() * xscale * scale.float()
    return y.to(dtype)


def dense_apply(x: torch.Tensor, leaf: Mapping, dtype: torch.dtype, act_quant: bool = False) -> torch.Tensor:
    """``x @ W^T (+ b)`` in ``dtype`` for a maybe-quantized leaf
    ``{"weight" | "qweight", ["scale"], ["bias"]}``; ``act_quant`` takes
    the w8a8 product for int8 weights."""
    kind = leaf_kind(leaf)
    if kind == "int8":
        if act_quant:
            y = _int8_matmul_w8a8(x, leaf["qweight"], leaf["scale"], dtype)
        else:
            y = F.linear(x.to(dtype), leaf["qweight"].to(dtype)) * leaf["scale"].to(dtype)
    elif kind == "int4":
        y = _int4_matmul(x, leaf["qweight"], leaf["scale"], dtype, leaf.get("k_offset"), leaf.get("k_whole"))
    else:
        y = F.linear(x.to(dtype), leaf["weight"].to(dtype))
    bias = leaf.get("bias")
    if bias is not None:
        y = y + bias.to(dtype)
    return y


def fused_dense_apply(x: torch.Tensor, leaves: Sequence[Mapping], dtype: torch.dtype,
                      act_quant: bool = False) -> torch.Tensor:
    """One product over leaves concatenated along the output axis (codes
    stay int8 or packed, scales concatenate beside them); a group that
    mixes kinds raises, as in JAX. Biases: all or none."""
    kinds = sorted({leaf_kind(leaf) for leaf in leaves})
    if len(kinds) > 1:
        raise ValueError(f"fused projection group mixes kernel kinds {kinds}")
    key = "weight" if kinds[0] == "float" else "qweight"
    fused = {key: torch.cat([leaf[key] for leaf in leaves], dim=0)}
    if kinds[0] != "float":
        fused["scale"] = torch.cat([leaf["scale"] for leaf in leaves], dim=-1)
    if leaves[0].get("bias") is not None:
        fused["bias"] = torch.cat([leaf["bias"] for leaf in leaves], dim=-1)
    return dense_apply(x, fused, dtype, act_quant)


def quantize_kv(x: torch.Tensor):
    """(..., D) float K/V values -> (int8 values, (...,) float32 scales).

    Symmetric absmax over the head dim: one scale per (position, kv head);
    the scale is 1 where the absmax is 0. Rounds half to even, as
    ``jnp.round`` does.
    """
    q, scale = _absmax_quantize(x.float(), -1, INT8_MAX)
    return q.to(torch.int8), scale[..., 0]


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``quantize_kv``: int8 (..., D) + (...,) scales -> ``dtype``."""
    return q.to(dtype) * scale[..., None].to(dtype)
