"""Masked GQA flash attention: CUDA kernel wrapper and its plain version.

Counterpart of ``vla_fastvlm_tpu/ops/pallas/flash_attention.py``
(``flash_attention`` -> ``_flash_attention_forward`` -> ``_attn_kernel``).
The kernel is ``csrc/flash_attention.cu`` (hand-written for sm_90a; its
header says what bounds it and how the design answers that).

- ``flash_attention(q, k, v, kv_mask, causal, scale)`` keeps the JAX layout:
  ``(B, T, N, D) x (B, S, K, D) -> (B, T, N, D)``. On a CUDA tensor it
  launches the kernel (bf16 or fp32, head_dim 64 or 128, contiguous, any S:
  the resident instance where K/V of one head fit a block's shared memory,
  the streamed one above that) or raises; on a CPU tensor it runs
  ``flash_attention_reference``.
- ``flash_attention_streamed`` launches the streamed instance at any S, so
  the two can be checked and timed against each other.
- ``flash_attention_reference`` follows ``_xla_reference``.
- ``flash_attention.launches`` counts kernel launches (nothing else adds to it).
- The backward recomputes through the plain version, as the JAX ``_bwd``
  does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..attention import NEG_INF
from . import _build


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor,
    causal: bool,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Unfused attention with the kernel's semantics (``_xla_reference``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n, kh = q.shape[2], k.shape[2]
    if n != kh:
        rep = n // kh
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("btnd,bsnd->bnts", q.float(), k.float()) * scale
    allowed = (kv_mask > 0)[:, None, None, :]
    if causal:
        t, s = q.shape[1], k.shape[1]
        q_pos = torch.arange(t, device=q.device)[:, None]
        k_pos = torch.arange(s, device=q.device)[None, :]
        allowed = allowed & (k_pos <= q_pos)[None, None]
    logits = torch.where(allowed, logits, torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnts,bsnd->btnd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_kernel_shapes(q, k, v, kv_mask) -> None:
    """Raise unless the kernel takes these dtypes, shapes and layouts."""
    b, t, n, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes bf16 or fp32 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {d}")
    if k.shape != (b, s, kh, d) or v.shape != k.shape or n % kh != 0:
        raise ValueError(f"flash kernel shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if tuple(kv_mask.shape) != (b, s):
        raise ValueError(f"kv_mask must be (B, S) = {(b, s)}, got {tuple(kv_mask.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash kernel takes contiguous tensors; {name} is not")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def _launch(q, k, v, kv_mask, causal: bool, scale: float, streamed: bool = False) -> torch.Tensor:
    check_kernel_shapes(q, k, v, kv_mask)
    b, t, n, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _build.launcher("flash_attention", "flash_attention_fwd", 5,
                         [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, t, s, n, kh, d, int(bool(causal)), float(scale), _DTYPES[q.dtype], int(streamed), stream,
        )
    _build.check(status, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.causal, ctx.scale = causal, scale
        return _launch(q, k, v, kv_mask, causal, scale)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, kv_mask = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            out = flash_attention_reference(*qkv, kv_mask, ctx.causal, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, qkv, grad)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused masked attention: (B,T,N,D) x (B,S,K,D) -> (B,T,N,D).

    ``kv_mask`` is (B, S) with 1 at valid key positions; causality is by
    absolute position within the sequence (prefill layout).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    return _FlashAttention.apply(q, k, v, kv_mask, causal, scale)


flash_attention.launches = 0


def flash_attention_streamed(q, k, v, kv_mask, causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """The streamed instance of the kernel at any S (CUDA tensors only)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_streamed launches the CUDA kernel; got a tensor on {q.device}")
    return _launch(q, k, v, kv_mask, causal, q.shape[-1] ** -0.5 if scale is None else scale, streamed=True)
