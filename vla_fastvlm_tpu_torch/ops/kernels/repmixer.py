"""Fused FastViTHD RepMixer block: CUDA kernel wrapper and its plain version.

Counterpart of ``vla_fastvlm_tpu/ops/pallas/repmixer.py``
(``repmixer_block`` -> ``_repmixer_block_pallas`` -> ``_block_kernel``).
The kernel is ``csrc/repmixer.cu`` (hand-written for sm_90a; its header says
what bounds it and how the design answers that).

- ``repmixer_block(x, w3, b3, w7, b7, w1, b1, w2, b2, gamma)`` takes the JAX
  argument order and shapes: NHWC ``x`` (B, H, W, C), depthwise kernels
  (3, 3, 1, C) / (7, 7, 1, C) or (3, 3, C) / (7, 7, C), ``w1`` (C, F),
  ``w2`` (F, C). On a CUDA tensor it launches the kernel (bf16 or fp32,
  C one of the FastViTHD RepMixer widths 96 / 192 / 384, F % 64 == 0, one
  block's tiles within the card's shared memory: fp32 stops at C = 192) or
  raises; on a CPU tensor it runs ``repmixer_block_reference``.
- ``repmixer_block_reference`` follows ``_repmixer_block_xla``.
- ``repmixer_block.launches`` counts kernel launches.
- The backward recomputes through the plain version, as the JAX VJP does.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build


def _dw_weight(w: torch.Tensor) -> torch.Tensor:
    """(k, k, 1, C) or (k, k, C) depthwise kernel -> (k, k, C)."""
    return w[:, :, 0, :] if w.ndim == 4 else w


def _depthwise_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME depthwise conv of NHWC ``x`` with a (k, k, C) kernel."""
    k, c = w.shape[0], w.shape[-1]
    weight = w.permute(2, 0, 1).unsqueeze(1)  # (C, 1, k, k)
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=k // 2, groups=c)
    return out.permute(0, 2, 3, 1)


def repmixer_block_reference(x, w3, b3, w7, b7, w1, b1, w2, b2, gamma) -> torch.Tensor:
    """Unfused composition (``_repmixer_block_xla``): one rounding per op."""
    dtype = x.dtype
    w3, w7 = _dw_weight(w3).to(dtype), _dw_weight(w7).to(dtype)
    t3 = _depthwise_nhwc(x, w3) + b3.to(dtype)
    t7 = _depthwise_nhwc(t3, w7) + b7.to(dtype)
    hcol = F.gelu(t7 @ w1.to(dtype) + b1.to(dtype), approximate="tanh")
    y = hcol @ w2.to(dtype) + b2.to(dtype)
    return t3 + y * gamma.to(dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Channel widths the kernel is instantiated for (csrc/repmixer.cu, dispatch).
KERNEL_WIDTHS = (96, 192, 384)


@functools.lru_cache(maxsize=None)
def smem_bytes(c: int, dtype: torch.dtype) -> int:
    """Shared memory one block needs at width ``c``; asks the kernel library
    (built on first use)."""
    fn = _build.LIBRARIES.entry("repmixer", "repmixer_smem_bytes", [ctypes.c_int] * 2, ctypes.c_longlong)
    return fn(c, _DTYPES[dtype])


def _kernel_takes(c: int, hidden: int, dtype: torch.dtype, device: torch.device) -> bool:
    if c not in KERNEL_WIDTHS or hidden % 64:
        return False
    index = device.index if device.index is not None else torch.cuda.current_device()
    return smem_bytes(c, dtype) <= _build.smem_per_block(index)


def _launch(x, w3, b3, w7, b7, w1, b1, w2, b2, gamma) -> torch.Tensor:
    if x.dtype not in _DTYPES:
        raise ValueError(f"repmixer kernel takes bf16 or fp32, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("repmixer kernel takes a contiguous NHWC (B, H, W, C) tensor")
    bsz, h, w, c = x.shape
    f = w1.shape[-1]
    dtype = x.dtype
    # Parameters in the activation dtype, contiguous, in the kernel's layout.
    args = [
        _dw_weight(w3), b3, _dw_weight(w7), b7, w1, b1, w2, b2, gamma,
    ]
    args = [a.to(device=x.device, dtype=dtype).contiguous() for a in args]
    expected = [(3, 3, c), (c,), (7, 7, c), (c,), (c, f), (f,), (f, c), (c,), (c,)]
    for a, shape in zip(args, expected):
        if tuple(a.shape) != shape:
            raise ValueError(f"repmixer kernel parameter shape {tuple(a.shape)}, expected {shape}")
    if not _kernel_takes(c, f, dtype, x.device):
        raise ValueError(
            f"repmixer kernel does not take C={c} F={f} in {dtype}: it needs C in "
            f"{KERNEL_WIDTHS}, F % 64 == 0 and one block's tiles within the card's shared memory"
        )
    out = torch.empty_like(x)
    fn = _build.launcher("repmixer", "repmixer_block_fwd", 11, [ctypes.c_int] * 6)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(
            x.data_ptr(), *[a.data_ptr() for a in args], out.data_ptr(),
            bsz, h, w, c, f, _DTYPES[dtype], stream,
        )
    _build.check(status, "repmixer_block_fwd")
    repmixer_block.launches += 1
    return out


class _RepMixerBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _launch(*args)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_() for a in saved]
            out = repmixer_block_reference(*inputs)
            return torch.autograd.grad(out, inputs, grad, allow_unused=True)


def repmixer_block(x, w3, b3, w7, b7, w1, b1, w2, b2, gamma) -> torch.Tensor:
    """Fused RepMixer block: dw3 + [dw7 -> fc1 -> GELU -> fc2] * gamma + resid."""
    if x.device.type == "cpu":
        return repmixer_block_reference(x, w3, b3, w7, b7, w1, b1, w2, b2, gamma)
    if x.device.type != "cuda":
        raise ValueError(f"repmixer_block runs on CUDA or CPU tensors, got {x.device}")
    return _RepMixerBlock.apply(x, w3, b3, w7, b7, w1, b1, w2, b2, gamma)


repmixer_block.launches = 0
