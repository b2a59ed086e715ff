"""Paged-KV attention: CUDA kernel wrappers and their plain versions.

Counterpart of ``vla_fastvlm_tpu/ops/pallas/paged_attention.py``: at W = 1
``paged_attention_decode`` -> ``paged_attention_window`` ->
``_paged_attn_kernel`` / ``_paged_attn_kernel_int8`` -> ``_attend_last_page``,
and at W > 1 the same ``paged_attention_window`` over a speculative verify
window. Two hand-written kernels for sm_90a, each with a header that says
what bounds it and how the design answers that: ``csrc/paged_attention.cu``
(W = 1) and ``csrc/paged_window.cu`` (W > 1).

- ``paged_attention_decode(q, pool_k, pool_v, tables, kv_mask, lengths,
  k_new, v_new, pool_k_scale=, pool_v_scale=, scale=)``: one query token per
  slot, ``q`` (B, N, D) against pools (P_total, K, page, D) read through
  ``tables`` (B, P_slot), plus the current token's ``k_new``/``v_new``
  (B, K, D) as one extra column -> (B, N, D). int8 pools come with their
  (P_total, K, page) float32 scale pools.
- ``paged_attention_window(q, ...)``: the verify window, ``q`` (B, W, N, D)
  and ``k_new``/``v_new`` (B, W, K, D) with 2 <= W <= 9; window position i
  attends the stored positions plus window positions <= i -> (B, W, N, D).
- On a CUDA tensor each launches its kernel (bf16 or fp32 queries, pools of
  the query dtype or int8, head_dim 64 or 128, N / K <= 8, page a power of
  two up to 64) or raises; on a CPU tensor each runs its plain version, the
  W-token gather path ``ops.attention.paged_attention_gathered``.
- ``lengths`` (B,) is each slot's write cursor. The kernels do not read it:
  like the Pallas kernel they rely on the server's invariant that
  ``kv_mask`` marks only positions below the cursor. The plain version
  inserts the new rows there.
- ``.launches`` on each wrapper counts its kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..attention import paged_attention_gathered
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_REP = 8  # query heads per KV head the kernels are instantiated for
MAX_PAGE = 64
MAX_WINDOW = 9  # verify window positions (k <= 8 draft tokens)


def paged_attention_decode_reference(
    q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new,
    pool_k_scale=None, pool_v_scale=None, scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather the window, insert the new row at the cursor, dense attention."""
    return paged_attention_gathered(
        q[:, None], pool_k, pool_v, tables, kv_mask, lengths, k_new[:, None], v_new[:, None],
        pool_k_scale, pool_v_scale, scale,
    )[:, 0]


# The window kernel's plain version: the W-token gather path itself.
paged_attention_window_reference = paged_attention_gathered


def check_kernel_shapes(q, pool_k, pool_v, tables, kv_mask, k_new, v_new, pool_k_scale, pool_v_scale) -> None:
    """Raise unless a kernel takes these dtypes, shapes and layouts: the
    decode kernel's q (B, N, D) with k_new / v_new (B, K, D), or the window
    kernel's q (B, W, N, D) with k_new / v_new (B, W, K, D), 2 <= W <= 9."""
    if q.ndim not in (3, 4) or pool_k.ndim != 4:
        raise ValueError(f"paged kernels take q (B, N, D) or (B, W, N, D) and pools (P, K, page, D); got "
                         f"q{tuple(q.shape)} pool{tuple(pool_k.shape)}")
    window = q.shape[1:-2] if q.ndim == 4 else ()
    if window and not 2 <= window[0] <= MAX_WINDOW:
        raise ValueError(f"paged window kernel takes 2 <= W <= {MAX_WINDOW} window positions, got W={window[0]}")
    b, n, d = q.shape[0], q.shape[-2], q.shape[-1]
    _, kh, page, _ = pool_k.shape
    if q.dtype not in _DTYPES or k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError(f"paged kernel takes bf16 or fp32 q/k_new/v_new of one dtype, got "
                         f"{q.dtype}/{k_new.dtype}/{v_new.dtype}")
    quantized = pool_k.dtype == torch.int8
    if pool_v.dtype != pool_k.dtype or pool_k.dtype not in (q.dtype, torch.int8):
        raise ValueError(f"paged kernel takes pools of the query dtype or int8, got {pool_k.dtype}/{pool_v.dtype}")
    if quantized != (pool_k_scale is not None) or quantized != (pool_v_scale is not None):
        raise ValueError("int8 pools need both scale pools, and only int8 pools take them")
    if d not in (64, 128):
        raise ValueError(f"paged kernel takes head_dim 64 or 128, got {d}")
    if n % kh or n // kh > MAX_REP:
        raise ValueError(f"paged kernel takes N a multiple of K with N / K <= {MAX_REP}, got N={n} K={kh}")
    if page > MAX_PAGE or page & (page - 1):
        raise ValueError(f"paged kernel takes a page size that is a power of two up to {MAX_PAGE}, got {page}")
    if tuple(pool_v.shape) != tuple(pool_k.shape) or tuple(pool_k.shape[3:]) != (d,):
        raise ValueError(f"pool shapes {tuple(pool_k.shape)}/{tuple(pool_v.shape)} for head_dim {d}")
    if tables.ndim != 2 or tables.shape[0] != b:
        raise ValueError(f"tables must be (B, P_slot) with B={b}, got {tuple(tables.shape)}")
    if tuple(kv_mask.shape) != (b, tables.shape[1] * page):
        raise ValueError(f"kv_mask must be (B, P_slot * page) = {(b, tables.shape[1] * page)}, "
                         f"got {tuple(kv_mask.shape)}")
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if tuple(x.shape) != (b, *window, kh, d):
            raise ValueError(f"{name} must be {'(B, W, K, D)' if window else '(B, K, D)'} = {(b, *window, kh, d)}, "
                             f"got {tuple(x.shape)}")
    if quantized:
        for name, x in (("pool_k_scale", pool_k_scale), ("pool_v_scale", pool_v_scale)):
            if tuple(x.shape) != tuple(pool_k.shape[:3]):
                raise ValueError(f"{name} must be (P, K, page) = {tuple(pool_k.shape[:3])}, got {tuple(x.shape)}")
    for name, x in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v), ("k_new", k_new), ("v_new", v_new)):
        if not x.is_contiguous():
            raise ValueError(f"paged kernel takes contiguous tensors; {name} is not")
        if x.device.type == "cuda" and x.data_ptr() % 16:
            raise ValueError(f"paged kernel takes 16-byte aligned tensors; {name} is not")
    for name, x in (("pool_k", pool_k), ("pool_v", pool_v), ("tables", tables), ("kv_mask", kv_mask),
                    ("k_new", k_new), ("v_new", v_new)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def scale_window(scale_pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(P_total, K, page) scales -> each slot's (B, K, S_max) float32 window,
    gathered outside the kernel as the Pallas launcher does."""
    b, p_slot = tables.shape
    _, kh, page = scale_pool.shape
    g = scale_pool[tables.long()]  # (B, P_slot, K, page)
    return g.permute(0, 2, 1, 3).reshape(b, kh, p_slot * page).float().contiguous()


def _launch(q, pool_k, pool_v, tables, kv_mask, k_new, v_new, pool_k_scale, pool_v_scale, scale) -> torch.Tensor:
    """Launch the decode kernel (q (B, N, D)) or the window kernel (q (B, W, N, D))."""
    check_kernel_shapes(q, pool_k, pool_v, tables, kv_mask, k_new, v_new, pool_k_scale, pool_v_scale)
    b, n, d = q.shape[0], q.shape[-2], q.shape[-1]
    _, kh, page, _ = pool_k.shape
    p_slot = tables.shape[1]
    quantized = pool_k.dtype == torch.int8
    tables_i = tables.to(torch.int32).contiguous()
    mask_i = kv_mask.to(torch.int32).contiguous()
    if quantized:
        ksc, vsc = scale_window(pool_k_scale, tables), scale_window(pool_v_scale, tables)
        scale_ptrs = (ksc.data_ptr(), vsc.data_ptr())
    else:
        scale_ptrs = (None, None)
    out = torch.empty_like(q)
    if q.ndim == 3:
        symbol, wrapper, shape = "paged_attention_fwd", paged_attention_decode, (b, n, kh, d, page, p_slot)
        fn = _build.launcher("paged_attention", symbol, 10,
                             [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int])
    else:
        symbol, wrapper, shape = "paged_window_fwd", paged_attention_window, (b, q.shape[1], n, kh, d, page, p_slot)
        fn = _build.launcher("paged_window", symbol, 10,
                             [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tables_i.data_ptr(), mask_i.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), *scale_ptrs, out.data_ptr(),
            *shape, float(scale), _DTYPES[q.dtype], int(quantized), stream,
        )
    _build.check(status, symbol)
    wrapper.launches += 1
    return out


def _dispatch(q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new, pool_k_scale, pool_v_scale,
              scale) -> torch.Tensor:
    """The plain version on a CPU tensor, the kernel on a CUDA one."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        if q.ndim == 3:
            return paged_attention_decode_reference(
                q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new, pool_k_scale, pool_v_scale, scale,
            )
        return paged_attention_gathered(
            q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new, pool_k_scale, pool_v_scale, scale,
        )
    if q.device.type != "cuda":
        what = "paged_attention_decode" if q.ndim == 3 else "paged_attention_window"
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {q.device}")
    return _launch(q, pool_k, pool_v, tables, kv_mask, k_new, v_new, pool_k_scale, pool_v_scale, scale)


def paged_attention_decode(
    q: torch.Tensor,  # (B, N, D) post-RoPE queries, one token per slot
    pool_k: torch.Tensor,  # (P_total, K, page, D)
    pool_v: torch.Tensor,  # (P_total, K, page, D)
    tables: torch.Tensor,  # (B, P_slot) physical page ids (0 = trash)
    kv_mask: torch.Tensor,  # (B, S_max) stored-position validity
    lengths: torch.Tensor,  # (B,) write cursors (the plain version's insert point)
    k_new: torch.Tensor,  # (B, K, D) current token K (post-RoPE)
    v_new: torch.Tensor,  # (B, K, D)
    *,
    pool_k_scale: Optional[torch.Tensor] = None,  # (P_total, K, page) int8 pools
    pool_v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step of attention against a paged KV pool -> (B, N, D)."""
    if q.ndim != 3:
        raise ValueError(f"paged_attention_decode takes q (B, N, D), got {tuple(q.shape)}")
    return _dispatch(q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new,
                     pool_k_scale, pool_v_scale, scale)


def paged_attention_window(
    q: torch.Tensor,  # (B, W, N, D) post-RoPE queries of the verify window
    pool_k: torch.Tensor,  # (P_total, K, page, D)
    pool_v: torch.Tensor,  # (P_total, K, page, D)
    tables: torch.Tensor,  # (B, P_slot) physical page ids (0 = trash)
    kv_mask: torch.Tensor,  # (B, S_max) stored-position validity, all below the window
    lengths: torch.Tensor,  # (B,) write cursors: window position i sits at lengths + i
    k_new: torch.Tensor,  # (B, W, K, D) the window's K (post-RoPE)
    v_new: torch.Tensor,  # (B, W, K, D)
    *,
    pool_k_scale: Optional[torch.Tensor] = None,  # (P_total, K, page) int8 pools
    pool_v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """A speculative verify window (W > 1) against a paged KV pool -> (B, W, N, D)."""
    if q.ndim != 4:
        raise ValueError(f"paged_attention_window takes q (B, W, N, D), got {tuple(q.shape)}")
    return _dispatch(q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new,
                     pool_k_scale, pool_v_scale, scale)


paged_attention_decode.launches = 0
paged_attention_window.launches = 0
