"""Attention ops: the plain masked attention plus dispatch to the flash and
paged-attention kernels (counterpart of ``vla_fastvlm_tpu/ops/attention.py``).

``dot_product_attention`` is exact masked GQA attention with an fp32
softmax; it is what every kernel is checked against. ``attention`` is the
entry point the decoder calls: with the structured mask (``bias is None``,
``kv_mask`` given) and ``impl`` "auto" or "flash" it goes to the port's
flash kernel (``ops/kernels/flash_attention.py``), which launches the CUDA
kernel on a CUDA tensor or raises; it never gives way to the plain path on
the card. ``impl="xla"`` (the name is kept for config parity with the JAX
package) always runs the plain path. ``paged_attention`` is the decode
tick's (W = 1) or speculative verify window's (W > 1) attention against a
paged KV pool, dispatched the same way to ``ops/kernels/paged_attention.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-but-finite: avoids NaN from (-inf) - (-inf) in softmax


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand KV heads for grouped-query attention: (B, S, K, D) -> (B, S, K*n_rep, D)."""
    if n_rep == 1:
        return x
    b, s, k, d = x.shape
    return x[:, :, :, None, :].expand(b, s, k, n_rep, d).reshape(b, s, k * n_rep, d)


def make_attention_bias(
    q_positions: torch.Tensor,  # (B, T) absolute positions of queries
    kv_positions: torch.Tensor,  # (B, S) absolute positions of keys
    kv_mask: torch.Tensor,  # (B, S) bool/int, 1 where the key is a real token
    causal: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Additive attention bias of shape (B, 1, T, S): 0 where allowed, NEG_INF elsewhere."""
    allowed = kv_mask.bool()[:, None, None, :]  # (B, 1, 1, S)
    allowed = allowed.expand(kv_mask.shape[0], 1, q_positions.shape[1], kv_mask.shape[1])
    if causal:
        causal_ok = kv_positions[:, None, None, :] <= q_positions[:, None, :, None]
        allowed = allowed & causal_ok
    zero = torch.zeros((), dtype=dtype, device=kv_mask.device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=kv_mask.device)
    return torch.where(allowed, zero, neg)


def dot_product_attention(
    q: torch.Tensor,  # (B, T, N, D)
    k: torch.Tensor,  # (B, S, K, D)
    v: torch.Tensor,  # (B, S, K, D)
    bias: Optional[torch.Tensor] = None,  # (B, 1, T, S) additive
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact masked attention with fp32 softmax. Returns (B, T, N, D)."""
    n_heads, kv_heads = q.shape[2], k.shape[2]
    if n_heads != kv_heads:
        rep = n_heads // kv_heads
        k = repeat_kv(k, rep)
        v = repeat_kv(v, rep)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # fp32 logits from the activation-dtype operands (JAX: preferred fp32).
    logits = torch.einsum("btnd,bsnd->bnts", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnts,bsnd->btnd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def attention(
    q: torch.Tensor,  # (B, T, N, D)
    k: torch.Tensor,  # (B, S, K, D)
    v: torch.Tensor,  # (B, S, K, D)
    *,
    bias: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention entry point with flash-kernel dispatch.

    - structured mask (``kv_mask`` + ``causal``, prefill layout) with
      ``impl`` "auto" or "flash" (one path): the flash kernel's wrapper, which
      launches the CUDA kernel on a CUDA tensor, raising on a shape the kernel
      does not take, and runs its plain version on a CPU one. On a CPU tensor
      "flash" also holds the input to the kernel's shape rules.
    - additive ``bias`` or ``impl="xla"``: the plain path.
    """
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if bias is None and kv_mask is not None and impl != "xla":
        from .kernels.flash_attention import check_kernel_shapes, flash_attention

        if impl == "flash":
            check_kernel_shapes(q, k, v, kv_mask)
        return flash_attention(q, k, v, kv_mask, causal, scale)

    if bias is None:
        b, t = q.shape[0], q.shape[1]
        s = k.shape[1]
        positions = torch.arange(t, device=q.device)[None].expand(b, t)
        kv_positions = torch.arange(s, device=q.device)[None].expand(b, s)
        mask = kv_mask if kv_mask is not None else torch.ones((b, s), dtype=torch.int32, device=q.device)
        bias = make_attention_bias(positions, kv_positions, mask, causal=causal)
    return dot_product_attention(q, k, v, bias=bias, scale=scale)


def paged_attention_gathered(
    q: torch.Tensor,  # (B, W, N, D) post-RoPE decode/verify queries
    pool_k: torch.Tensor,  # (P_total, K, page, D) physical page pool
    pool_v: torch.Tensor,  # (P_total, K, page, D)
    tables: torch.Tensor,  # (B, P_slot) physical page ids (0 = trash)
    kv_mask: torch.Tensor,  # (B, S_max) stored-position validity
    lengths: torch.Tensor,  # (B,) slot write cursor of the current window
    k_new: torch.Tensor,  # (B, W, K, D) current window K (post-RoPE)
    v_new: torch.Tensor,  # (B, W, K, D)
    pool_k_scale: Optional[torch.Tensor] = None,  # (P_total, K, page) int8 pools
    pool_v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The plain paged attention: gather each slot's window through its table,
    insert the new rows at the cursor, then dense slot-causal attention
    (the XLA fallback of the JAX ``paged_attention``). Returns (B, W, N, D)."""
    b, w = q.shape[:2]
    p_slot, page = tables.shape[1], pool_k.shape[2]
    s_max = p_slot * page
    tables = tables.long()

    def gather(pool):
        g = pool[tables]  # (B, P_slot, K, page[, D])
        if pool.ndim == 4:
            return g.permute(0, 1, 3, 2, 4).reshape(b, s_max, pool.shape[1], pool.shape[3])
        return g.permute(0, 1, 3, 2).reshape(b, s_max, pool.shape[1])  # scales

    rows = torch.arange(b, device=q.device)[:, None]
    cols = lengths.long()[:, None] + torch.arange(w, device=q.device)[None, :]  # (B, W)

    def insert(win, new):
        win[rows, cols] = new.to(win.dtype)
        return win

    if pool_k_scale is not None:
        from .quant import dequantize_kv

        win_k = insert(dequantize_kv(gather(pool_k), gather(pool_k_scale), q.dtype), k_new)
        win_v = insert(dequantize_kv(gather(pool_v), gather(pool_v_scale), q.dtype), v_new)
    else:
        win_k = insert(gather(pool_k), k_new)
        win_v = insert(gather(pool_v), v_new)
    # scatter_ with a scalar stays on the device (also under CUDA graph capture).
    mask = kv_mask.to(torch.int32).scatter(1, cols, 1)
    kv_positions = torch.arange(s_max, device=q.device)[None, :].expand(b, s_max)
    bias = make_attention_bias(cols, kv_positions, mask, causal=True)
    return dot_product_attention(q, win_k.to(q.dtype), win_v.to(q.dtype), bias=bias, scale=scale)


def paged_attention(
    q: torch.Tensor,  # (B, W, N, D) post-RoPE decode/verify queries
    pool_k: torch.Tensor,  # (P_total, K, page, D) physical page pool
    pool_v: torch.Tensor,  # (P_total, K, page, D)
    tables: torch.Tensor,  # (B, P_slot) physical page ids (0 = trash)
    kv_mask: torch.Tensor,  # (B, S_max) stored-position validity
    lengths: torch.Tensor,  # (B,) slot write cursor of the current window
    k_new: torch.Tensor,  # (B, W, K, D) current window K (post-RoPE)
    v_new: torch.Tensor,  # (B, W, K, D)
    *,
    pool_k_scale: Optional[torch.Tensor] = None,  # (P_total, K, page) int8 pools
    pool_v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention for a W-token window against a paged KV pool -> (B, W, N, D).

    Window position ``i`` sits at slot ``lengths[b] + i`` and attends the
    stored positions where ``kv_mask`` is set plus window positions ``<= i``.
    For int8 pools ``k_new``/``v_new`` are the dequant-roundtripped new rows.

    Dispatch: with ``impl`` "auto" or "flash" on a CUDA tensor, ``W == 1``
    goes to the decode kernel's wrapper and ``W > 1`` (the speculative
    verify window) to the window kernel's (``ops/kernels/paged_attention.py``);
    each launches its CUDA kernel or raises on a shape it does not take, and
    nothing falls back to the plain path. ``impl="xla"`` and CPU tensors run
    ``paged_attention_gathered``.
    """
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl != "xla" and q.device.type != "cpu":
        from .kernels.paged_attention import paged_attention_decode, paged_attention_window

        kw = dict(pool_k_scale=pool_k_scale, pool_v_scale=pool_v_scale, scale=scale)
        if q.shape[1] > 1:
            return paged_attention_window(q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new, **kw)
        return paged_attention_decode(
            q[:, 0], pool_k, pool_v, tables, kv_mask, lengths, k_new[:, 0], v_new[:, 0], **kw,
        )[:, None]
    return paged_attention_gathered(
        q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new,
        pool_k_scale, pool_v_scale, scale,
    )
