"""Attention ops: the plain masked attention plus dispatch to the flash kernel
(counterpart of ``vla_fastvlm_tpu/ops/attention.py``).

``dot_product_attention`` is exact masked GQA attention with an fp32
softmax; it is what every kernel is checked against. ``attention`` is the
entry point the decoder calls: with the structured mask (``bias is None``,
``kv_mask`` given) and ``impl`` "auto" or "flash" it goes to the port's
flash kernel (``ops/kernels/flash_attention.py``), which launches the CUDA
kernel on a CUDA tensor or raises; it never gives way to the plain path on
the card. ``impl="xla"`` (the name is kept for config parity with the JAX
package) always runs the plain path.
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
