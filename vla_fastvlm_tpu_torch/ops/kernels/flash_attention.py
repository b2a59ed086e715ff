"""Masked GQA flash attention: CUDA kernel wrapper and its plain versions.

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
- ``flash_plan`` gives the rows a block takes and its warps, from the shapes.
- ``flash_attention_reference`` follows ``_xla_reference``;
  ``flash_attention_tiled_reference`` is the kernel's own arithmetic (packed
  rows, key ranges skipped 16 keys at a time, online softmax) in plain torch,
  for tests.
- ``flash_attention.launches`` counts kernel launches (nothing else adds to it).
- The backward recomputes through the plain version, as the JAX ``_bwd``
  does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

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
TILE_ROWS = 16  # packed (position, query head) rows of a warp's tile
MAX_WARPS = 8  # warps a block (csrc/flash_attention.cu MAX_WARPS)
KB, KS = 32, 16  # keys per softmax block and per skipped step (csrc/flash_attention.cu)


def flash_plan(t: int, n: int, kh: int, d: int) -> Tuple[int, int]:
    """(tiles, warps) of a launch, from the shapes alone: the 16-row tiles
    of packed (position, query head) rows a block takes, and the resident
    instance's warps a block (the streamed one runs a warp a tile).

    A (batch row, KV head) has ``t * n / kh`` rows, ``ceil(rows / 16)``
    tiles, cut into the fewest blocks of at most 8 tiles, as even as whole
    tiles allow. At head_dim 128 a warp runs one tile; at 64 two in turn
    (blocks of 4 warps, 4 of them to an SM), so the tiles are rounded up to
    an even count. Both are the fastest of the sweep in ``chip_smoke.py
    --only flash`` (PERF.md)."""
    total = -(-t * (n // kh) // TILE_ROWS)
    blocks = -(-total // MAX_WARPS)
    tiles = -(-total // blocks)
    if d == 128 or tiles == 1:
        return tiles, tiles
    tiles += tiles % 2
    return tiles, tiles // 2


def _allowed_span(kv_mask: torch.Tensor):
    """Per batch row: the first allowed key (S when none) and the last
    allowed key + 1 (0 when none)."""
    s = kv_mask.shape[1]
    allowed = kv_mask > 0
    idx = torch.arange(s, device=kv_mask.device)
    first = torch.where(allowed, idx, s).amin(1)
    last = torch.where(allowed, idx + 1, 0).amax(1)
    return first.tolist(), last.tolist()


def tile_key_range(first: int, last: int, p_lo: int, p_hi: int, s: int, causal: bool) -> Tuple[int, int]:
    """Keys [lo, hi) a tile of rows at positions p_lo .. p_hi visits, as
    ``key_range`` in the kernel: when every row has an allowed key at or
    before its position, from the step holding the first allowed key to the
    last allowed key (causal: also to p_hi) + 1; else all S keys."""
    if first < s and (not causal or first <= p_lo):
        return first // KS * KS, (min(last, p_hi + 1) if causal else last)
    return 0, s


def flash_attention_tiled_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor,
    causal: bool,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The resident kernel's arithmetic in plain torch, for tests; the main
    path never runs it.

    The rows of a (batch row, KV head) are its (position, query head) pairs,
    position-major (row r: position r // rep, head r % rep), cut into tiles
    of 16. Each tile visits the keys ``tile_key_range`` gives, in whole
    16-key steps from lo (keys past S take no part), in softmax blocks of 32
    with an online softmax: masked logits -1e30, probabilities rounded to
    the value dtype relative to the running maximum before P.V, fp32 sums."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, t, n, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    rep, rows = n // kh, t * (n // kh)
    qp = q.float().reshape(b, t, kh, rep, d).permute(0, 2, 1, 3, 4).reshape(b, kh, rows, d)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # (B, K, S, D)
    allowed = kv_mask > 0
    first, last = _allowed_span(kv_mask)
    pos = torch.arange(rows, device=q.device) // rep
    out = torch.empty(b, kh, rows, d, device=q.device)
    for bi in range(b):
        for r0 in range(0, rows, TILE_ROWS):
            r1 = min(r0 + TILE_ROWS, rows)
            lo, hi = tile_key_range(first[bi], last[bi], r0 // rep, (r1 - 1) // rep, s, causal)
            end = min(-(-hi // KS) * KS, s)  # whole steps; keys past S take no part
            m = torch.full((kh, r1 - r0), -float("inf"), device=q.device)
            l = torch.zeros_like(m)
            o = torch.zeros(kh, r1 - r0, d, device=q.device)
            for k0 in range(lo, hi, KB):
                k1 = min(k0 + KB, end)
                x = torch.einsum("krd,ksd->krs", qp[bi, :, r0:r1], kf[bi, :, k0:k1]) * scale
                ok = allowed[bi, k0:k1][None, :]
                if causal:
                    ok = ok & (torch.arange(k0, k1, device=q.device)[None, :] <= pos[r0:r1, None])
                x = torch.where(ok[None], x, torch.full_like(x, NEG_INF))
                m_new = torch.maximum(m, x.amax(-1))
                p = torch.exp(x - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + p.to(v.dtype).float() @ vf[bi, :, k0:k1]
                m = m_new
            out[bi, :, r0:r1] = o / l[..., None]
    return out.reshape(b, kh, t, rep, d).permute(0, 2, 1, 3, 4).reshape(b, t, n, d).to(v.dtype)


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


def _plan(q, k, tiles: Optional[int], warps: Optional[int]) -> Tuple[int, int]:
    planned = flash_plan(q.shape[1], q.shape[2], k.shape[2], q.shape[3])
    tiles = planned[0] if tiles is None else tiles
    warps = planned[1] if warps is None else warps
    if tiles < 1 or not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"flash kernel takes tiles >= 1 and 1 <= warps <= {MAX_WARPS}, got {tiles}, {warps}")
    return tiles, warps


def _launch(q, k, v, kv_mask, causal: bool, scale: float, streamed: bool = False,
            tiles: Optional[int] = None, warps: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel. ``tiles`` and ``warps`` override ``flash_plan``
    (sweeps and checks on the card); the streamed instance runs a warp a
    tile, so it takes at most 8 tiles."""
    check_kernel_shapes(q, k, v, kv_mask)
    tiles, warps = _plan(q, k, tiles, warps)
    b, t, n, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _build.launcher("flash_attention", "flash_attention_fwd", 5,
                         [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 4)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, t, s, n, kh, d, int(bool(causal)), float(scale), _DTYPES[q.dtype], tiles, warps, int(streamed),
            stream,
        )
    _build.check(status, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, t: int, s: int, n: int, kh: int, d: int, dtype_code: int, tiles: int,
                   warps: int, streamed: bool) -> int:
    fn = _build.LIBRARIES.entry("flash_attention", "flash_attention_blocks_per_sm",
                                [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)], ctypes.c_int)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        status = fn(t, s, n, kh, d, dtype_code, tiles, warps, int(streamed), ctypes.byref(blocks))
    _build.check(status, "flash_attention_blocks_per_sm")
    return blocks.value


def blocks_per_sm(q, k, streamed: bool = False, tiles: Optional[int] = None, warps: Optional[int] = None) -> int:
    """Blocks of the kernel instance a launch on these CUDA tensors takes
    that one SM holds at once (the CUDA occupancy calculator)."""
    tiles, warps = _plan(q, k, tiles, warps)
    return _blocks_per_sm(q.device.index, q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                          _DTYPES[q.dtype], tiles, warps, bool(streamed))


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
