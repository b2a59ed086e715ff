"""The least time a kernel's work could take on one H100: the larger of its
bytes over the memory bandwidth and its operations over the dense bf16
tensor-core rate (NVIDIA's data sheet, SXM part, at the 700 W limit). Each
input byte counts once and each output byte once, whatever a kernel reads
again. Frozen copies of ``chip_smoke.py``'s ``repmixer_bound_ms`` and
``paged_bound_ms``, taking shapes and the host's view of the page tables."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def repmixer_seconds(b: int, h: int, w: int, c: int, f: int, elem: int) -> float:
    """One fused RepMixer block on (B, H, W, C), hidden width F: the input,
    the nine parameters (3x3 and 7x7 depthwise kernels and biases, fc1, fc2,
    their biases, gamma) and the output; 2 C (9 + 49) depthwise and 4 C F
    product operations a pixel."""
    params = 9 * c + c + 49 * c + c + c * f + f + f * c + c + c
    nbytes = elem * (2 * b * h * w * c + params)
    flops = b * h * w * (2 * c * (9 + 49) + 4 * c * f)
    return least_seconds(nbytes, flops)


def paged_seconds(rows: int, window: int, heads: int, kv_heads: int, head_dim: int, page: int, reached_pages: int,
                  valid_positions: int, table_entries: int, mask_entries: int, elem: int) -> float:
    """One paged decode (``window`` 1) or verify call: the distinct pages
    holding a valid position, K and V; q, the output and the new K/V rows;
    the int32 mask and tables. Operations: 4 D a (query head, valid stored
    position) and a (query head, new column at or before its own)."""
    nbytes = 2 * reached_pages * kv_heads * page * head_dim * elem
    nbytes += elem * (2 * rows * window * heads * head_dim + 2 * rows * window * kv_heads * head_dim)
    nbytes += 4 * (mask_entries + table_entries)
    flops = 4 * head_dim * heads * (window * valid_positions + rows * window * (window + 1) // 2)
    return least_seconds(nbytes, flops)
