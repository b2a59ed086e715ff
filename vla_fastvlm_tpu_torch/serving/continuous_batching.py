"""Prompt-bucket helpers of the continuous-batching servers (counterpart of
``normalize_buckets``, ``pick_bucket`` and ``_pad_to`` in
``vla_fastvlm_tpu/serving/continuous_batching.py``). The dense
``GenerationServer`` is not ported yet; the paged server imports these.
"""

from __future__ import annotations

import numpy as np


def normalize_buckets(prompt_len) -> tuple:
    """``prompt_len`` int or sequence -> sorted tuple of prompt widths.

    Requests pad to the smallest bucket at least their width and admission
    batches per bucket.
    """
    if isinstance(prompt_len, (int, np.integer)):
        buckets = (int(prompt_len),)
    else:
        buckets = tuple(sorted({int(p) for p in prompt_len}))
    if not buckets or buckets[0] <= 0:
        raise ValueError(f"invalid prompt_len buckets {buckets}")
    return buckets


def pick_bucket(buckets, width: int) -> int:
    for b in buckets:
        if width <= b:
            return b
    raise ValueError(f"prompt width {width} exceeds the largest compiled bucket {buckets[-1]}")


def _pad_to(ids: np.ndarray, mask: np.ndarray, bucket: int):
    pad = bucket - ids.shape[1]
    if pad == 0:
        return ids, mask
    return np.pad(ids, ((0, 0), (0, pad))), np.pad(mask, ((0, 0), (0, pad)))
