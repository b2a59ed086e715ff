"""Task strings -> token ids as the policy tokenizes them offline: a trailing
newline added, then UTF-8 bytes shifted by 3 after a bos id of 1, truncated
to the maximum length and right-padded with id 0 (the byte tokenizer the
FastVLM presets take where no HF tokenizer files are at hand)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

OFFSET, PAD, BOS = 3, 0, 1


def tokenize_tasks(tasks: Sequence[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.full((len(tasks), max_length), PAD, np.int64)
    mask = np.zeros((len(tasks), max_length), np.int64)
    for row, task in enumerate(tasks):
        if not task.endswith("\n"):
            task += "\n"
        toks = ([BOS] + [b + OFFSET for b in task.encode("utf-8")])[:max_length]
        ids[row, : len(toks)] = toks
        mask[row, : len(toks)] = 1
    return ids, mask
