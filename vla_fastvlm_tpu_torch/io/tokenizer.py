"""Tokenization: HF tokenizer when available, deterministic byte fallback
(the port's own copy of ``vla_fastvlm_tpu/io/tokenizer.py``).

Task strings are tokenized with right padding and truncation to
``tokenizer_max_length``. The HF branch is tried only when ``transformers``
imports and a local tokenizer is found; otherwise a deterministic UTF-8
byte-level tokenizer keeps the policy runnable offline: ids are
``byte + OFFSET`` with reserved pad/bos/eos, so it needs no vocabulary files
and round-trips any string.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class TokenBatch:
    """Static-shape tokenized batch: what the model consumes."""

    input_ids: np.ndarray  # (B, T) int32
    attention_mask: np.ndarray  # (B, T) int32, 1 = real token


class ByteTokenizer:
    """Offline fallback tokenizer: UTF-8 bytes shifted past special ids.

    id 0 = pad, 1 = bos, 2 = eos; bytes occupy [OFFSET, OFFSET+255].
    Right/left padding honors the reference's ``tokenizer_padding_side`` knob.
    """

    OFFSET = 3
    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2

    def __init__(self, padding_side: str = "right") -> None:
        self.padding_side = padding_side
        self.vocab_size = 256 + self.OFFSET

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        ids = [self.bos_token_id] + [b + self.OFFSET for b in text.encode("utf-8")]
        if max_length is not None:
            ids = ids[:max_length]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(
            i - self.OFFSET for i in ids if i >= self.OFFSET and i < self.OFFSET + 256
        )
        return data.decode("utf-8", errors="replace")

    def __call__(
        self,
        texts: Sequence[str] | str,
        padding: str = "longest",
        truncation: bool = True,
        max_length: int = 64,
        **_: object,
    ) -> TokenBatch:
        if isinstance(texts, str):
            texts = [texts]
        encoded = [self.encode(t, max_length if truncation else None) for t in texts]
        if padding == "max_length":
            width = max_length
        else:  # "longest"
            width = max((len(e) for e in encoded), default=1)
        ids = np.full((len(encoded), width), self.pad_token_id, np.int32)
        mask = np.zeros((len(encoded), width), np.int32)
        for row, e in enumerate(encoded):
            e = e[:width]
            if self.padding_side == "left":
                ids[row, width - len(e):] = e
                mask[row, width - len(e):] = 1
            else:
                ids[row, : len(e)] = e
                mask[row, : len(e)] = 1
        return TokenBatch(input_ids=ids, attention_mask=mask)


class HFTokenizerAdapter:
    """Wrap an HF tokenizer to emit numpy ``TokenBatch`` outputs."""

    def __init__(self, tokenizer, padding_side: str = "right") -> None:
        self._tok = tokenizer
        try:
            self._tok.padding_side = padding_side
        except Exception:  # pragma: no cover - parity with reference :127-130
            pass
        if self._tok.pad_token is None and getattr(self._tok, "eos_token", None):
            self._tok.pad_token = self._tok.eos_token
        self.padding_side = padding_side

    @property
    def vocab_size(self) -> int:
        return len(self._tok)

    @property
    def pad_token_id(self) -> int:
        return int(self._tok.pad_token_id or 0)

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        return self._tok.encode(
            text, truncation=max_length is not None, max_length=max_length
        )

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def __call__(
        self,
        texts: Sequence[str] | str,
        padding: str = "longest",
        truncation: bool = True,
        max_length: int = 64,
        **_: object,
    ) -> TokenBatch:
        out = self._tok(
            list([texts] if isinstance(texts, str) else texts),
            padding=padding,
            truncation=truncation,
            max_length=max_length,
            return_tensors="np",
        )
        return TokenBatch(
            input_ids=out["input_ids"].astype(np.int32),
            attention_mask=out["attention_mask"].astype(np.int32),
        )


def load_tokenizer(model_id: str, padding_side: str = "right"):
    """Resolve a tokenizer for ``model_id`` with graceful degradation.

    Order (mirroring the reference's try/except chain,
    ``fastvlm_adapter.py:114-130``): HF AutoTokenizer from a local directory or
    cache, then the offline byte fallback.
    """
    candidates = []
    if Path(model_id).is_dir():
        candidates.append(dict(pretrained_model_name_or_path=model_id))
    if "/" in model_id:  # HF hub id (cache may hold it); bare aliases skip
        candidates.append(
            dict(pretrained_model_name_or_path=model_id, local_files_only=True)
        )
    if candidates:
        try:
            from transformers import AutoTokenizer
        except ImportError:
            candidates = []
    for kwargs in candidates:
        try:
            tok = AutoTokenizer.from_pretrained(trust_remote_code=True, **kwargs)
            return HFTokenizerAdapter(tok, padding_side=padding_side)
        except Exception:
            continue
    logger.warning(
        "No HF tokenizer available for %r (offline, no cache); using the "
        "deterministic byte-level fallback tokenizer.",
        model_id,
    )
    return ByteTokenizer(padding_side=padding_side)
