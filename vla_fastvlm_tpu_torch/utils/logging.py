"""Logging setup for the port's CLI entry points (a copy of
``vla_fastvlm_tpu/utils/logging.py``): one stdout handler with a
``[timestamp] LEVEL - name - message`` format, installed at most once per
logger (repeat calls only adjust the level).
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_LOG_FORMAT = "[%(asctime)s] %(levelname)s - %(name)s - %(message)s"


def _has_stream_handler(logger: logging.Logger) -> bool:
    return any(isinstance(h, logging.StreamHandler) for h in logger.handlers)


def _make_stdout_handler() -> logging.Handler:
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(logging.Formatter(fmt=_LOG_FORMAT))
    return handler


def configure_logging(level: int = logging.INFO, name: Optional[str] = None) -> None:
    """Attach the stdout handler to ``name``'s logger (idempotent) and set level."""
    target = logging.getLogger(name)
    if not _has_stream_handler(target):
        target.addHandler(_make_stdout_handler())
    target.setLevel(level)
