"""Utilities of the port: the dataclass CLI and logging setup."""

from .cli import parse_cli
from .logging import configure_logging

__all__ = ["configure_logging", "parse_cli"]
