"""Utilities of the port: the dataclass CLI, logging setup and the checkpoint loader."""

from .cli import parse_cli
from .logging import configure_logging

__all__ = ["configure_logging", "load_policy_from_checkpoint", "parse_cli"]


def __getattr__(name):
    # Lazy, as in the JAX package: the loader pulls in the policies.
    if name == "load_policy_from_checkpoint":
        from .checkpoint import load_policy_from_checkpoint

        return load_policy_from_checkpoint
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
