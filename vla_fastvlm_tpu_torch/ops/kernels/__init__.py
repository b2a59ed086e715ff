"""Hand-written CUDA kernels of the port, each beside its plain version.

Nothing here builds or loads a kernel at import; see ``_build.py``.
"""

from .flash_attention import flash_attention, flash_attention_reference
from .repmixer import repmixer_block, repmixer_block_reference

KERNELS = {
    "flash_attention": flash_attention,
    "repmixer_block": repmixer_block,
}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "flash_attention",
    "flash_attention_reference",
    "launch_counts",
    "repmixer_block",
    "repmixer_block_reference",
    "reset_launch_counts",
]
