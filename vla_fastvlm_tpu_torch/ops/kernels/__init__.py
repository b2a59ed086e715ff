"""Hand-written CUDA kernels of the port, each beside its plain version.

Nothing here builds or loads a kernel at import; see ``_build.py``.
"""

from .flash_attention import flash_attention, flash_attention_reference, flash_attention_streamed
from .paged_attention import (
    paged_attention_decode,
    paged_attention_decode_reference,
    paged_attention_window,
    paged_attention_window_reference,
)
from .repmixer import repmixer_block, repmixer_block_reference

KERNELS = {
    "flash_attention": flash_attention,
    "repmixer_block": repmixer_block,
    "paged_attention": paged_attention_decode,
    "paged_attention_window": paged_attention_window,
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
    "flash_attention_streamed",
    "launch_counts",
    "paged_attention_decode",
    "paged_attention_decode_reference",
    "paged_attention_window",
    "paged_attention_window_reference",
    "repmixer_block",
    "repmixer_block_reference",
    "reset_launch_counts",
]
