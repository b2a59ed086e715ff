"""Device resolution for the port's entry points.

Entry points run on the card. The CPU is used only when the caller asks for
it by name (the CPU tests pass ``device="cpu"``); nothing falls back to the
CPU silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is absent and "cpu" was not asked."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's entry points run on an NVIDIA "
            "GPU. Pass device='cpu' explicitly to run the plain PyTorch path "
            "on the CPU."
        )
    if device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!s}")
    return device


def resolve_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Config dtype names ("float32", "bfloat16", "float16") -> torch dtypes."""
    if isinstance(name, torch.dtype):
        return name
    table = {
        "float32": torch.float32,
        "bfloat16": torch.bfloat16,
        "float16": torch.float16,
    }
    if name not in table:
        raise ValueError(f"unknown dtype {name!r}; expected one of {sorted(table)}")
    return table[name]


def same_device(a: torch.device, b: Optional[torch.device]) -> bool:
    """True when ``b`` is unset or names the device ``a`` lives on."""
    if b is None:
        return True
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    index = lambda d: d.index if d.index is not None else torch.cuda.current_device()
    return index(a) == index(b)


def strict_fp32() -> None:
    """Run fp32 matmuls and cuDNN convolutions in full fp32 on the card.

    cuDNN runs fp32 convolutions in TF32 by default (about three decimal
    digits); the plain versions that check the kernels in fp32 need neither
    TF32 path. This sets process-wide torch flags.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
