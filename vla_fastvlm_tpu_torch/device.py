"""Device resolution for the port's entry points.

Entry points run on the card. The CPU is used only when the caller asks for
it by name (the CPU tests pass ``device="cpu"``); nothing falls back to the
CPU silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .data.prefetch import to_device

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


# ----------------------------------------------------------------------
# the reference's device helpers (counterparts of ``vla_fastvlm_tpu/device.py``)


def is_cuda_available() -> bool:
    """True when PyTorch sees a CUDA card."""
    return torch.cuda.is_available()


def is_mps_available() -> bool:
    """Always False: the port runs on an NVIDIA card or, when asked, the CPU."""
    return False


def get_best_device(preferred: Optional[str] = None) -> torch.device:
    """The card: ``None``, "cuda" and "gpu" give ``cuda`` and raise without
    one, as ``resolve_device`` does. The CPU only when ``preferred`` is
    "cpu"; nothing falls back to it."""
    name = (preferred or "cuda").lower()
    if name == "gpu":
        name = "cuda"
    if name not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {preferred!r}; expected 'cuda' (or 'gpu') or 'cpu'")
    return resolve_device(name)


def move_batch_to_device(batch: dict, device: DeviceLike) -> dict:
    """Place the tensors and numpy arrays of ``batch`` on ``device``; dicts
    are recursed and everything else (task strings, metadata) passes
    through untouched."""
    device = resolve_device(device)
    out: dict = {}
    for key, value in batch.items():
        if isinstance(value, dict):
            out[key] = move_batch_to_device(value, device)
        else:
            out[key] = to_device(value, device)
    return out
