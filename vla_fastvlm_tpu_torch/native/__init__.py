"""Native host-side components of the port (C++ via ctypes; the port's own
copy of the JAX package's ``native/``).

``letterbox_batch`` is the C++ letterbox preprocessor (``image_ops.cpp``,
whose header gives the parity contract with reference
``fastvlm_adapter.py:36-55``), built with ``g++`` at first use into
``build/native/`` under the checkout's root, never beside the source. Where
no compiler is available it falls back to ``_letterbox_numpy``, the plain
version, so the package never hard-requires the toolchain. This is host
code: frames are letterboxed on the CPU into float32 arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "image_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_FAILED = False


def _build_library() -> ctypes.CDLL:
    # The library is keyed on a hash of the source, so a fresh checkout
    # always compiles the source it holds. No -march=native: the library may
    # be reused on a host with another CPU, and the op is memory-bound.
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"_image_ops-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", str(SOURCE), "-o", str(tmp)]
        logger.info("Building native image ops: %s", " ".join(cmd))
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(out))
    u8 = ctypes.POINTER(ctypes.c_uint8)
    f32 = ctypes.POINTER(ctypes.c_float)
    args = [u8, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int]
    lib.letterbox_u8_chw.argtypes = args
    lib.letterbox_u8_hwc.argtypes = args
    lib.letterbox_u8_chw.restype = lib.letterbox_u8_hwc.restype = None
    return lib


def _get_library() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_FAILED
    if _LIB is not None or _BUILD_FAILED:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None and not _BUILD_FAILED:
            try:
                _LIB = _build_library()
            except (OSError, subprocess.CalledProcessError) as exc:  # no g++, a failed build or load
                logger.warning("Native image ops unavailable (%s); using numpy fallback.", exc)
                _BUILD_FAILED = True
    return _LIB


def native_available() -> bool:
    return _get_library() is not None


def _letterbox_numpy(images: np.ndarray, size: int, pad_value: float, scale: float) -> np.ndarray:
    """The plain version: numpy with the C++ op's semantics, CHW input."""
    n, c, h, w = images.shape
    ratio = max(w / size, h / size)
    rh, rw = max(1, int(h / ratio)), max(1, int(w / ratio))

    def coeffs(in_size, out_size):
        src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
        src = np.clip(src, 0, in_size - 1)
        lo = src.astype(np.int64)
        hi = np.minimum(lo + 1, in_size - 1)
        return lo, hi, (src - lo).astype(np.float32)

    ylo, yhi, yw = coeffs(h, rh)
    xlo, xhi, xw = coeffs(w, rw)

    img = images.astype(np.float32)
    top = img[:, :, ylo][:, :, :, xlo] * (1 - xw) + img[:, :, ylo][:, :, :, xhi] * xw
    bot = img[:, :, yhi][:, :, :, xlo] * (1 - xw) + img[:, :, yhi][:, :, :, xhi] * xw
    resized = top * (1 - yw)[None, None, :, None] + bot * yw[None, None, :, None]
    resized *= scale

    out = np.full((n, c, size, size), pad_value, np.float32)
    out[:, :, size - rh:, size - rw:] = resized
    return out


def letterbox_batch(
    images: np.ndarray,
    size: int,
    pad_value: float = 0.0,
    scale: float = 1.0 / 255.0,
    num_threads: int = 0,
) -> np.ndarray:
    """uint8 (N, C, H, W) or (N, H, W, C) -> letterboxed float32 (N, C, S, S).

    Aspect-preserving bilinear resize (align_corners=False) + top/left pad,
    the reference letterbox math applied to raw camera frames, scaled by
    ``scale`` (default to [0, 1]). ``num_threads`` 0 uses every core.
    """
    images = np.ascontiguousarray(images)
    if images.dtype != np.uint8:
        raise TypeError(f"expected uint8 frames, got {images.dtype}")
    if images.ndim != 4:
        raise ValueError(f"expected 4D batch, got shape {images.shape}")

    hwc = images.shape[-1] in (1, 3) and images.shape[1] not in (1, 3)
    lib = _get_library()
    if lib is None:
        if hwc:
            images = np.transpose(images, (0, 3, 1, 2))
        return _letterbox_numpy(images, size, pad_value, scale)

    u8, f32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    if hwc:
        n, h, w, c = images.shape
        out = np.empty((n, c, size, size), np.float32)
        lib.letterbox_u8_hwc(images.ctypes.data_as(u8), n, h, w, c, out.ctypes.data_as(f32), size, pad_value,
                             scale, num_threads)
    else:
        n, c, h, w = images.shape
        out = np.empty((n, c, size, size), np.float32)
        lib.letterbox_u8_chw(images.ctypes.data_as(u8), n, c, h, w, out.ctypes.data_as(f32), size, pad_value,
                             scale, num_threads)
    return out


__all__ = ["letterbox_batch", "native_available"]
