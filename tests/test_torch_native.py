"""The port's native C++ letterbox (``vla_fastvlm_tpu_torch/native``) against
the JAX package's and against both packages' device-side letterboxes, on
the CPU (mirrors ``tests/test_native_image_ops.py``).

The port builds its own copy of ``image_ops.cpp`` with ``g++`` into
``build/native/``; on the same frames it gives the JAX package's native
output bit for bit, JAX's and the port's ``resize_with_pad`` within 2e-3
(the JAX test's bound on [0, 1] pixels), and its numpy plain version
within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu import native as j_native
from vla_fastvlm_tpu.ops.image import resize_with_pad as j_resize_with_pad
from vla_fastvlm_tpu_torch import native
from vla_fastvlm_tpu_torch.native import _letterbox_numpy, letterbox_batch, native_available
from vla_fastvlm_tpu_torch.ops.image import resize_with_pad

# Wide, tall and square-ish frames; letterboxed to 32 and 24 px.
SHAPES = [(3, 3, 37, 53), (2, 3, 53, 37), (2, 1, 40, 41)]


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_native_builds_into_build_dir():
    assert native_available(), "g++ toolchain expected in this image"
    built = list(native.BUILD_DIR.glob("_image_ops-*.so"))
    assert built and not list(native.SOURCE.parent.glob("*.so"))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("size", [32, 24])
def test_matches_jax_native(shape, size):
    frames = _frames(shape)
    out = letterbox_batch(frames, size)
    assert out.dtype == np.float32 and out.shape == (shape[0], shape[1], size, size)
    assert np.array_equal(out, j_native.letterbox_batch(frames, size))


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_device_letterboxes(shape):
    frames = _frames(shape, seed=1)
    out = letterbox_batch(frames, 32)
    ref = np.asarray(j_resize_with_pad(jnp.asarray(frames, jnp.float32) / 255.0, 32, 32))
    port = resize_with_pad(torch.from_numpy(frames).float() / 255.0, 32, 32).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-3)
    np.testing.assert_allclose(out, port, atol=2e-3)


def test_hwc_input():
    frames = _frames(SHAPES[0])
    hwc = np.transpose(frames, (0, 2, 3, 1)).copy()
    assert np.array_equal(letterbox_batch(hwc, 32), letterbox_batch(frames, 32))
    assert np.array_equal(letterbox_batch(hwc, 32), j_native.letterbox_batch(hwc, 32))


@pytest.mark.parametrize("shape", SHAPES)
def test_numpy_plain_version_matches_native(shape):
    frames = _frames(shape, seed=2)
    fallback = _letterbox_numpy(frames, 24, 0.0, 1.0 / 255.0)
    np.testing.assert_allclose(letterbox_batch(frames, 24), fallback, atol=1e-5)
    assert np.array_equal(fallback, j_native._letterbox_numpy(frames, 24, 0.0, 1.0 / 255.0))


def test_falls_back_without_a_compiler(monkeypatch):
    frames = _frames(SHAPES[0], seed=3)
    monkeypatch.setattr(native, "_get_library", lambda: None)
    hwc = np.transpose(frames, (0, 2, 3, 1)).copy()
    expect = _letterbox_numpy(frames, 32, 0.25, 1.0 / 255.0)
    assert np.array_equal(letterbox_batch(frames, 32, pad_value=0.25), expect)
    assert np.array_equal(letterbox_batch(hwc, 32, pad_value=0.25), expect)


def test_pad_value_and_scale():
    out = letterbox_batch(_frames(SHAPES[0]), 64, pad_value=0.5, scale=1.0)
    # 37x53 -> ratio=53/64 -> rh=44 -> 20 rows of top padding
    assert np.allclose(out[:, :, :20, :], 0.5)
    assert out.max() > 1.5  # scale=1: raw 0..255 range preserved


def test_rejects_bad_input():
    with pytest.raises(TypeError):
        letterbox_batch(np.zeros((1, 3, 8, 8), np.float32), 16)
    with pytest.raises(ValueError, match="4D"):
        letterbox_batch(np.zeros((3, 8, 8), np.uint8), 16)
