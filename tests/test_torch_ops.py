"""Parity of the PyTorch port's ops with the JAX package on the CPU.

Inputs come from ``np.random.default_rng(seed)`` and go through the JAX
function and its port. Tolerances are fp32 on the CPU, JAX at
``jax_default_matmul_precision="highest"`` (``conftest.py``); each states the
bound it holds and why.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.ops import attention as jattn
from vla_fastvlm_tpu.ops import image as jimage
from vla_fastvlm_tpu.ops import norms as jnorms
from vla_fastvlm_tpu.ops import rope as jrope
from vla_fastvlm_tpu_torch.ops import attention as tattn
from vla_fastvlm_tpu_torch.ops import image as timage
from vla_fastvlm_tpu_torch.ops import norms as tnorms
from vla_fastvlm_tpu_torch.ops import rope as trope

from _torch_parity import t

GOLDEN = Path(__file__).parent / "golden"

# fp32 elementwise/reduction ops in two frameworks: a few ulp apart.
ATOL = 1e-5



class TestNorms:
    def test_rms_norm(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 5, 64)).astype(np.float32)
        w = rng.standard_normal(64).astype(np.float32)
        ref = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
        out = tnorms.rms_norm(t(x), t(w), 1e-6)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    @pytest.mark.parametrize("affine", [True, False])
    def test_layer_norm(self, affine):
        rng = np.random.default_rng(1)
        x = (rng.standard_normal((4, 48)) * 3 + 1).astype(np.float32)
        w = rng.standard_normal(48).astype(np.float32) if affine else None
        b = rng.standard_normal(48).astype(np.float32) if affine else None
        ref = jnorms.layer_norm(jnp.asarray(x), None if w is None else jnp.asarray(w),
                                None if b is None else jnp.asarray(b), 1e-6)
        out = tnorms.layer_norm(t(x), None if w is None else t(w), None if b is None else t(b), 1e-6)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    def test_bf16_output_dtype_kept(self):
        x = torch.randn(2, 8, dtype=torch.bfloat16)
        assert tnorms.rms_norm(x, torch.ones(8)).dtype == torch.bfloat16
        assert tnorms.layer_norm(x).dtype == torch.bfloat16


class TestRope:
    def test_cos_sin_and_apply(self):
        rng = np.random.default_rng(2)
        pos = np.tile(np.arange(7, dtype=np.int32), (2, 1))
        q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
        k = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
        jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
        tc, ts = trope.rope_cos_sin(t(pos), 16, 10000.0)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
        jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
        tq, tk = trope.apply_rope(t(q), t(k), tc, ts)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)

    def test_cos_sin_cast_to_activation_dtype(self):
        c, s = trope.rope_cos_sin(torch.arange(4)[None], 8, dtype=torch.bfloat16)
        assert c.dtype == s.dtype == torch.bfloat16


def _qkv(seed, b, t_, s, n, kh, d):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, t_, n, d)).astype(np.float32),
        rng.standard_normal((b, s, kh, d)).astype(np.float32),
        rng.standard_normal((b, s, kh, d)).astype(np.float32),
    )


class TestAttention:
    @pytest.mark.parametrize("causal", [True, False])
    def test_make_attention_bias(self, causal):
        pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
        mask = np.array([[1, 1, 1, 1, 0, 0], [0, 1, 1, 1, 1, 1]], np.int32)
        ref = jattn.make_attention_bias(jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(mask), causal)
        out = tattn.make_attention_bias(t(pos), t(pos), t(mask), causal)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    def test_dot_product_attention_gqa_with_bias(self):
        q, k, v = _qkv(3, 2, 6, 6, 4, 2, 16)
        pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
        mask = np.array([[1, 1, 1, 1, 0, 0], [1] * 6], np.int32)
        jb = jattn.make_attention_bias(jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(mask), True)
        ref = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jb)
        tb = tattn.make_attention_bias(t(pos), t(pos), t(mask), True)
        out = tattn.dot_product_attention(t(q), t(k), t(v), bias=tb)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    @pytest.mark.parametrize("impl", ["auto", "flash", "xla"])
    def test_attention_entry_structured_mask(self, impl):
        """Every impl on a CPU tensor gives the JAX entry point's answer."""
        q, k, v = _qkv(4, 2, 8, 8, 4, 2, 64)
        mask = np.ones((2, 8), np.int32)
        mask[1, -3:] = 0
        ref = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_mask=jnp.asarray(mask), causal=True, impl="xla")
        out = tattn.attention(t(q), t(k), t(v), kv_mask=t(mask), causal=True, impl=impl)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    def test_forced_flash_rejects_unsupported_head_dim(self):
        q, k, v = _qkv(5, 1, 4, 4, 2, 2, 32)
        with pytest.raises(ValueError, match="flash"):
            tattn.attention(t(q), t(k), t(v), kv_mask=torch.ones(1, 4), causal=True, impl="flash")


class TestImage:
    @pytest.mark.parametrize(
        "shape,size,letterbox,normalize",
        [
            ((2, 3, 48, 64), 56, True, False),
            ((2, 1, 40, 30), 32, True, True),
            ((1, 4, 48, 64), 40, False, False),
            ((2, 3, 64, 64), 64, True, True),  # identity short-cut
        ],
    )
    def test_prepare_image_batch(self, shape, size, letterbox, normalize):
        img = np.random.default_rng(6).random(shape, dtype=np.float32)
        ref = jimage.prepare_image_batch(jnp.asarray(img), size, letterbox, 0.25, normalize)
        out = timage.prepare_image_batch(t(img), size, letterbox, 0.25, normalize)
        # two fp32 interpolation matmuls: sums in another order
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)

    def test_identity_short_cut_returns_input(self):
        img = torch.rand(1, 3, 32, 32)
        assert timage.resize_with_pad(img, 32, 32) is img

    def test_letterbox_golden(self):
        data = np.load(GOLDEN / "letterbox.npz")
        for i in range(int(data["n_cases"])):
            size, pad = data[f"meta_{i}"]
            out = timage.resize_with_pad(t(data[f"in_{i}"]), int(size), int(size), float(pad))
            np.testing.assert_allclose(out.numpy(), data[f"out_{i}"], atol=1e-5, err_msg=f"case {i}")

    def test_interp_matrix_matches(self):
        np.testing.assert_array_equal(timage._interp_matrix(37, 23), jimage._interp_matrix(37, 23))


class TestFrameworkDefaults:
    """Defaults that differ between Flax/XLA and torch, each pinned where the port overrides it."""

    def test_gelu_is_flax_tanh_approximation(self):
        import jax

        from vla_fastvlm_tpu_torch.models.fastvit import gelu

        x = np.linspace(-6, 6, 241, dtype=np.float32)
        ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))  # Flax nn.gelu: approximate=True
        np.testing.assert_allclose(gelu(t(x)).numpy(), ref, atol=ATOL)
        exact = torch.nn.functional.gelu(t(x)).numpy()  # torch's default is exact
        assert np.abs(exact - ref).max() > 1e-4

    def test_layer_norm_epsilon_is_flax(self):
        import flax.linen as fnn

        from vla_fastvlm_tpu_torch.models.layers import LayerNorm, init_weights

        rng = np.random.default_rng(2)
        x = (rng.standard_normal((3, 16)) * 1e-3).astype(np.float32)  # variance near eps
        jln = fnn.LayerNorm()  # epsilon=1e-6
        ref = jln.apply(jln.init(jax_key(), jnp.asarray(x)), jnp.asarray(x))
        ln = LayerNorm(16)
        init_weights(ln, torch.Generator().manual_seed(0))
        np.testing.assert_allclose(ln(t(x)).detach().numpy(), np.asarray(ref), atol=1e-4)
        torch_default = torch.nn.functional.layer_norm(t(x), (16,))  # eps=1e-5
        assert np.abs(torch_default.numpy() - np.asarray(ref)).max() > 1e-2

    def test_fp32_references_turn_tf32_off(self):
        from vla_fastvlm_tpu_torch.device import strict_fp32

        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        try:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            strict_fp32()
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32  # cuDNN's default is True
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def jax_key():
    import jax

    return jax.random.PRNGKey(0)
