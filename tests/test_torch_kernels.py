"""The port's kernels' plain versions against the JAX package on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``); here their wrappers take a CPU tensor and run the plain
version, which is what is held against JAX: against the XLA references the
Pallas files themselves use (``_xla_reference``, ``_repmixer_block_xla``) and
against the Pallas kernels in interpret mode, as the JAX package's own tests
run them.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vla_fastvlm_tpu_torch.ops.kernels import (
    flash_attention,
    flash_attention_reference,
    launch_counts,
    repmixer_block,
    repmixer_block_reference,
    reset_launch_counts,
)

from _torch_parity import t


# The package re-exports a function under each module's name: take the modules.
jflash = importlib.import_module("vla_fastvlm_tpu.ops.pallas.flash_attention")
jrep = importlib.import_module("vla_fastvlm_tpu.ops.pallas.repmixer")



FLASH_CASES = [
    # (b, t, s, n, kh, d, causal)
    (2, 16, 16, 4, 2, 64, True),  # GQA, causal
    (1, 24, 24, 2, 2, 64, False),  # non-causal
    (2, 17, 17, 6, 2, 128, True),  # D=128, odd length
    (1, 20, 20, 7, 1, 64, True),  # rep = 7 as at 0.5B / 7B
]


def _flash_inputs(case, seed=0):
    b, t_, s, n, kh, d, causal = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t_, n, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[0, -3:] = 0  # right padding: padded query rows
    if b > 1:
        mask[1, :2] = 0  # left padding: rows 0-1 fully masked under causal
    return q, k, v, mask, causal


class TestFlashPlainVersion:
    @pytest.mark.parametrize("case", FLASH_CASES)
    def test_matches_xla_reference(self, case):
        q, k, v, mask, causal = _flash_inputs(case)
        d = q.shape[-1]
        ref = jflash._xla_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(mask), causal, d ** -0.5)
        out = flash_attention_reference(t(q), t(k), t(v), t(mask), causal, d ** -0.5)
        # fp32 softmax + two fp32 contractions: ulp-level differences
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)

    @pytest.mark.parametrize("case", FLASH_CASES[:3])
    def test_matches_pallas_interpret(self, case):
        q, k, v, mask, causal = _flash_inputs(case, seed=1)
        with pltpu.force_tpu_interpret_mode():
            ref = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(mask), causal, None, 16)
        out = flash_attention(t(q), t(k), t(v), t(mask), causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)

    def test_fully_masked_rows_are_uniform_average(self):
        """-1e30 masking (not -inf): a row with no allowed key averages V over all S."""
        q, k, v, mask, _ = _flash_inputs((2, 8, 8, 2, 2, 64, True), seed=2)
        out = flash_attention_reference(t(q), t(k), t(v), t(mask), True)
        assert torch.isfinite(out).all()
        expect = t(v)[1].mean(dim=0)  # (K, D); row 0 of batch 1 sees only padded keys
        np.testing.assert_allclose(out[1, 0].numpy(), expect.numpy(), atol=1e-5)

    def test_cpu_wrapper_counts_no_launch(self):
        reset_launch_counts()
        q, k, v, mask, causal = _flash_inputs(FLASH_CASES[0])
        flash_attention(t(q), t(k), t(v), t(mask), causal)
        assert launch_counts()["flash_attention"] == 0

    def test_backward_through_plain_version(self):
        q, k, v, mask, causal = _flash_inputs(FLASH_CASES[0], seed=3)
        qkv = [t(x).requires_grad_() for x in (q, k, v)]
        flash_attention(*qkv, t(mask), causal).square().sum().backward()
        assert all(torch.isfinite(x.grad).all() for x in qkv)


def _rep_args(b, h, w, c, f, seed=0):
    """Dirac-ish depthwise kernels plus noise: realistic post-reparam weights."""
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=0.5):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    w3 = np.zeros((3, 3, 1, c), np.float32)
    w3[1, 1, 0] = 1.0
    w7 = np.zeros((7, 7, 1, c), np.float32)
    w7[3, 3, 0] = 1.0
    return [
        arr(b, h, w, c, scale=1.0), w3 + arr(3, 3, 1, c, scale=0.1), arr(c),
        w7 + arr(7, 7, 1, c, scale=0.05), arr(c), arr(c, f, scale=c ** -0.5), arr(f),
        arr(f, c, scale=f ** -0.5), arr(c), arr(c, scale=0.01),
    ]


REP_CASES = [
    # (B, H, W, C, F): even tile, ragged tile, stage-like widths
    (2, 16, 24, 32, 128),
    (1, 12, 10, 32, 128),
    (1, 8, 8, 96, 384),
]


class TestRepMixerPlainVersion:
    @pytest.mark.parametrize("shape", REP_CASES)
    def test_matches_xla_reference(self, shape):
        args = _rep_args(*shape)
        ref = jrep._repmixer_block_xla(*[jnp.asarray(a) for a in args])
        out = repmixer_block_reference(*[t(a) for a in args])
        # fp32 convs and two fp32 matmuls over C / F terms
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-5)

    def test_matches_pallas_interpret_with_border_tiles(self):
        """Large biases make any dw3-bias leak into the border far above tolerance."""
        args = _rep_args(1, 16, 24, 128, 512, seed=3)
        args[2] = args[2] + 10.0  # b3
        args[4] = args[4] + 5.0  # b7
        ref = jrep._repmixer_block_pallas(*[jnp.asarray(a) for a in args], interpret=True)
        out = repmixer_block(*[t(a) for a in args])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)

    def test_accepts_squeezed_depthwise_kernels(self):
        args = _rep_args(1, 8, 8, 32, 128, seed=4)
        full = repmixer_block_reference(*[t(a) for a in args])
        args[1], args[3] = args[1][:, :, 0], args[3][:, :, 0]
        np.testing.assert_array_equal(repmixer_block_reference(*[t(a) for a in args]).numpy(), full.numpy())

    def test_cpu_wrapper_counts_no_launch(self):
        reset_launch_counts()
        repmixer_block(*[t(a) for a in _rep_args(*REP_CASES[0])])
        assert launch_counts()["repmixer_block"] == 0

    def test_rejects_other_devices(self):
        args = [t(a).to("meta") for a in _rep_args(*REP_CASES[0])]
        with pytest.raises(ValueError, match="CUDA or CPU"):
            repmixer_block(*args)
