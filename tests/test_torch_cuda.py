"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import). Run them on a machine with an H100; that machine
has no JAX, so leave out ``tests/conftest.py``:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

``chip_smoke.py`` holds the same kernels against their plain versions at the
main path's full shapes.
"""

import numpy as np
import pytest
import torch

from vla_fastvlm_tpu_torch.device import strict_fp32
from vla_fastvlm_tpu_torch.ops.kernels import (
    flash_attention,
    flash_attention_reference,
    launch_counts,
    repmixer_block,
    repmixer_block_reference,
    reset_launch_counts,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    strict_fp32()
    return torch.device("cuda")


def _flash_inputs(b, t, n, kh, d, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, t, n, d, generator=g).to(device, dtype)
    k = torch.randn(b, t, kh, d, generator=g).to(device, dtype)
    v = torch.randn(b, t, kh, d, generator=g).to(device, dtype)
    mask = torch.ones(b, t, dtype=torch.int32)
    mask[0, t - 5:] = 0
    mask[-1, :] = 0  # one sequence entirely padded
    return q, k, v, mask.to(device)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(cuda, d, dtype, atol):
    q, k, v, mask = _flash_inputs(3, 80, 14, 2, d, dtype, cuda)
    reset_launch_counts()
    out = flash_attention(q, k, v, mask, True)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    ref = flash_attention_reference(q, k, v, mask, True)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)


def _rep_args(b, h, w, c, f, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    arr = lambda *s, scale=0.5: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
    w3 = torch.zeros(3, 3, 1, c)
    w3[1, 1, 0] = 1.0
    w7 = torch.zeros(7, 7, 1, c)
    w7[3, 3, 0] = 1.0
    args = [arr(b, h, w, c, scale=1.0), w3 + arr(3, 3, 1, c, scale=0.1), arr(c) + 5.0,
            w7 + arr(7, 7, 1, c, scale=0.05), arr(c), arr(c, f, scale=c ** -0.5), arr(f),
            arr(f, c, scale=f ** -0.5), arr(c), arr(c, scale=0.5)]
    return [a.to(device, dtype) for a in args]


@pytest.mark.parametrize("shape", [(2, 16, 16, 96, 384), (1, 12, 20, 192, 768)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-1)])
def test_repmixer_kernel_matches_plain(cuda, shape, dtype, atol):
    args = _rep_args(*shape, dtype, cuda)
    reset_launch_counts()
    out = repmixer_block(*args)
    torch.cuda.synchronize()
    assert launch_counts()["repmixer_block"] == 1
    ref = repmixer_block_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)


def test_auto_impls_raise_on_shapes_the_kernels_do_not_take(cuda):
    """On the card "auto" is the kernel path: no quiet plain fallback."""
    from vla_fastvlm_tpu_torch.models.fastvit import RepMixerBlock, fastvithd_tiny
    from vla_fastvlm_tpu_torch.ops.attention import attention

    q, k, v, mask = _flash_inputs(1, 16, 4, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attention(q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous(),
                  kv_mask=mask, causal=True, impl="auto")
    with torch.device(cuda):
        block = RepMixerBlock(32, fastvithd_tiny(block_impl="auto"), 4.0)
    with pytest.raises(ValueError, match="repmixer kernel"), torch.no_grad():
        block(torch.zeros(1, 8, 8, 32, device=cuda))


def test_policy_forward_keeps_cuda_inputs_on_the_card(cuda):
    """Images and states already on the card go through ``FastVLAPolicy.forward``
    without a host round trip and give the numpy inputs' actions."""
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy

    cfg = FastVLAConfig(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny",
                        state_dim=6, action_dim=5, hidden_dim=16, fusion_dim=16,
                        tokenizer_max_length=16, attention_impl="xla", vision_block_impl="xla")
    policy = FastVLAPolicy(cfg)
    rng = np.random.default_rng(0)
    images = rng.random((2, 3, 48, 64), dtype=np.float32)
    states = rng.standard_normal((2, 6)).astype(np.float32)
    ref = policy.forward(images, states, "pick up the cube")
    cimg, cstates = torch.from_numpy(images).to(cuda), torch.from_numpy(states).to(cuda)
    prepared = policy.processor.prepare_images(cimg)
    assert prepared.device.type == "cuda"
    out = policy.forward(cimg, cstates, "pick up the cube")
    assert out.device.type == "cuda"
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_kernels_reject_non_contiguous(cuda):
    q, k, v, mask = _flash_inputs(1, 16, 4, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, mask, True)
