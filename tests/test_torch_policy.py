"""The whole serving slice of the PyTorch port against the JAX package.

``FastVLMWithExpert`` at ``fastvlm_tiny`` (64 px tower, 2-layer decoder):
seeded random JAX parameters at realistic scales move across the weight
bridge into the port, and both run the policy step on the same
numpy images (letterboxed from 48x64), token ids and states, in fp32; and
the policy's host forward under each preprocessing and decoder option
(cameras, unfused projections, plain resize, pad value, left padding,
padding to the maximum length, no trailing newline).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.fastvla import FastVLAConfig as JConfig
from vla_fastvlm_tpu.fastvla import FastVLMWithExpert as JModel
from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy, FastVLMWithExpert

from _torch_parity import random_params

TINY = dict(
    vlm_model_name="fastvlm-tiny",
    bootstrap_model_name="fastvlm-tiny",
    state_dim=6,
    action_dim=5,
    hidden_dim=16,
    fusion_dim=16,
    tokenizer_max_length=16,
)

# Tower + projector + 2 decoder layers + head in fp32; pooled features go
# through a final RMSNorm, so errors stay at fp32 accumulation level.
ATOL = 1e-4


def _jax_model(seed, **kw):
    """JAX policy with seeded random params; ``fabricate_params`` skips the
    JAX init, whose op-by-op compile dominates a CPU run."""
    jmodel = JModel(JConfig(**TINY, fabricate_params=True, **kw))
    params = random_params(jmodel.params, seed)
    return jmodel, params


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    images = rng.random((b, 3, 48, 64), dtype=np.float32)
    ids = rng.integers(3, 259, (b, 16)).astype(np.int32)
    mask = np.ones((b, 16), np.int32)
    mask[0, 11:] = 0
    states = rng.standard_normal((b, 6)).astype(np.float32)
    return images, ids, mask, states


@pytest.mark.parametrize("chunk", [1, 3])
def test_policy_step_matches_jax(chunk):
    jmodel, params = _jax_model(chunk, chunk_size=chunk)
    images, ids, mask, states = _inputs(seed=chunk)
    both = jax.jit(lambda p, i, d, m, s: (
        jmodel.apply_fn(p, i, d, m, s), jmodel.backbone.features_fn(p["backbone"], i, d, m)
    ))
    ref, feats_ref = both(params, *(jnp.asarray(x) for x in (images, ids, mask, states)))

    tmodel = FastVLMWithExpert(FastVLAConfig(**TINY, chunk_size=chunk), device="cpu")
    tmodel.load_jax_params(params)
    out = tmodel.apply_fn(*(torch.from_numpy(x) for x in (images, ids, mask, states)))
    expect_shape = (2, 5) if chunk == 1 else (2, chunk, 5)
    assert tuple(out.shape) == expect_shape == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    feats = tmodel.backbone.features_fn(*(torch.from_numpy(x) for x in (images, ids, mask)))
    np.testing.assert_allclose(feats.numpy(), np.asarray(feats_ref), atol=ATOL)


def test_policy_forward_host_api():
    """forward / select_action take host inputs and tokenize like the JAX policy."""
    policy = FastVLAPolicy(FastVLAConfig(**TINY), device="cpu")
    images, _, _, states = _inputs(seed=5)
    actions = policy.forward(images, states, "pick up the cube")
    assert tuple(actions.shape) == (2, 5) and torch.isfinite(actions).all()
    assert not actions.requires_grad
    assert tuple(policy.select_action(images[0], states[0], "push").shape) == (5,)
    ids, mask = policy.model.backbone._prep_text(["pick up the cube\n"])
    from vla_fastvlm_tpu.io.tokenizer import ByteTokenizer

    jb = ByteTokenizer()(["pick up the cube\n"], padding="max_length", max_length=16)
    np.testing.assert_array_equal(ids, jb.input_ids)
    np.testing.assert_array_equal(mask, jb.attention_mask)
    policy.reset()


@pytest.mark.parametrize("layout", ["bchw", "bhwc", "list_chw", "time_major"])
def test_policy_forward_takes_tensors(layout):
    """Tensor images and states give the numpy inputs' actions, and stay tensors."""
    policy = FastVLAPolicy(FastVLAConfig(**TINY), device="cpu")
    images, _, _, states = _inputs(seed=9)
    ref = policy.forward(images, states, "stack the cups")
    timg, tstates = torch.from_numpy(images), torch.from_numpy(states).double()
    if layout == "bhwc":
        timg = timg.permute(0, 2, 3, 1)
    elif layout == "list_chw":
        timg = list(timg)
    elif layout == "time_major":  # (B, T, ...): the latest step is used
        timg = torch.stack([torch.zeros_like(timg), timg], dim=1)
        tstates = torch.stack([torch.zeros_like(tstates), tstates], dim=1)
    assert isinstance(policy.processor.prepare_images(timg), torch.Tensor)
    out = policy.forward(timg, tstates, "stack the cups")
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_text_only_mode_matches_jax():
    """image_token_mode='none': the tower is not built and features are text-only."""
    jmodel, params = _jax_model(7, image_token_mode="none")
    images, ids, mask, states = _inputs(seed=7)
    ref = jmodel._jit_apply(params, *(jnp.asarray(x) for x in (images, ids, mask, states)))
    tmodel = FastVLMWithExpert(FastVLAConfig(**TINY, image_token_mode="none"), device="cpu")
    assert not hasattr(tmodel.backbone.model, "vision_tower")
    tmodel.load_jax_params(params)
    out = tmodel.apply_fn(*(torch.from_numpy(x) for x in (images, ids, mask, states)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


# Options of the policy's preprocessing and decoder, each against the JAX
# package at fp32 through the host API (tokenizer, letterbox, splice); fp32
# sums in another order, as ATOL above, held here to 1e-5.
OPTION_ATOL = 1e-5


@pytest.mark.parametrize("option", [
    dict(num_cameras=2), dict(fused_projections=False), dict(resize_with_padding=False), dict(pad_value=0.5),
    dict(tokenizer_padding_side="left"), dict(pad_to_max_length=True), dict(add_trailing_newline=False),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_policy_forward_options_match_jax(option):
    from vla_fastvlm_tpu.fastvla import FastVLAPolicy as JPolicy

    jpolicy = JPolicy(JConfig(**TINY, fabricate_params=True, **option))
    params = random_params(jpolicy.params, 11)
    jpolicy.load_params(params)
    policy = FastVLAPolicy(FastVLAConfig(**TINY, **option), device="cpu")
    policy.load_jax_params(params)
    rng = np.random.default_rng(12)
    cams = (2,) if option.get("num_cameras") else ()
    images = rng.random((2,) + cams + (3, 48, 64), dtype=np.float32)
    states = rng.standard_normal((2, 6)).astype(np.float32)
    tasks = ["pick up the cube", "open"]
    out = policy.forward(images, states, tasks)
    np.testing.assert_allclose(out.numpy(), np.asarray(jpolicy.forward(images, states, tasks)), atol=OPTION_ATOL)
