"""The port's legacy ``FastVLMPolicy`` against the JAX package's, on the CPU.

Both at ``fastvlm-tiny`` (64 px tower, 2-layer decoder) in fp32, the JAX
policy's parameters seeded random at realistic scales (``random_params``)
and moved into the port through ``load_jax_params``; the same numpy
observations through ``forward`` (also time-major and channels-last),
``compute_loss`` and ``select_action``, within 1e-5 relative L2. Task
normalization against ``tests/golden/tasks.json``; checkpoints both ways
(a config without ``vlm_model_name`` loads as ``FastVLMPolicy``).
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.io import checkpoint as jckpt
from vla_fastvlm_tpu.model.fastvlm_adapter import FastVLMBackboneConfig as JBackboneConfig
from vla_fastvlm_tpu.model.policy import FastVLMPolicy as JPolicy
from vla_fastvlm_tpu.model.policy import FastVLMPolicyConfig as JPolicyConfig
from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLMWithExpert
from vla_fastvlm_tpu_torch.io import checkpoint as tckpt
from vla_fastvlm_tpu_torch.model import FastVLMBackboneConfig, FastVLMPolicy, FastVLMPolicyConfig

from _torch_parity import random_params, rel_l2

GOLDEN = Path(__file__).parent / "golden"
# fabricate_params: JAX skips its init (the parameters are replaced); the port ignores it.
BACKBONE = dict(model_id="fastvlm-tiny", bootstrap_model_id="fastvlm-tiny", tokenizer_max_length=16,
                fabricate_params=True)
HEAD = dict(state_dim=6, action_dim=5, hidden_dim=16, fusion_dim=16)
RTOL = 1e-5


def _port_config(**backbone):
    return FastVLMPolicyConfig(backbone=FastVLMBackboneConfig(**{**BACKBONE, **backbone}), **HEAD)


@pytest.fixture(scope="module")
def pair():
    """The JAX policy with seeded random parameters and the port's policy
    holding the same ones."""
    jpolicy = JPolicy(JPolicyConfig(backbone=JBackboneConfig(**BACKBONE), **HEAD))
    params = random_params(jax.device_get(jpolicy.params), seed=0)
    jpolicy.load_params(params)
    policy = FastVLMPolicy(_port_config(), device="cpu")
    policy.load_jax_params(params)
    return jpolicy, policy


def _obs(seed=0, b=3):
    rng = np.random.default_rng(seed)
    images = rng.random((b, 3, 40, 56), dtype=np.float32)
    states = rng.standard_normal((b, 6)).astype(np.float32)
    return images, states, ["pick up the cube", "open the drawer\n", "stack"][:b]


def test_config_matches_jax():
    """The nested config's fields and defaults are JAX's, backbone included."""
    assert dataclasses.asdict(FastVLMPolicyConfig()) == dataclasses.asdict(JPolicyConfig())
    cfg = FastVLMPolicyConfig()
    assert (cfg.hidden_dim, cfg.fusion_dim, cfg.dropout) == (1024, 1024, 0.1)


@pytest.mark.parametrize("layout", ["bchw", "time_major", "bhwc"])
def test_forward_matches_jax(pair, layout):
    jpolicy, policy = pair
    images, states, tasks = _obs(seed=1)
    if layout == "time_major":  # (B, T, C, H, W) and (B, T, D): the last step is used
        images = np.stack([np.zeros_like(images), images], axis=1)
        states = np.stack([np.zeros_like(states), states], axis=1)
    elif layout == "bhwc":
        images = images.transpose(0, 2, 3, 1)
    ref = np.asarray(jpolicy.forward(images, states, tasks))
    out = policy.forward(images, states, tasks)
    assert out.shape == ref.shape == (3, 5) and out.dtype == torch.float32
    assert rel_l2(out.numpy(), ref) <= RTOL


def test_forward_rejects_a_single_image(pair):
    _, policy = pair
    images, states, _ = _obs()
    with pytest.raises(ValueError, match=r"\(B,C,H,W\)"):
        policy.forward(images[0, 0], states, "t")


def test_compute_loss_matches_jax(pair):
    jpolicy, policy = pair
    images, states, tasks = _obs(seed=2)
    actions = np.random.default_rng(3).standard_normal((3, 5)).astype(np.float32)
    batch = dict(images=images, states=states, tasks=tasks, actions=actions)
    ref = jpolicy.compute_loss(batch)
    out = policy.compute_loss(batch)
    assert set(out) == set(ref) == {"loss", "mse"}
    for key in out:
        assert rel_l2(float(out[key]), float(ref[key])) <= RTOL, key


def test_select_action_matches_jax(pair):
    jpolicy, policy = pair
    images, states, _ = _obs(seed=4)
    ref = np.asarray(jpolicy.select_action(images[0], states[0], "wipe the table"))
    out = policy.select_action(images[0], states[0], "wipe the table")
    assert out.shape == ref.shape == (5,)
    assert rel_l2(out.numpy(), ref) <= RTOL
    assert policy.reset() is None


def test_normalize_tasks_golden(pair):
    jpolicy, policy = pair
    for case in json.loads((GOLDEN / "tasks.json").read_text()):
        out = policy._normalize_tasks(case["tasks"], case["batch"])
        assert out == case["out"] == jpolicy._normalize_tasks(case["tasks"], case["batch"]), case


def test_head_dtype_and_seed():
    """The head computes in the backbone's text dtype and is seeded from
    ``backbone.seed + 1``: FastVLA's head of the same widths and seed."""
    bf16 = FastVLMPolicy(_port_config(dtype="bfloat16", seed=3), device="meta")
    assert bf16.head.dtype == torch.bfloat16 and bf16.head.action_head.weight.dtype == torch.float32
    policy = FastVLMPolicy(_port_config(seed=3), device="cpu")
    expert = FastVLMWithExpert(FastVLAConfig(vlm_model_name="fastvlm-tiny", tokenizer_max_length=16, seed=3,
                                             **HEAD), device="cpu")
    expect = expert.head.state_dict()
    got = policy.head.state_dict()
    assert list(got) == list(expect) and all(torch.equal(got[k], expect[k]) for k in got)


def test_jax_checkpoint_loads_into_the_port(pair, tmp_path):
    jpolicy, _ = pair
    jckpt.save_policy_checkpoint(tmp_path, jpolicy.config, jpolicy.params)
    assert "vlm_model_name" not in json.loads((tmp_path / jckpt.POLICY_CONFIG).read_text())
    loaded, device = tckpt.load_policy_from_checkpoint(tmp_path, device="cpu")
    assert isinstance(loaded, FastVLMPolicy) and device == torch.device("cpu")
    assert dataclasses.asdict(loaded.config) == json.loads((tmp_path / jckpt.POLICY_CONFIG).read_text())
    images, states, tasks = _obs(seed=5)
    ref = np.asarray(jpolicy.forward(images, states, tasks))
    assert rel_l2(loaded.forward(images, states, tasks).numpy(), ref) <= RTOL


def test_port_checkpoint_loads_through_jax(pair, tmp_path):
    _, policy = pair
    tckpt.save_policy_checkpoint(tmp_path, policy.config, policy.jax_params(as_numpy=False))
    written = json.loads((tmp_path / tckpt.POLICY_CONFIG).read_text())
    assert set(written) == {f.name for f in dataclasses.fields(JPolicyConfig)} and "backbone" in written
    loaded, _ = jckpt.load_policy_from_checkpoint(tmp_path)  # the JAX loader's strict key check
    assert isinstance(loaded, JPolicy)
    images, states, tasks = _obs(seed=6)
    out = policy.forward(images, states, tasks).numpy()
    assert rel_l2(out, np.asarray(loaded.forward(images, states, tasks))) <= RTOL
    back, _ = tckpt.load_policy_from_checkpoint(tmp_path, device="cpu")
    assert torch.equal(back.forward(images, states, tasks), policy.forward(images, states, tasks))


def test_strict_load_rejects_a_key_mismatch(pair, tmp_path):
    _, policy = pair
    tree = policy.jax_params(as_numpy=False)
    del tree["head"]["fusion_fc2"]
    tckpt.save_policy_checkpoint(tmp_path, policy.config, tree)
    with pytest.raises(RuntimeError, match="fusion_fc2"):
        tckpt.load_policy_from_checkpoint(tmp_path, device="cpu")
    loose, _ = tckpt.load_policy_from_checkpoint(tmp_path, device="cpu", strict=False)
    assert torch.equal(loose.head.action_head.weight, policy.head.action_head.weight)
    assert torch.equal(loose.backbone.model.mm_projector.fc1.weight, policy.backbone.model.mm_projector.fc1.weight)
