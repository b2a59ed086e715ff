"""The port's checkpoints against the JAX package's, on the CPU.

Both packages write ``policy_config.json`` + ``policy_state_dict.safetensors``
with the JAX tree's dotted keys; the port reads and writes the format without
the ``safetensors`` package, which is installed here to check it. A
``fastvlm-tiny`` policy with seeded random JAX parameters crosses both ways:
the same tree and values, and the same actions (fp32 accumulation order
through the tower and 2 decoder layers: 1e-4, as the policy's parity test).
"""

import json

import jax
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.fastvla import FastVLAConfig as JConfig
from vla_fastvlm_tpu.fastvla import FastVLAPolicy as JPolicy
from vla_fastvlm_tpu.io import checkpoint as jckpt
from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy
from vla_fastvlm_tpu_torch.io import checkpoint as tckpt
from vla_fastvlm_tpu_torch.io.bridge import flatten_params, torch_params_to_jax

from _torch_parity import random_params

TINY = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", state_dim=6, action_dim=5,
            hidden_dim=16, fusion_dim=16, tokenizer_max_length=16)
ATOL = 1e-4


def _obs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return rng.random((b, 3, 40, 56), dtype=np.float32), rng.standard_normal((b, 6)).astype(np.float32), \
        ["pick up the cube", "open the drawer"][:b]


class TestSafetensors:
    def test_writer_is_read_by_safetensors(self, tmp_path):
        from safetensors.numpy import load_file
        from safetensors.torch import load_file as load_torch

        arrays = {"a.kernel": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.array([1, -2], np.int32),
                  "c.mask": np.array([True, False, True]), "d": np.zeros((0, 3), np.float16),
                  "e": np.float32(3.5) * np.ones((), np.float32), "f": np.arange(5, dtype=np.int64)}
        bf16 = torch.linspace(-3, 3, 7).to(torch.bfloat16)
        path = tmp_path / "w.safetensors"
        tckpt.save_safetensors({**arrays, "g.bf16": bf16}, path, metadata={"format": "np"})
        (n,) = np.frombuffer(path.read_bytes()[:8], "<u8")
        assert (8 + int(n)) % 8 == 0
        read = load_torch(str(path))
        assert torch.equal(read["g.bf16"], bf16)
        read_np = load_file(str(path))
        for key, value in arrays.items():
            assert read_np[key].dtype == value.dtype and read_np[key].shape == value.shape
            np.testing.assert_array_equal(read_np[key], value)

    def test_reader_takes_safetensors_files(self, tmp_path):
        from safetensors.torch import save_file

        tensors = {"x": torch.randn(4, 5), "y": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                   "z": torch.randn(3).to(torch.bfloat16), "w": torch.tensor([True, False])}
        save_file(tensors, str(tmp_path / "t.safetensors"))
        read = tckpt.load_safetensors(tmp_path / "t.safetensors")
        assert set(read) == set(tensors)
        for key, value in tensors.items():
            assert read[key].dtype == value.dtype and torch.equal(read[key], value)

    def test_reader_rejects_a_truncated_file(self, tmp_path):
        path = tmp_path / "w.safetensors"
        tckpt.save_safetensors({"a": np.ones((64,), np.float32)}, path)
        path.write_bytes(path.read_bytes()[:-4])
        with pytest.raises(ValueError, match="offsets"):
            tckpt.load_safetensors(path)


def _jax_policy(seed):
    jpolicy = JPolicy(JConfig(**TINY, fabricate_params=True))
    jpolicy.load_params(random_params(jpolicy.params, seed))
    return jpolicy


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jpolicy = _jax_policy(0)
    jckpt.save_policy_checkpoint(tmp_path, jpolicy.config, jpolicy.params)
    policy, device = tckpt.load_policy_from_checkpoint(tmp_path, device="cpu")
    assert device == torch.device("cpu") and policy.config.vlm_model_name == "fastvlm-tiny"
    images, states, tasks = _obs()
    np.testing.assert_allclose(policy.forward(images, states, tasks).numpy(),
                               np.asarray(jpolicy.forward(images, states, tasks)), atol=ATOL)


def test_port_checkpoint_loads_through_jax(tmp_path):
    jpolicy = _jax_policy(1)
    policy = FastVLAPolicy(FastVLAConfig(**TINY, fabricate_params=True), device="cpu")
    policy.load_jax_params(jax.device_get(jpolicy.params))
    tckpt.save_policy_checkpoint(tmp_path, policy.config, policy.jax_params(as_numpy=False))
    config, params = jckpt.load_policy_state(tmp_path)
    assert config == json.loads(json.dumps(jckpt.dataclasses.asdict(jpolicy.config)))
    expect = flatten_params(jax.device_get(jpolicy.params))
    got = flatten_params(params)
    assert sorted(got) == sorted(expect)
    for key, value in expect.items():
        assert got[key].dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=key)
    loaded, _ = jckpt.load_policy_from_checkpoint(tmp_path)  # the JAX loader's strict key check
    images, states, tasks = _obs(3)
    np.testing.assert_allclose(np.asarray(loaded.forward(images, states, tasks)),
                               policy.forward(images, states, tasks).numpy(), atol=ATOL)


def test_inverse_bridge_gives_the_jax_tree():
    """torch_params_to_jax of the port's modules: the JAX tree's names,
    shapes and values (stacked decoder layers or layers_<i>)."""
    jpolicy = _jax_policy(2)
    policy = FastVLAPolicy(FastVLAConfig(**TINY), device="cpu")
    policy.load_jax_params(jax.device_get(jpolicy.params))
    expect = flatten_params(jax.device_get(jpolicy.params))
    got = flatten_params(policy.jax_params())
    assert sorted(got) == sorted(expect)
    for key, value in expect.items():
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=key)
    unscanned = flatten_params(torch_params_to_jax(policy.model.backbone.model, scanned=False))
    layer = "language_model.layers_1.self_attn.q_proj.kernel"
    np.testing.assert_array_equal(unscanned[layer], expect["backbone.language_model.layers.self_attn.q_proj.kernel"][1])


def test_strict_load_rejects_a_partial_checkpoint(tmp_path):
    policy = FastVLAPolicy(FastVLAConfig(**TINY), device="cpu")
    tree = policy.jax_params(as_numpy=False)
    del tree["head"]["action_head"]
    tckpt.save_policy_checkpoint(tmp_path, policy.config, tree)
    with pytest.raises(RuntimeError, match="action_head"):
        tckpt.load_policy_from_checkpoint(tmp_path, device="cpu")
    loose, _ = tckpt.load_policy_from_checkpoint(tmp_path, device="cpu", strict=False)
    assert torch.equal(loose.model.head.fusion_fc2.weight, policy.model.head.fusion_fc2.weight)
    (tmp_path / tckpt.POLICY_WEIGHTS).unlink()
    with pytest.raises(FileNotFoundError, match="policy_state_dict"):
        tckpt.load_policy_state(tmp_path)


def test_prune_and_train_state(tmp_path):
    for name in ("step-1", "step-2", "step-10", "preempt-step-3", "final"):
        (tmp_path / name).mkdir()
    removed = tckpt.prune_checkpoints(tmp_path, keep_last_n=1)
    assert sorted(p.name for p in removed) == ["step-1", "step-2"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["final", "preempt-step-3", "step-10"]
    assert tckpt.prune_checkpoints(tmp_path, keep_last_n=None) == []
    state = {"optimizer": {"state": {0: {"exp_avg": torch.ones(3)}}, "param_groups": [{"betas": (0.9, 0.95)}]},
             "global_step": 7, "generator": torch.Generator().manual_seed(1).get_state()}
    tckpt.save_train_state(tmp_path / "step-10", state)
    back = tckpt.load_train_state(tmp_path / "step-10")
    assert back["global_step"] == 7 and back["optimizer"]["param_groups"][0]["betas"] == (0.9, 0.95)
    assert torch.equal(back["generator"], state["generator"])
