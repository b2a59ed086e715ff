"""The port's LeRobot plugin through the API stub (``tests/lerobot_stub``).

Every case of ``tests/test_lerobot_plugin.py`` against
``vla_fastvlm_tpu_torch.lerobot_fastvla`` (registration, exports, presets,
feature validation, delta indices, dimension inference, the action queue,
training ``forward``, the pipelines), the config's field schema against the
JAX plugin's, the frozen backbone, and parity with the JAX plugin at
``fastvlm-tiny`` in fp32 on the same weights and batch: the loss within
1e-5, the head's gradients within 1e-4, one ``torch.optim.AdamW`` step's
head within 1e-5 and ``predict_action_chunk`` within 1e-5 (relative L2).

Both plugins register "fastvla" in the stub's class-level registry, so the
port's registration is read right after its import; the JAX plugin is
imported after it, in the same fixture scope.
"""

import copy
import dataclasses
import functools
import sys

import jax
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu_torch.io.bridge import flatten_params, torch_params_to_jax

from _torch_parity import lerobot_stub, random_params, rel_l2

PORT, JAX = "vla_fastvlm_tpu_torch.lerobot_fastvla", "vla_fastvlm_tpu.lerobot_fastvla"
TINY = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", dropout=0.0, hidden_dim=32,
            fusion_dim=32)
LOSS_RTOL, GRAD_RTOL, UPDATE_RTOL, ACTION_RTOL = 1e-5, 1e-4, 1e-5, 1e-5


@pytest.fixture(scope="module")
def plugins():
    """The port's plugin, the stub's registry entry right after its import,
    and the JAX plugin imported after it."""
    with lerobot_stub(PORT, JAX):
        import vla_fastvlm_tpu_torch.lerobot_fastvla as port
        from lerobot.configs.policies import PreTrainedConfig

        registered = PreTrainedConfig.get_choice_class("fastvla")
        import vla_fastvlm_tpu.lerobot_fastvla as jax_plugin

        yield port, registered, jax_plugin


@pytest.fixture(scope="module")
def plugin(plugins):
    return plugins[0]


@pytest.fixture(scope="module")
def features(plugin):
    from lerobot.configs.types import FeatureType, PolicyFeature

    return {
        "input": {
            "observation.state": PolicyFeature(FeatureType.STATE, (4,)),
            "observation.images.top": PolicyFeature(FeatureType.VISUAL, (3, 64, 64)),
        },
        "output": {"action": PolicyFeature(FeatureType.ACTION, (4,))},
    }


def _config(module, features, **kw):
    return module.FastVLAConfig(input_features=features["input"], output_features=features["output"],
                                **dict(TINY, **kw))


@pytest.fixture(scope="module")
def policy(plugin, features):
    return plugin.FastVLAPolicy(_config(plugin, features, device="cpu"))


def _batch(b=2, with_action=True, time_major=False, task="stack the cube"):
    g = torch.Generator().manual_seed(0)
    img = torch.rand((b, 3, 64, 64), generator=g)
    state = torch.rand((b, 4), generator=g)
    if time_major:
        img = img[:, None]
        state = state[:, None]
    batch = {"observation.images.top": img, "observation.state": state, "task": task}
    if with_action:
        batch["action"] = torch.rand((b, 4), generator=g)
    return batch


class TestRegistration:
    def test_policy_type_registered(self, plugins):
        plugin, registered, _ = plugins
        assert registered is plugin.FastVLAConfig
        assert plugin.FastVLAConfig.type == "fastvla"

    def test_exports(self, plugin):
        for name in ("FastVLAConfig", "FastVLAPolicy", "make_fastvla_pre_post_processors"):
            assert hasattr(plugin, name), name

    def test_optimizer_scheduler_presets(self, plugin):
        cfg = plugin.FastVLAConfig()
        opt = cfg.get_optimizer_preset()
        assert (opt.lr, opt.betas, opt.eps, opt.weight_decay, opt.grad_clip_norm) == (1e-4, (0.9, 0.95), 1e-8,
                                                                                     1e-4, 1.0)
        sched = cfg.get_scheduler_preset()
        assert (sched.peak_lr, sched.num_warmup_steps, sched.num_decay_steps, sched.decay_lr) == (
            1e-4, 500, 20_000, 2.5e-6)

    @pytest.mark.parametrize("present,missing", [("observation.state", "visual observation"),
                                                 ("observation.images.top", "state observation")])
    def test_feature_validation(self, plugin, features, present, missing):
        cfg = plugin.FastVLAConfig(input_features={present: features["input"][present]},
                                   output_features=features["output"])
        with pytest.raises(ValueError, match=missing):
            cfg.validate_features()

    def test_delta_indices(self, plugin):
        cfg = plugin.FastVLAConfig(chunk_size=3, n_action_steps=2)
        assert cfg.observation_delta_indices == [0]
        assert cfg.action_delta_indices == [0, 1, 2]
        assert cfg.reward_delta_indices is None
        with pytest.raises(ValueError, match="cannot exceed"):
            plugin.FastVLAConfig(chunk_size=1, n_action_steps=2)

    def test_schema_matches_the_jax_plugin(self, plugins):
        """Field names, order and defaults letter for letter, so a config
        saved by either plugin loads in the other."""
        port, _, jax_plugin = plugins
        fields = lambda cls: [(f.name, f.default if f.default is not dataclasses.MISSING else f.default_factory())
                              for f in dataclasses.fields(cls)]
        assert fields(port.FastVLAConfig) == fields(jax_plugin.FastVLAConfig)
        assert [f.name for f in dataclasses.fields(port.FastVLAConfig)][-2:] == ["image_token_mode", "jax_dtype"]


class TestPolicy:
    def test_dims_inferred_from_features(self, policy):
        assert policy.config.state_dim == 4
        assert policy.config.action_dim == 4
        assert policy._state_key == "observation.state"
        assert policy._image_keys == ["observation.images.top"]
        assert policy.device == torch.device("cpu")

    @pytest.mark.parametrize("task", ["stack the cube", ["stack the cube"], ("a", "b\n"), None])
    def test_forward_returns_loss_and_metrics(self, policy, task):
        loss, metrics = policy.forward(_batch(task=task))
        assert loss.requires_grad and loss.dtype == torch.float32
        assert np.isfinite(loss.item())
        assert set(metrics) == {"loss", "mse"} and metrics["loss"] == metrics["mse"] == loss.item()

    def test_task_forms(self, policy):
        for task, expect in (("pick", ["pick\n", "pick\n"]), (["pick"], ["pick\n", "pick\n"]),
                             (("a", "b\n"), ["a\n", "b\n"]), (None, ["\n", "\n"]), (7, ["7\n", "7\n"])):
            assert policy._prepare_inputs(_batch(task=task))[2] == expect, task

    def test_select_action_queue(self, plugin, features):
        queued = plugin.FastVLAPolicy(_config(plugin, features, device="cpu", chunk_size=3, n_action_steps=2))
        queued.reset()
        batch = _batch(with_action=False)
        chunk = queued.predict_action_chunk(batch)
        assert tuple(chunk.shape) == (2, 3, 4)
        first = queued.select_action(batch)
        assert tuple(first.shape) == (2, 4) and len(queued._action_queue) == 1
        second = queued.select_action(batch)
        assert len(queued._action_queue) == 0
        assert torch.equal(first, chunk[:, 0]) and torch.equal(second, chunk[:, 1])

    def test_chunked_forward_keeps_the_target_chunk(self, plugin, features):
        """At chunk 3 the loss is over the whole (B, 3, D) target chunk."""
        chunked = plugin.FastVLAPolicy(_config(plugin, features, device="cpu", chunk_size=3, n_action_steps=3))
        batch = _batch(with_action=False)
        batch["action"] = torch.rand((2, 3, 4), generator=torch.Generator().manual_seed(1))
        loss, _ = chunked.forward(batch)
        with torch.no_grad():
            preds = chunked.predict_action_chunk(batch)
        assert torch.allclose(loss, torch.mean(torch.square(preds - batch["action"])), rtol=1e-6)

    @pytest.mark.parametrize("time_major", [False, True])
    def test_predict_action_chunk_shape(self, policy, time_major):
        policy.reset()
        chunk = policy.predict_action_chunk(_batch(with_action=False, time_major=time_major))
        assert tuple(chunk.shape) == (2, 1, 4) and bool(torch.isfinite(chunk).all())
        action = policy.select_action(_batch(with_action=False, time_major=time_major))
        assert tuple(action.shape) == (2, 4) and torch.equal(action, chunk[:, 0])

    def test_one_optimizer_step_trains_the_head_only(self, plugin, features):
        policy = plugin.FastVLAPolicy(_config(plugin, features, device="cpu"))
        head = {id(p) for p in policy.head.parameters()}
        optim = list(policy.get_optim_params())
        assert optim and {id(p) for p in optim} == head
        assert not any(p.requires_grad for p in policy.vlm.parameters())
        before = {k: v.clone() for k, v in policy.vlm.state_dict().items()}
        opt = torch.optim.AdamW(optim, lr=1e-2)
        batch = _batch()
        policy.train()
        loss0, _ = policy.forward(batch)
        opt.zero_grad()
        loss0.backward()
        assert all(p.grad is not None for p in optim)
        assert all(p.grad is None for p in policy.vlm.parameters())
        opt.step()
        loss1, _ = policy.forward(batch)
        assert loss1.item() != pytest.approx(loss0.item())
        assert all(torch.equal(policy.vlm.state_dict()[k], v) for k, v in before.items())
        # state_dict holds the real module tree: the VLM and the head.
        assert {k.split(".")[0] for k in policy.state_dict()} == {"vlm", "head"}


class TestProcessors:
    def test_pipelines_execute(self, plugin, policy):
        stats = {
            "observation.state": {"mean": torch.zeros(4) + 0.5, "std": torch.ones(4) * 2.0},
            "action": {"mean": torch.ones(4), "std": torch.ones(4) * 3.0},
        }
        pre, post = plugin.make_fastvla_pre_post_processors(policy.config, stats)
        assert [type(step).__name__ for step in pre.steps] == [
            "RenameObservationsProcessorStep",
            "AddBatchDimensionProcessorStep",
            "DeviceProcessorStep",
            "NormalizerProcessorStep",
        ]
        assert [type(step).__name__ for step in post.steps] == ["UnnormalizerProcessorStep", "DeviceProcessorStep"]
        obs = {"observation.images.top": torch.rand(3, 64, 64), "observation.state": torch.zeros(4) + 1.5,
               "task": "pick"}
        out = pre(obs)
        assert out["observation.images.top"].shape == (1, 3, 64, 64)
        np.testing.assert_allclose(out["observation.state"].numpy(), np.full((1, 4), 0.5), rtol=1e-5)
        action = post(torch.ones(1, 4))
        np.testing.assert_allclose(action.numpy(), np.full((1, 4), 4.0), rtol=1e-5)
        # The pre-processor's output feeds the policy.
        assert tuple(policy.select_action(out).shape) == (1, 4)

    def test_roundtrip_normalization(self, plugin, policy):
        stats = {"action": {"mean": torch.tensor([1.0, -1.0, 0.0, 2.0]), "std": torch.tensor([2.0, 0.5, 1.0, 4.0])}}
        pre, post = plugin.make_fastvla_pre_post_processors(policy.config, stats)
        raw = torch.tensor([[3.0, -2.0, 1.0, 0.0]])
        restored = post(pre({"action": raw})["action"])
        np.testing.assert_allclose(restored.numpy(), raw.numpy(), rtol=1e-4)


# ----------------------------------------------------------------------
# parity with the JAX plugin


def _head_tree(head, values=None):
    """The JAX plugin's flat head names -> numpy, of ``head``'s parameters or,
    through ``values`` (port name -> tensor), of tensors shaped like them."""
    if values is not None:
        head = copy.deepcopy(head)
        for name, p in head.named_parameters():
            p.data = values[name].detach().clone()
    return flatten_params(torch_params_to_jax(head))


@pytest.fixture(scope="module")
def pair(plugins, features):
    """The JAX plugin's policy and the port's, on the same seeded weights."""
    port, _, jax_plugin = plugins
    modeling = sys.modules[JAX + ".modeling_fastvla"]
    with pytest.MonkeyPatch.context() as mp:  # JAX skips its init: the weights are replaced below
        mp.setattr(modeling, "CoreFastVLAConfig", functools.partial(modeling.CoreFastVLAConfig, fabricate_params=True))
        jpolicy = jax_plugin.FastVLAPolicy(_config(jax_plugin, features))
    params = random_params(jax.device_get(jpolicy.model.params), seed=0)
    jpolicy.model.backbone.params = params["backbone"]
    for name, value in flatten_params(params["head"]).items():
        jpolicy._torch_head[name.replace(".", "__")].data = torch.from_numpy(np.array(value))
    policy = port.FastVLAPolicy(_config(port, features, device="cpu"))
    policy.model.load_jax_params(params)
    return jpolicy, policy


def _jax_head(jpolicy, grads=False):
    return {name: (p.grad if grads else p).detach().numpy() for name, p in
            ((n, jpolicy._torch_head[n.replace(".", "__")]) for n in jpolicy._param_names)}


def test_forward_gradients_and_update_match_jax(pair):
    jpolicy, policy = pair
    batch = _batch(b=3)
    jloss, jmetrics = jpolicy.forward(batch)
    loss, metrics = policy.forward(batch)
    assert rel_l2(loss.item(), jloss.item()) <= LOSS_RTOL
    assert rel_l2(metrics["mse"], jmetrics["mse"]) <= LOSS_RTOL

    jopt = torch.optim.AdamW(jpolicy.get_optim_params(), lr=1e-4, betas=(0.9, 0.95), weight_decay=1e-4)
    opt = torch.optim.AdamW(policy.get_optim_params(), lr=1e-4, betas=(0.9, 0.95), weight_decay=1e-4)
    for o in (jopt, opt):
        o.zero_grad()
    jloss.backward()
    loss.backward()
    jgrads = _jax_head(jpolicy, grads=True)
    grads = _head_tree(policy.head, {n: p.grad for n, p in policy.head.named_parameters()})
    assert sorted(grads) == sorted(jgrads)
    for name, ref in jgrads.items():
        assert rel_l2(grads[name], ref) <= GRAD_RTOL, name

    jopt.step()
    opt.step()
    jhead, head = _jax_head(jpolicy), _head_tree(policy.head)
    for name, ref in jhead.items():
        assert rel_l2(head[name], ref) <= UPDATE_RTOL, name


def test_predict_action_chunk_matches_jax(pair):
    jpolicy, policy = pair
    batch = _batch(b=3, with_action=False, time_major=True, task=["insert the peg"])
    ref = jpolicy.predict_action_chunk(batch)
    out = policy.predict_action_chunk(batch)
    assert tuple(out.shape) == tuple(ref.shape) == (3, 1, 4)
    assert rel_l2(out.numpy(), ref.numpy()) <= ACTION_RTOL
