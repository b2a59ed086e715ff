"""The port's closed loop against the JAX package on the CPU.

``serving/token_policy_server.py``, ``serving/policy_runtime.py``,
``image_prep`` on the four servers and ``python -m
vla_fastvlm_tpu_torch.scripts.eval_closed_loop --device cpu``, at
``fastvlm-tiny`` in fp32 with seeded random JAX parameters carried across
the weight bridge; observations are numpy-seeded frames of 48 x 80 (the
letterbox resizes them to 64).

Tolerances: greedy tokens and actions are equal (fp32 on both sides; the
argmax of these random-weight models is far from ties, as
``test_torch_action_tokens.py`` shows with the prefill's logits), and so are
the servers' call and tick counts; episode returns agree to 1e-5 relative
(the MLP head's fp32 actions through the integrator env), lengths exactly.
"""

import json

import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.fastvla import FastVLAConfig as JConfig
from vla_fastvlm_tpu.fastvla import FastVLAPolicy as JPolicy
from vla_fastvlm_tpu.fastvla import FastVLMTokenPolicy as JTokenPolicy
from vla_fastvlm_tpu.ops import image as jimage
from vla_fastvlm_tpu.serving import ActionQueuePolicy as JQueue
from vla_fastvlm_tpu.serving import BatchedEnvRunner as JRunner
from vla_fastvlm_tpu.serving import GenerationServer as JGenerationServer
from vla_fastvlm_tpu.serving import PagedGenerationServer as JPagedServer
from vla_fastvlm_tpu.serving import SpeculativePagedGenerationServer as JSpecPagedServer
from vla_fastvlm_tpu.serving import TokenPolicyServer as JTokenPolicyServer
from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy, FastVLMTokenPolicy
from vla_fastvlm_tpu_torch.model.fastvlm_adapter import prepare_policy_images
from vla_fastvlm_tpu_torch.ops import image as timage
from vla_fastvlm_tpu_torch.scripts.eval_closed_loop import ClosedLoopArgs, DummyEnv, main
from vla_fastvlm_tpu_torch.serving import (
    ActionQueuePolicy,
    BatchedEnvRunner,
    GenerationServer,
    PagedGenerationServer,
    SpeculativeGenerationServer,
    SpeculativePagedGenerationServer,
    TokenPolicyServer,
)

from _torch_parity import random_params

TOKEN = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", state_dim=3, action_dim=4,
             action_head="token", action_bins=64, dropout=0.0, tokenizer_max_length=16)
MLP = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", state_dim=4, action_dim=4,
           hidden_dim=16, fusion_dim=16, tokenizer_max_length=16, dropout=0.0)
RETURN_RTOL = 1e-5
SERVERS = ["dense", "paged", "spec-dense", "spec-paged"]


def _pair(cls, jcls, base, seed, **kw):
    jpolicy = jcls(JConfig(**base, fabricate_params=True, **kw))
    params = random_params(jpolicy.params, seed)
    jpolicy.load_params(params)
    policy = cls(FastVLAConfig(**base, **kw), device="cpu")
    policy.load_jax_params(params)
    return jpolicy, policy


@pytest.fixture(scope="module")
def token():
    return _pair(FastVLMTokenPolicy, JTokenPolicy, TOKEN, seed=0)


def _obs(b=3, seed=3, ncam=1):
    rng = np.random.default_rng(seed)
    cams = (ncam,) if ncam > 1 else ()
    return (rng.random((b,) + cams + (3, 48, 80), np.float32),
            (rng.standard_normal((b, 3)) * 0.5).astype(np.float32), ["pick", "insert the peg", "push"][:b])


def _server_kwargs(policy, prompt_tasks=("pick",)):
    ids, _ = policy.backbone._prep_text(list(prompt_tasks))
    return dict(num_slots=2, prompt_len=ids.shape[1] + policy.config.state_dim,
                max_new_tokens=policy.num_action_tokens, eos_token_id=-1, prefill_batch=2)


def _server(kind, policy, image_prep=False, **extra):
    """A port server over the policy's model: 2 slots for 3 requests (two
    waves), pages of 4, the model as its own draft at k = 2."""
    model = policy.backbone.model
    kw = dict(_server_kwargs(policy), **extra)
    if image_prep:
        mcfg, bcfg = policy.backbone.model_config, policy.backbone.config
        kw["image_prep"] = lambda imgs: prepare_policy_images(imgs, mcfg, bcfg)
    return {
        "dense": lambda: GenerationServer(model, **kw),
        "paged": lambda: PagedGenerationServer(model, page_size=4, **kw),
        "spec-dense": lambda: SpeculativeGenerationServer(model, model, k=2, **kw),
        "spec-paged": lambda: SpeculativePagedGenerationServer(model, model, k=2, page_size=4, **kw),
    }[kind]()


def _jax_server(kind, jpolicy):
    model, params = jpolicy.backbone.model, jpolicy.backbone.params
    kw = _server_kwargs(jpolicy)
    return {
        "dense": lambda: JGenerationServer(model, params, **kw),
        "paged": lambda: JPagedServer(model, params, page_size=4, **kw),
        "spec-paged": lambda: JSpecPagedServer(model, params, model, params, k=2, page_size=4, **kw),
    }[kind]()


class TestTokenPolicyServer:
    @pytest.mark.parametrize("kind", ["dense", "paged", "spec-paged"])
    def test_tokens_and_counts_match(self, token, kind):
        """Three requests in two slots: the server's tokens are the policy's
        own greedy decode, and the call and tick counts are the JAX bridge's
        on the same server."""
        jpolicy, policy = token
        images, states, tasks = _obs()
        ref = policy.forward(images, states, tasks).numpy()
        bridge = TokenPolicyServer(policy, _server(kind, policy))
        got = bridge.forward(images, states, tasks)
        assert isinstance(got, np.ndarray) and got.shape == (3, 4)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(bridge.last_tokens, policy.tokens(images, states, tasks).numpy())
        jbridge = JTokenPolicyServer(jpolicy, _jax_server(kind, jpolicy))
        np.testing.assert_array_equal(jbridge.forward(images, states, tasks), ref)
        counts = (bridge.control_ticks, bridge.server_programs, bridge.server_ticks)
        assert counts == (jbridge.control_ticks, jbridge.server_programs, jbridge.server_ticks)
        if kind == "paged":  # 2 waves, each one step_n call of action_dim - 1 ticks
            assert counts == (1, 2, 2 * (policy.config.action_dim - 1))
            pool = bridge.server.pool
            assert pool.free_pages == pool.num_pages - 1 and not pool.page_table.any()

    @pytest.mark.parametrize("kind", SERVERS)
    def test_image_prep_matches_host_letterbox(self, token, kind):
        """Raw 48 x 80 frames letterboxed inside admission give the tokens of
        the tick letterboxed at once and submitted at the tower's size."""
        _, policy = token
        images, states, tasks = _obs(seed=4)
        ref = TokenPolicyServer(policy, _server(kind, policy))
        got = TokenPolicyServer(policy, _server(kind, policy, image_prep=True))
        np.testing.assert_array_equal(got.forward(images, states, tasks), ref.forward(images, states, tasks))
        np.testing.assert_array_equal(got.last_tokens, ref.last_tokens)
        np.testing.assert_array_equal(got.last_tokens, policy.tokens(images, states, tasks).numpy())
        assert got.server.admissions == ref.server.admissions == 2

    def test_chunked_requests(self):
        _, policy = _pair(FastVLMTokenPolicy, JTokenPolicy, TOKEN, seed=1, chunk_size=3)
        images, states, tasks = _obs(seed=5)
        ref = policy.forward(images, states, tasks).numpy()
        assert ref.shape == (3, 3, 4)
        bridge = TokenPolicyServer(policy, _server("paged", policy, image_prep=True))
        np.testing.assert_array_equal(bridge.forward(images, states, tasks), ref)
        assert bridge.last_tokens.shape == (3, 12)

    def test_multicam_requests(self):
        _, policy = _pair(FastVLMTokenPolicy, JTokenPolicy, TOKEN, seed=2, num_cameras=2)
        images, states, tasks = _obs(seed=6, ncam=2)
        ref = policy.forward(images, states, tasks).numpy()
        for image_prep in (False, True):
            bridge = TokenPolicyServer(policy, _server("dense", policy, image_prep=image_prep))
            np.testing.assert_array_equal(bridge.forward(images, states, tasks), ref)

    def test_server_guards(self, token):
        _, policy = token
        with pytest.raises(ValueError, match="action_dim"):
            TokenPolicyServer(policy, _server("paged", policy, max_new_tokens=5))
        with pytest.raises(ValueError, match="eos_token_id"):
            TokenPolicyServer(policy, _server("paged", policy, eos_token_id=2))
        bridge = TokenPolicyServer(policy, _server("paged", policy))
        with pytest.raises(ValueError, match="lives on"):
            bridge.forward(*_obs(), device="meta")


def test_letterbox_matrices_equal_jax():
    """The resize matrices are built on the tensor's device, equal to the JAX
    package's numpy ones, at the closed loop's frame sizes among others."""
    for src, dst in [(37, 23), (48, 64), (80, 64), (256, 1024), (480, 1024), (640, 1024), (1024, 256)]:
        np.testing.assert_array_equal(timage._interp_matrix(src, dst, "cpu").numpy(),
                                      jimage._interp_matrix(src, dst))


class CountingPolicy:
    """A policy wrapper that counts forwards."""

    def __init__(self, policy):
        self.policy, self.config, self.forwards = policy, policy.config, 0

    def forward(self, *args):
        self.forwards += 1
        return self.policy.forward(*args)


class StatefulEnv:
    """Observations and rewards follow the actions received: any staleness
    or group-routing error changes the returns."""

    def __init__(self, seed, horizon):
        self.horizon = horizon
        self.t = 0
        self.state = np.zeros(4, np.float32)
        self.base = np.random.default_rng(seed).standard_normal((3, 32, 32)).astype(np.float32)

    def _obs(self):
        return {"image": self.base + 0.1 * self.t, "state": self.state.copy()}

    def reset(self):
        self.t = 0
        self.state = np.zeros(4, np.float32)
        return self._obs()

    def step(self, action):
        self.t += 1
        self.state = 0.5 * self.state + np.asarray(action[:4], np.float32)
        return self._obs(), float(self.state.sum()), self.t >= self.horizon, {}


@pytest.fixture(scope="module")
def mlp():
    return _pair(FastVLAPolicy, JPolicy, MLP, seed=7)


class TestRuntime:
    def test_runner_matches_jax(self, mlp):
        jpolicy, policy = mlp
        make = lambda: [DummyEnv(horizon=2 + i % 2, state_dim=4, image_hw=40, seed=i) for i in range(3)]
        ref = JRunner(make(), JQueue(jpolicy, 1), task="go").run(max_steps=4)
        got = BatchedEnvRunner(make(), ActionQueuePolicy(policy, 1), task="go").run(max_steps=4)
        np.testing.assert_allclose(got["returns"], ref["returns"], rtol=RETURN_RTOL)
        assert got["lengths"].tolist() == ref["lengths"].tolist() == [2, 3, 2]
        assert got["done"].all()

    def test_staggered_matches_serial(self, mlp):
        _, policy = mlp
        make = lambda: [StatefulEnv(seed=i, horizon=3 + i % 2) for i in range(5)]
        serial = BatchedEnvRunner(make(), ActionQueuePolicy(policy, 1), task="go").run(max_steps=6)
        ticks = []
        staggered = BatchedEnvRunner(make(), ActionQueuePolicy(policy, 1), task="go").run(
            max_steps=6, on_step=lambda a, d: ticks.append(a.copy()), stagger=2)
        np.testing.assert_allclose(staggered["returns"], serial["returns"], rtol=RETURN_RTOL)
        assert staggered["lengths"].tolist() == serial["lengths"].tolist()
        assert len(ticks) == 4 and all(t.shape == (5, 4) for t in ticks)

    def test_stagger_guard(self, mlp):
        runner = BatchedEnvRunner([StatefulEnv(0, 2)], ActionQueuePolicy(mlp[1], 1))
        with pytest.raises(ValueError, match="stagger"):
            runner.run(max_steps=2, stagger=2)
        with pytest.raises(ValueError, match="tasks"):
            BatchedEnvRunner([StatefulEnv(0, 2)], ActionQueuePolicy(mlp[1], 1), task=["a", "b"])

    @pytest.mark.parametrize("stagger", [1, 2])
    def test_chunk2_forwards_once_per_two_ticks(self, stagger):
        _, policy = _pair(FastVLAPolicy, JPolicy, MLP, seed=8, chunk_size=2)
        counting = CountingPolicy(policy)
        ticks = []
        result = BatchedEnvRunner([StatefulEnv(i, 4) for i in range(4)], ActionQueuePolicy(counting, 2)).run(
            max_steps=4, on_step=lambda a, d: ticks.append(a.copy()), stagger=stagger)
        assert result["lengths"].tolist() == [4] * 4 and len(ticks) == 4
        # Serial: 2 forwards for 4 ticks. Staggered: each of the 2 groups
        # dispatches in the prologue and when its queue drains (ticks 2 and 4).
        assert counting.forwards == (2 if stagger == 1 else 2 * 3)

    def test_action_queue(self, mlp):
        jpolicy, policy = mlp
        wrapper = ActionQueuePolicy(policy, n_action_steps=1)
        batch = {"images": np.zeros((2, 3, 32, 32), np.float32), "states": np.zeros((2, 4), np.float32),
                 "tasks": ["go", "go"]}
        pending = wrapper.dispatch_chunk(batch)
        assert isinstance(pending, torch.Tensor)  # left on the device, not waited for
        a1 = wrapper.select_action(batch)
        assert a1.shape == (2, 4) and len(wrapper._action_queue) == 0
        np.testing.assert_allclose(a1, np.asarray(JQueue(jpolicy, 1).select_action(batch)), atol=1e-5)
        assert ActionQueuePolicy.fetch_chunk(np.ones((2, 4))).shape == (2, 1, 4)
        with pytest.raises(ValueError, match="n_action_steps"):
            ActionQueuePolicy(policy, n_action_steps=2)

    def test_chunked_queue_is_time_major(self):
        _, policy = _pair(FastVLAPolicy, JPolicy, MLP, seed=9, chunk_size=3)
        wrapper = ActionQueuePolicy(policy, n_action_steps=3)
        batch = {"images": np.zeros((1, 3, 32, 32), np.float32), "states": np.zeros((1, 4), np.float32),
                 "tasks": ["go"]}
        chunk = wrapper.predict_action_chunk(batch)
        assert chunk.shape == (1, 3, 4)
        a1 = wrapper.select_action(batch)
        assert len(wrapper._action_queue) == 2
        a2, a3 = wrapper.select_action(batch), wrapper.select_action(batch)
        np.testing.assert_allclose(np.stack([a1, a2, a3], axis=1), chunk)


CLI = dict(model_id="fastvlm-tiny", state_dim=4, action_dim=4, num_envs=3, max_steps=2, image_size=64,
           num_slots=2, prefill_batch=2, spec_k=2, device="cpu")


class TestCLI:
    @pytest.mark.parametrize("head,serving", [("mlp", "batch"), ("token", "batch"), ("token", "dense"),
                                              ("token", "paged"), ("token", "spec-paged")])
    def test_runs_on_the_cpu(self, head, serving, capsys):
        summary = main(ClosedLoopArgs(**CLI, action_head=head, serving=serving))
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
        assert summary["total_actions"] == 6 and summary["mean_length"] == 2.0 and summary["device"] == "cpu"
        if serving in ("dense", "paged"):  # 3 requests in 2 slots: two step_n calls a tick
            assert summary["control_ticks"] == 2 and summary["server_programs_per_control_tick"] == 2.0
        elif serving == "spec-paged":  # the tiny draft's proposals: a round or more a wave
            assert summary["control_ticks"] == 2 and summary["server_programs_per_control_tick"] >= 2.0

    def test_self_draft_and_stagger(self):
        summary = main(ClosedLoopArgs(**CLI, action_head="token", serving="spec-paged", draft_model_id="self",
                                      stagger=3))
        assert summary["total_actions"] == 6 and summary["server_ticks_per_control_tick"] == 1.0

    # --dp / --tp shard the MLP policy: the token head and a head count
    # that 3 does not divide are refused (the first two ids name the
    # NotImplementedError these cases raised before meshes were ported).
    @pytest.mark.parametrize("kw,err", [pytest.param(dict(dp=2, action_head="token"), ValueError,
                                                     id="kw0-NotImplementedError"),
                                        pytest.param(dict(tp=3), ValueError, id="kw1-NotImplementedError"),
                                        (dict(quantization="int8"), None),
                                        (dict(serving="paged"), ValueError),
                                        (dict(action_head="token", serving="sharded"), ValueError),
                                        (dict(env="mujoco"), ValueError),
                                        (dict(quantization="int3"), ValueError)])
    def test_refusals(self, kw, err):
        if err is None:  # ported: --quantization int8 runs
            summary = main(ClosedLoopArgs(**dict(CLI, **kw)))
            assert summary["total_actions"] == 6 and summary["device"] == "cpu"
            return
        with pytest.raises(err):
            main(ClosedLoopArgs(**dict(CLI, **kw)))
