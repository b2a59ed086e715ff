"""Closed-loop batched policy evaluation of the port (twin of the
repository's ``scripts/eval_closed_loop.py``).

    python -m vla_fastvlm_tpu_torch.scripts.eval_closed_loop --model-id fastvlm-0.5b --dtype bfloat16 \\
        --num-envs 64 --image-size 256 --max-steps 10
    python -m vla_fastvlm_tpu_torch.scripts.eval_closed_loop --action-head token --serving paged ...

Drives B parallel environments with one batched policy through
``BatchedEnvRunner`` (``serving/policy_runtime.py``), with the same
``ClosedLoopArgs`` flags as the JAX script. Environments: ``--env dummy``
(the built-in synthetic env: throughput and control latency, not task
success) or ``--env gym:<id>`` (a gymnasium env whose observation dict holds
an image and a state vector; ``gymnasium`` is imported only then). The token
head (``--action-head token``) runs a control tick as one batched
generation (``--serving batch``) or as requests to a dense, paged or
speculative-paged server (``serving/token_policy_server.py``) that
letterboxes the raw frames inside admission (``image_prep``).

Prints one JSON summary: returns and lengths, ``actions_per_sec``,
``p50_control_latency_ms``, the device, and for a token server the server
calls and decode ticks per control tick. ``--device`` is the card unless
``--device cpu`` is given; without CUDA the script raises. ``--dp`` / ``--tp``
above 1 run the MLP policy's step through ``ShardedPolicyRuntime`` on a
("data", "model") mesh (the envs split over ``data``): under ``torchrun`` on
its ranks, else on ``dp * tp`` ranks the command starts itself; rank 0
prints. ``--quantization int8|int4|w8a8`` quantizes the
policy's decoder (``io/quantize.py``); a ``--draft-model-id`` preset stays
float, and ``self`` drafts with the quantized target.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..fastvla import FastVLAConfig, FastVLAPolicy, FastVLMTokenPolicy
from ..io.checkpoint import load_policy_from_checkpoint
from ..io.presets import resolve_fastvlm_config
from ..parallel import cli_mesh, is_main_rank, needs_own_ranks, spawn_ranks
from ..parallel.sharding import tp_text_config
from ..model.fastvlm_adapter import prepare_policy_images
from ..serving import (
    ActionQueuePolicy,
    BatchedEnvRunner,
    GenerationServer,
    PagedGenerationServer,
    ShardedPolicyRuntime,
    SpeculativePagedGenerationServer,
    TokenPolicyServer,
)
from ..utils import configure_logging, parse_cli


@dataclass
class ClosedLoopArgs:
    checkpoint_dir: Optional[str] = None  # None -> random-init policy
    model_id: str = "fastvlm-tiny"
    env: str = "dummy"
    num_envs: int = 16
    max_steps: int = 50
    task: str = "complete the task"
    n_action_steps: int = 1
    state_dim: int = 14
    action_dim: int = 14
    image_size: int = 64
    gym_image_key: str = "pixels"
    gym_state_key: str = "state"
    # The card unless "cpu" is asked for.
    device: Optional[str] = None
    seed: int = 0
    dtype: str = "float32"
    quantization: str = "none"
    fabricate: bool = False
    # Model input resolution (None -> the preset's); env frames stay at
    # --image-size and are letterboxed on the card.
    model_image_size: Optional[int] = None
    # Mesh factors of the JAX script; the port serves on one card.
    dp: int = 1
    tp: int = 1
    # > 1 pipelines env groups against the card (BatchedEnvRunner.run).
    stagger: int = 1
    # "mlp": the regression head; "token": actions decoded as tokens.
    action_head: str = "mlp"
    action_bins: int = 256
    action_token_low: float = -1.0
    action_token_high: float = 1.0
    # One forward emits (chunk_size, action_dim); the queue serves
    # n_action_steps of them.
    chunk_size: int = 1
    # Token head: "batch" (one batched generation a tick) or "dense" |
    # "paged" | "spec-paged" (requests through that server).
    serving: str = "batch"
    num_slots: int = 16
    prefill_batch: int = 4
    page_size: int = 16
    kv_cache_quantization: str = "none"
    # spec-paged: the draft preset, or "self" for the target as its own draft.
    draft_model_id: str = "fastvlm-tiny"
    spec_k: int = 4
    # Print every control tick's latency as it lands.
    log_ticks: bool = False


class DummyEnv:
    """Synthetic env: random images, integrator state, fixed horizon."""

    def __init__(self, horizon: int, state_dim: int, image_hw: int, seed: int):
        self.horizon = horizon
        self.state_dim = state_dim
        self.image_hw = image_hw
        self.rng = np.random.default_rng(seed)
        self.t = 0
        self.state = np.zeros(state_dim, np.float32)

    def _obs(self):
        return {"image": self.rng.random((3, self.image_hw, self.image_hw), dtype=np.float32),
                "state": self.state.copy()}

    def reset(self):
        self.t = 0
        self.state = np.zeros(self.state_dim, np.float32)
        return self._obs()

    def step(self, action):
        self.t += 1
        self.state = 0.9 * self.state + 0.1 * np.asarray(action[: self.state_dim], np.float32)
        reward = -float(np.square(self.state).mean())
        return self._obs(), reward, self.t >= self.horizon, {}


class GymEnvAdapter:
    """Adapt a gymnasium env to the runner's obs dict protocol."""

    def __init__(self, env, image_key: str, state_key: str):
        self.env = env
        self.image_key = image_key
        self.state_key = state_key

    def _convert(self, obs):
        image = np.asarray(obs[self.image_key], np.float32)
        if image.max() > 1.0:
            image = image / 255.0
        if image.ndim == 3 and image.shape[-1] in (1, 3):
            image = np.transpose(image, (2, 0, 1))
        return {"image": image, "state": np.asarray(obs[self.state_key], np.float32)}

    def reset(self):
        obs, _info = self.env.reset()
        return self._convert(obs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._convert(obs), reward, terminated or truncated, info


def build_envs(args: ClosedLoopArgs):
    if args.env == "dummy":
        return [DummyEnv(args.max_steps, args.state_dim, args.image_size, args.seed + i)
                for i in range(args.num_envs)]
    if args.env.startswith("gym:"):
        import gymnasium as gym

        env_id = args.env.split(":", 1)[1]
        return [GymEnvAdapter(gym.make(env_id), args.gym_image_key, args.gym_state_key)
                for _ in range(args.num_envs)]
    raise ValueError(f"unknown env spec {args.env!r} (use 'dummy' or 'gym:<id>')")


def build_policy(args: ClosedLoopArgs, device: torch.device):
    """The checkpoint's policy, or a random-init one from ``args.seed``."""
    if args.checkpoint_dir:
        return load_policy_from_checkpoint(args.checkpoint_dir, device=device)[0]
    config = FastVLAConfig(
        vlm_model_name=args.model_id,
        bootstrap_model_name=args.model_id,
        state_dim=args.state_dim,
        action_dim=args.action_dim,
        image_size=args.model_image_size,
        dtype=args.dtype,
        param_dtype=args.dtype,
        quantization=args.quantization,
        kv_cache_quantization=args.kv_cache_quantization,
        fabricate_params=args.fabricate,
        dropout=0.0,
        action_head=args.action_head,
        action_bins=args.action_bins,
        action_token_low=args.action_token_low,
        action_token_high=args.action_token_high,
        chunk_size=args.chunk_size,
        seed=args.seed,
    )
    policy_cls = FastVLMTokenPolicy if args.action_head == "token" else FastVLAPolicy
    return policy_cls(config, device=device)


def build_token_server(args: ClosedLoopArgs, policy: FastVLMTokenPolicy) -> TokenPolicyServer:
    """Mount the token policy's control ticks on a dense, paged or
    speculative-paged server that letterboxes raw frames inside admission."""
    mcfg, bcfg = policy.backbone.model_config, policy.backbone.config
    model = policy.backbone.model
    ids, _ = policy.backbone._prep_text([args.task])
    kwargs = dict(
        num_slots=args.num_slots,
        prompt_len=ids.shape[1] + args.state_dim,
        max_new_tokens=policy.num_action_tokens,
        eos_token_id=-1,
        prefill_batch=args.prefill_batch,
        image_prep=lambda imgs: prepare_policy_images(imgs, mcfg, bcfg),
    )
    if args.serving == "dense":
        server = GenerationServer(model, **kwargs)
    elif args.serving == "paged":
        server = PagedGenerationServer(model, page_size=args.page_size, **kwargs)
    elif args.serving == "spec-paged":
        server = SpeculativePagedGenerationServer(model, build_draft(args, policy), k=args.spec_k,
                                                  page_size=args.page_size, **kwargs)
    else:
        raise ValueError(f"unknown --serving {args.serving!r} (use batch | dense | paged | spec-paged)")
    return TokenPolicyServer(policy, server)


def build_draft(args: ClosedLoopArgs, policy: FastVLMTokenPolicy):
    """The draft of a spec-paged server: ``"self"`` is the target itself
    (every proposal verifies: the acceptance-1 upper bound); a preset id
    builds that FastVLM at the target's resolution and dtypes, its vocab
    padded to the target's, weights random from ``seed + 7``."""
    from ..models import FastVLM, fastvlm_0_5b, fastvlm_1_5b, fastvlm_7b, fastvlm_tiny, init_weights

    target = policy.backbone.model
    if args.draft_model_id == "self":
        return target
    presets = {"fastvlm-tiny": fastvlm_tiny, "fastvlm-0.5b": fastvlm_0_5b, "fastvlm-1.5b": fastvlm_1_5b,
               "fastvlm-7b": fastvlm_7b}
    tcfg = target.cfg
    cfg = presets[args.draft_model_id]()
    cfg = cfg.replace(
        image_size=tcfg.image_size,
        vision=cfg.vision.replace(dtype=tcfg.vision.dtype, param_dtype=tcfg.vision.param_dtype),
        text=cfg.text.replace(vocab_size=tcfg.text.vocab_size, dtype=tcfg.text.dtype,
                              param_dtype=tcfg.text.param_dtype),
    )
    device = policy.device
    with torch.device(device):
        draft = FastVLM(cfg)
    init_weights(draft, torch.Generator(device=device).manual_seed(args.seed + 7))
    return draft.eval().requires_grad_(False)


def summarize(args: ClosedLoopArgs, policy, result, tick_times, t0: float, elapsed: float) -> dict:
    deltas = np.diff([t0] + tick_times)
    total_actions = int(result["lengths"].sum())
    summary = {
        "num_envs": args.num_envs,
        "mean_return": float(result["returns"].mean()),
        "mean_length": float(result["lengths"].mean()),
        "total_actions": total_actions,
        "actions_per_sec": total_actions / elapsed,
        "p50_control_latency_ms": float(np.median(deltas)) * 1e3,
        "device": torch.cuda.get_device_name(policy.device) if policy.device.type == "cuda" else "cpu",
    }
    if isinstance(policy, TokenPolicyServer):
        ticks = max(policy.control_ticks, 1)
        summary.update(control_ticks=policy.control_ticks,
                       server_programs_per_control_tick=policy.server_programs / ticks,
                       server_ticks_per_control_tick=policy.server_ticks / ticks)
    return summary


def main(args: ClosedLoopArgs) -> dict:
    if args.dp * args.tp > 1:
        _check_mesh_args(args)
    if needs_own_ranks(args.dp * args.tp):
        return spawn_ranks(main, args.dp * args.tp, args, device=args.device)
    mesh, device = cli_mesh(args.dp, args.tp, args.device)
    configure_logging()
    policy = build_policy(args, device)
    if args.serving != "batch":
        if not isinstance(policy, FastVLMTokenPolicy):
            raise ValueError("--serving other than 'batch' requires --action-head token (the MLP policy's "
                             "control tick is a single prefill; the generation servers serve decode-shaped work)")
        policy = build_token_server(args, policy)
    if mesh is not None:
        policy = ShardedPolicyRuntime(policy, mesh)

    runner = BatchedEnvRunner(build_envs(args), ActionQueuePolicy(policy, args.n_action_steps), task=args.task)
    tick_times = []

    def on_step(actions, done):
        now = time.perf_counter()
        if args.log_ticks:
            prev = tick_times[-1] if tick_times else t0
            print(f"[tick {len(tick_times)}] {(now - prev) * 1e3:.0f} ms", flush=True)
        tick_times.append(now)

    t0 = time.perf_counter()
    result = runner.run(max_steps=args.max_steps, on_step=on_step, stagger=args.stagger)
    elapsed = time.perf_counter() - t0
    summary = summarize(args, policy, result, tick_times, t0, elapsed)
    if is_main_rank():
        print(json.dumps(summary))
    return summary


def _check_mesh_args(args: ClosedLoopArgs) -> None:
    """``--dp`` / ``--tp`` shard the MLP policy's step (``ShardedPolicyRuntime``)
    over the envs: refuse what it cannot split."""
    if args.action_head != "mlp":
        raise ValueError("--dp / --tp shard the MLP policy's step (ShardedPolicyRuntime); the token head's "
                         "servers take no --dp")
    if args.num_envs % args.dp:
        raise ValueError(f"batch {args.num_envs} not divisible by data-parallel size {args.dp}")
    if not args.checkpoint_dir:
        tp_text_config(resolve_fastvlm_config(args.model_id, args.model_id)[0].text, args.tp)


if __name__ == "__main__":
    main(parse_cli(ClosedLoopArgs, prog="python -m vla_fastvlm_tpu_torch.scripts.eval_closed_loop"))
