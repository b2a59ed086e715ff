"""Closed-loop serving runtime: action queues and batched env stepping
(counterpart of ``vla_fastvlm_tpu/serving/policy_runtime.py``).

LeRobot's rollout calls ``select_action`` once per env step; with
``chunk_size=1`` every call is a full VLM forward. The runtime keeps those
semantics and:

- steps ``B`` envs **batched**, one policy forward per control tick for all
  of them;
- turns one forward into ``n_action_steps`` env steps through the action
  queue when the policy emits chunks (``chunk_size > 1``);
- with ``stagger > 1``, pipelines groups of envs against the card: a
  group's forward is dispatched and fetched only after the host has stepped
  the other groups' envs.

The overlap rests on ``ActionQueuePolicy.dispatch_chunk`` returning before
the card finishes: the policies copy host inputs through pinned memory and
leave their actions on the card, and ``fetch_chunk`` is the one place that
waits (``.float().cpu().numpy()``). A policy that answers on the host (the
``TokenPolicyServer``) is synchronous and simply returns numpy.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


class ActionQueuePolicy:
    """Queue-based chunked serving wrapper around a policy.

    ``select_action`` pops one action a call; on an empty queue it runs
    ``predict_action_chunk`` and queues the first ``n_action_steps`` actions
    (time-major), as the LeRobot plugin policy does.
    """

    def __init__(self, policy, n_action_steps: int = 1) -> None:
        chunk = getattr(policy.config, "chunk_size", 1)
        if n_action_steps > chunk:
            raise ValueError(
                "n_action_steps must be <= chunk_size. "
                f"Got n_action_steps={n_action_steps}, chunk_size={chunk}."
            )
        self.policy = policy
        self.n_action_steps = n_action_steps
        self.reset()

    def reset(self) -> None:
        self._action_queue: deque = deque([], maxlen=self.n_action_steps)

    def dispatch_chunk(self, batch: Dict[str, Any]):
        """Start one policy forward without waiting for its result (a tensor
        on the card, still being computed); pair with ``fetch_chunk``."""
        return self.policy.forward(batch["images"], batch["states"], batch.get("tasks", [""]))

    @staticmethod
    def fetch_chunk(pending) -> np.ndarray:
        """Wait for a ``dispatch_chunk`` result -> (B, chunk, action_dim) float32."""
        if isinstance(pending, torch.Tensor):
            actions = pending.float().cpu().numpy()
        else:
            actions = np.asarray(pending, dtype=np.float32)
        if actions.ndim == 2:  # chunk_size == 1 policies emit (B, D)
            actions = actions[:, None, :]
        return actions

    def predict_action_chunk(self, batch: Dict[str, Any]) -> np.ndarray:
        """(B, chunk, action_dim) actions for one observation batch."""
        return self.fetch_chunk(self.dispatch_chunk(batch))

    def select_action(self, batch: Dict[str, Any]) -> np.ndarray:
        """(B, action_dim): the next action, refilling the queue when empty."""
        if len(self._action_queue) == 0:
            chunk = self.predict_action_chunk(batch)[:, : self.n_action_steps]
            self._action_queue.extend(np.moveaxis(chunk, 1, 0))  # (B, D) per future step
        return self._action_queue.popleft()


class BatchedEnvRunner:
    """Drive B gym-style envs with one batched policy.

    Env protocol: ``reset() -> obs``, ``step(action) -> (obs, reward, done,
    info)``, where obs is a dict with ``image`` (C, H, W) float and ``state``
    (D,) float.
    """

    def __init__(self, envs: Sequence[Any], policy: ActionQueuePolicy, task: str | List[str] = "") -> None:
        self.envs = list(envs)
        self.policy = policy
        b = len(self.envs)
        self.tasks = [task] * b if isinstance(task, str) else list(task)
        if len(self.tasks) != b:
            raise ValueError(f"{len(self.tasks)} tasks for {b} envs")

    def _collect_obs(self, obs_list, ids=None) -> Dict[str, np.ndarray]:
        if ids is None:
            ids = range(len(obs_list))
        images = np.stack([np.asarray(obs_list[i]["image"], dtype=np.float32) for i in ids])
        states = np.stack([np.asarray(obs_list[i]["state"], dtype=np.float32) for i in ids])
        return {"images": images, "states": states, "tasks": [self.tasks[i] for i in ids]}

    def run(self, max_steps: int, on_step: Optional[Any] = None, stagger: int = 1) -> Dict[str, np.ndarray]:
        """Roll out all envs for up to ``max_steps`` control ticks.

        Returns per-env episode ``returns``, ``lengths`` and ``done``;
        finished envs keep receiving (ignored) actions so the batch shape
        stays fixed. ``on_step(actions, done)`` runs after every tick.

        ``stagger > 1`` splits the envs into that many groups and pipelines
        them: each group's forward is dispatched as soon as its queue
        drains and fetched a tick later, after the host has stepped the other
        groups' envs. Each group's actions still come from its current
        observations, so deterministic envs and policies give the results of
        ``stagger=1``; each group runs at batch B / stagger.
        """
        if stagger > 1:
            return self._run_staggered(max_steps, on_step, stagger)
        b = len(self.envs)
        obs = [env.reset() for env in self.envs]
        returns = np.zeros(b, np.float64)
        lengths = np.zeros(b, np.int64)
        done = np.zeros(b, bool)
        self.policy.reset()

        for _ in range(max_steps):
            actions = self.policy.select_action(self._collect_obs(obs))
            for i, env in enumerate(self.envs):
                if done[i]:
                    continue
                obs_i, reward, env_done, _ = env.step(np.asarray(actions[i]))
                obs[i] = obs_i
                returns[i] += float(reward)
                lengths[i] += 1
                done[i] = bool(env_done)
            if on_step is not None:
                on_step(actions, done)
            if done.all():
                break
        return {"returns": returns, "lengths": lengths, "done": done}

    def _run_staggered(self, max_steps: int, on_step, stagger: int):
        b = len(self.envs)
        if not 1 < stagger <= b:
            raise ValueError(f"stagger must be in (1, num_envs], got {stagger}")
        groups = [ids.tolist() for ids in np.array_split(np.arange(b), stagger)]
        inner = self.policy
        n_action = inner.n_action_steps

        obs = [env.reset() for env in self.envs]
        returns = np.zeros(b, np.float64)
        lengths = np.zeros(b, np.int64)
        done = np.zeros(b, bool)
        inner.reset()

        # Per-group action queues and in-flight forwards. Prologue: dispatch
        # every group before the tick loop, so each fetch comes about one
        # tick after its dispatch.
        queues: List[deque] = [deque() for _ in groups]
        pending: List[Any] = [inner.dispatch_chunk(self._collect_obs(obs, ids)) for ids in groups]

        for _ in range(max_steps):
            tick_actions = None
            for g, ids in enumerate(groups):
                if not queues[g]:
                    chunk = inner.fetch_chunk(pending[g])[:, :n_action]
                    queues[g].extend(np.moveaxis(chunk, 1, 0))
                    pending[g] = None
                actions_g = queues[g].popleft()
                if tick_actions is None:
                    tick_actions = np.zeros((b, actions_g.shape[-1]), np.float32)
                tick_actions[ids] = actions_g
                for local, i in enumerate(ids):
                    if done[i]:
                        continue
                    obs_i, reward, env_done, _ = self.envs[i].step(np.asarray(actions_g[local]))
                    obs[i] = obs_i
                    returns[i] += float(reward)
                    lengths[i] += 1
                    done[i] = bool(env_done)
                if not queues[g]:
                    # Queue drained: start this group's next forward now; the
                    # host steps the other groups while the card computes it.
                    pending[g] = inner.dispatch_chunk(self._collect_obs(obs, ids))
            if on_step is not None:
                on_step(tick_actions, done)
            if done.all():
                break
        return {"returns": returns, "lengths": lengths, "done": done}
