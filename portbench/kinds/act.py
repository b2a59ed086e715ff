"""Closed-loop policy ticks: every tick hands a fleet's numpy observations
(float CHW frames in [0, 1], states, task strings) to
``FastVLAPolicy.forward`` and fetches the actions to the host.

Traffic keys: ``robots`` (rows a tick), ``frame_hw``, ``image_size`` (the
policy's input size), ``dtype`` / ``param_dtype``, ``task_verbs`` /
``task_objects`` (task strings are a verb and an object drawn from the seed),
``observation_batches`` (distinct observations made in set-up and cycled),
``check_ticks`` (ticks of the window compared with the reference),
``profile_ticks`` (ticks of a traced run's profiled segment).

Compared: ``act_err``, the largest |program - reference| over the checked
ticks' actions, over the root mean square of the reference's.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import trace
from ..common import Window, p95, rng, sub_seed, timed_loop
from ..reference import bounds, flops
from ..reference import model as R
from ..reference.config import ModelCfg
from ..reference.tokenizer import tokenize_tasks
from ..reference.weights import Weights

PREP = ("prepare_images", "prepare_states", "prepare_tasks")
BACKBONE_PREP = ("_as_bchw", "_prep_text", "to_device")


class Cell:
    def __init__(self, cfg: ModelCfg, raw_cfg: dict, traffic: dict, seed: int, device, traced: bool) -> None:
        self.cfg, self.raw, self.t, self.seed = cfg, raw_cfg, traffic, seed
        self.device, self.traced = torch.device(device), traced
        self.ranges = trace.Ranges() if traced else None
        self.policy = None
        self.ticks = []  # (observation index, actions on the host) of every window tick
        self._W = None

    # -- inputs ----------------------------------------------------------

    def _observations(self):
        t, b = self.t, self.t["robots"]
        h, w = t["frame_hw"]
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "frames"))
        obs = []
        r = rng(self.seed, "tasks")
        for _ in range(t["observation_batches"]):
            frames = torch.rand((b, 3, h, w), generator=gen, device=self.device).cpu().numpy()
            states = torch.randn((b, self.cfg.head.state_dim), generator=gen, device=self.device).cpu().numpy()
            tasks = [f"{t['task_verbs'][i]} {t['task_objects'][j]}"
                     for i, j in zip(r.integers(len(t["task_verbs"]), size=b),
                                     r.integers(len(t["task_objects"]), size=b))]
            obs.append((frames, states, tasks))
        return obs

    # -- the program -----------------------------------------------------

    def setup(self) -> None:
        from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy

        from ..port import load_policy_weights

        t, h = self.t, self.cfg.head
        pcfg = FastVLAConfig(
            vlm_model_name=self.raw["port_preset"], bootstrap_model_name=self.raw["port_preset"],
            image_size=t["image_size"], tokenizer_max_length=self.cfg.tokenizer_max_length,
            dtype=t["dtype"], param_dtype=t["param_dtype"], state_dim=h.state_dim, action_dim=h.action_dim,
            hidden_dim=h.hidden_dim, fusion_dim=h.fusion_dim, dropout=h.dropout, seed=0,
        )
        self.policy = FastVLAPolicy(pcfg, device=self.device)
        load_policy_weights(self.policy, self.cfg, self.seed)
        self.obs = self._observations()
        if self.traced:
            self._instrument()
        for i in range(2):  # every shape of the window: one tick size
            self._tick(i)
        self.ticks.clear()
        if self.traced:
            self.ranges.host_s.clear()

    def _instrument(self) -> None:
        ranges, policy = self.ranges, self.policy
        for attr in PREP:
            ranges.wrap(policy.processor, attr, "prep")
        backbone = policy.model.backbone
        for attr in BACKBONE_PREP:
            ranges.wrap(backbone, attr, "prep")
        model = backbone.model
        ranges.wrap(model, "encode_images", "tower")
        ranges.wrap(model.language_model, "forward", "decoder")
        from vla_fastvlm_tpu_torch.models.fastvit import RepMixerBlock

        for block in model.vision_tower.modules():
            if isinstance(block, RepMixerBlock):
                hidden = block.hidden
                ranges.wrap(block, "forward", "repmixer",
                            bound=lambda a, k, out, f=hidden: bounds.repmixer_seconds(*out.shape, f,
                                                                                     out.element_size()))

    def _tick(self, i: int) -> float:
        frames, states, tasks = self.obs[i % len(self.obs)]
        t0 = time.perf_counter()
        with trace.span("tick"):
            out = self.policy.forward(frames, states, tasks)
            with trace.span("fetch"):
                actions = out.float().cpu().numpy()
        dt = time.perf_counter() - t0
        self.ticks.append((i % len(self.obs), actions))
        return dt

    def window(self, seconds: float) -> Window:
        tick_s, prep_s = [], []

        def step(i: int) -> bool:
            before = len(self.ranges.host_s["prep"]) if self.traced else 0
            tick_s.append(self._tick(i))
            if self.traced:
                prep_s.append(sum(self.ranges.host_s["prep"][before:]))
            return True

        secs = timed_loop(seconds, step)
        n = len(tick_s)
        out = Window(seconds=secs, attempted=n, failed=0, host_s={"tick": tick_s, "prep": prep_s}, units=n)
        out.metrics = {"actions_per_s": n * self.t["robots"] / secs, "control_tick_p95_ms": p95(tick_s) * 1e3}
        return out

    def profile(self) -> trace.Summary:
        start = len(self.ticks)
        self.ranges.bounds_on = True

        def run():
            for i in range(self.t["profile_ticks"]):
                self._tick(start + i)

        summary = trace.profile(run, self.device)
        self.ranges.bounds_on = False
        del self.ticks[start:]
        return summary

    def profiled_units(self) -> int:
        return self.t["profile_ticks"]

    def window_flops(self, window: Window) -> float:
        t = self.t
        per_tick = flops.policy_forward(self.cfg, t["robots"], t["frame_hw"], t["image_size"],
                                        self.cfg.tokenizer_max_length)
        return per_tick * window.attempted

    def release(self) -> None:
        if self.ranges is not None:
            self.ranges.restore()
        self.policy = None

    # -- the comparison ----------------------------------------------------

    def _checked(self):
        """The window ticks compared: ``check_ticks`` drawn from the seed."""
        r = rng(self.seed, "check")
        n = len(self.ticks)
        picks = sorted(r.choice(n, size=min(self.t["check_ticks"], n), replace=False).tolist())
        return [self.ticks[i] for i in picks]

    def _reference(self, obs_index: int, P=None) -> np.ndarray:
        frames, states, tasks = self.obs[obs_index]
        ids, mask = tokenize_tasks(tasks, self.cfg.tokenizer_max_length)
        dev = self.device
        with torch.no_grad(), R.exact_fp32():
            a = R.policy_actions(self._W, self.cfg, torch.from_numpy(frames).to(dev), torch.from_numpy(ids).to(dev),
                                 torch.from_numpy(mask).to(dev), torch.from_numpy(states).to(dev),
                                 self.t["image_size"], P)
        return a.cpu().numpy().astype(np.float64)

    def _act_err(self, got: Dict[int, list]) -> Dict[str, float]:
        """``got``: observation index -> actions of the program (or the
        control) on it, against the float32 reference."""
        if self._W is None:
            self._W = Weights(self.cfg, self.seed, self.device)
        refs = {i: self._reference(i) for i in got}
        worst = max(np.abs(np.asarray(a, np.float64) - refs[i]).max() for i, acts in got.items() for a in acts)
        rms = float(np.sqrt(np.mean(np.concatenate([refs[i] for i in got]) ** 2)))
        self._W = None
        return {"act_err": float(worst / rms)}

    def compare(self) -> Dict[str, float]:
        got: Dict[int, list] = {}
        for i, actions in self._checked():
            got.setdefault(i, []).append(actions)
        if not got:
            return {"act_err": float("inf")}
        return self._act_err(got)

    def control(self) -> Dict[str, float]:
        """The reference in float8 products in the program's place, on the
        observations of ``check_ticks`` ticks."""
        n = min(self.t["check_ticks"], len(self.obs))
        self._W = Weights(self.cfg, self.seed, self.device)
        got = {i: [self._reference(i, R.FP8())] for i in range(n)}
        return self._act_err(got)
