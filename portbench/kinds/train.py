"""Full-backbone fine-tuning through the port's ``Trainer``: seeded batches
of camera frames, states, target actions and task strings, fed as
``Trainer.fit`` feeds them (``data/prefetch.py::device_prefetch`` with the
trainer's placer) into the trainer's step; no checkpoint is written.

Traffic keys: ``batch``, ``frame_hw`` (camera frames, letterboxed by the
port to ``image_size``), ``dtype`` (compute) and ``param_dtype``, the
optimizer's ``learning_rate``, ``weight_decay``, ``betas``, ``eps``,
``max_grad_norm``, ``warmup_ratio`` and ``max_steps`` (the schedule's
length), ``prefetch_batches``, ``task_verbs`` / ``task_objects``,
``batches`` (distinct batches made in set-up and cycled), ``checked_steps``
(steps set-up runs and the reference follows), ``reference_rows`` (rows the
reference differentiates at once), ``profile_steps``.

Set-up builds the policy and the trainer once, runs the first
``checked_steps`` steps through the window's own feed and step on distinct
batches, and keeps, per parameter leaf: the first step's gradient as
AdamW received it (its first moment after one step over 1 - beta1) and
the change after the checked steps. The window goes on with the same
trainer and feed.

Compared, against the float32 reference's same steps: ``loss_err``, the
largest relative gap of a step's loss; ``grad_err`` and ``delta_err``, the
worst leaf's gap between the program's and the reference's norm of the
first gradient and of the change, over the larger of the reference leaf's
norm and the median leaf's. ``delta_err`` leaves out leaves whose
reference gradient is under a thousandth of the median leaf's: Adam moves
them by round-off alone.
"""

from __future__ import annotations

import itertools
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from .. import trace
from ..common import Window, rng, sub_seed, sync, timed_loop
from ..port import join_names
from ..reference import flops
from ..reference import model as R
from ..reference.config import ModelCfg
from ..reference.optim import AdamW, clip_global_norm
from ..reference.tokenizer import tokenize_tasks
from ..reference.weights import Weights

SKIP_GRAD = 1e-3  # reference gradient under this share of the median leaf's: moved by round-off only


def _joined(cfg: ModelCfg, norms: Dict[str, float]) -> Dict[str, float]:
    """Reference leaf norms -> norms of the trainer's leaves (``backbone.<port
    name>``, ``head.<name>``), q/k/v and gate/up joined."""
    names = Weights(cfg, 0, "meta").names()
    ports = {"head." + n[len("head."):]: [n] for n in names if n.startswith("head.")}
    ports.update({"backbone." + port: parts
                  for port, parts in join_names([n for n in names if not n.startswith("head.")]).items()})
    return {port: float(np.sqrt(sum(norms[n] ** 2 for n in parts))) for port, parts in ports.items()}


class Cell:
    def __init__(self, cfg: ModelCfg, raw_cfg: dict, traffic: dict, seed: int, device, traced: bool) -> None:
        self.cfg, self.raw, self.t, self.seed = cfg, raw_cfg, traffic, seed
        self.device, self.traced = torch.device(device), traced
        self.ranges = trace.Ranges() if traced else None
        self.steps = 0

    # -- inputs ------------------------------------------------------------

    def _batches(self) -> List[dict]:
        t, b, hd = self.t, self.t["batch"], self.cfg.head
        h, w = t["frame_hw"]
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "batches"))
        r = rng(self.seed, "tasks")
        out = []
        for _ in range(t["batches"]):
            out.append({
                "images": torch.rand((b, 3, h, w), generator=gen, device=self.device).cpu().numpy(),
                "states": torch.randn((b, hd.state_dim), generator=gen, device=self.device).cpu().numpy(),
                "actions": torch.randn((b, hd.action_dim), generator=gen, device=self.device).cpu().numpy(),
                "tasks": [f"{t['task_verbs'][i]} {t['task_objects'][j]}"
                          for i, j in zip(r.integers(len(t["task_verbs"]), size=b),
                                          r.integers(len(t["task_objects"]), size=b))],
            })
        return out

    # -- the program -------------------------------------------------------

    def setup(self) -> None:
        from vla_fastvlm_tpu_torch.data.prefetch import device_prefetch
        from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy
        from vla_fastvlm_tpu_torch.training import Trainer, TrainingConfig

        from ..port import load_policy_weights

        t, h = self.t, self.cfg.head
        pcfg = FastVLAConfig(
            vlm_model_name=self.raw["port_preset"], bootstrap_model_name=self.raw["port_preset"],
            image_size=t["image_size"], tokenizer_max_length=self.cfg.tokenizer_max_length,
            dtype=t["dtype"], param_dtype=t["param_dtype"], state_dim=h.state_dim, action_dim=h.action_dim,
            hidden_dim=h.hidden_dim, fusion_dim=h.fusion_dim, dropout=h.dropout, freeze_backbone=False,
            train_backbone=True, seed=0,
        )
        policy = FastVLAPolicy(pcfg, device=self.device)
        load_policy_weights(policy, self.cfg, self.seed)
        tcfg = TrainingConfig(
            max_steps=t["max_steps"], learning_rate=t["learning_rate"], weight_decay=t["weight_decay"],
            betas=tuple(t["betas"]), eps=t["eps"], warmup_ratio=t["warmup_ratio"],
            max_grad_norm=t["max_grad_norm"], mixed_precision="bf16" if t["dtype"] == "bfloat16" else "no", seed=0,
            prefetch_batches=t["prefetch_batches"], report_to=[], save_on_preemption=False,
        )
        self.policy = policy
        self.trainer = Trainer(policy, train_dataloader=[], config=tcfg)
        self.batches = self._batches()
        self.feed = device_prefetch(itertools.cycle(self.batches), size=t["prefetch_batches"],
                                    placer=lambda batch: self.trainer._place_batch(batch))
        if self.traced:
            self._instrument()
        self._checked_steps()
        if self.traced:
            self.ranges.host_s.clear()

    def _leaves(self) -> Dict[str, torch.nn.Parameter]:
        return {f"{part}.{name}": p for part, sub in self.trainer.trainable.items() for name, p in sub.items()}

    def _checked_steps(self) -> None:
        """The first steps, through the window's own feed and step."""
        leaves = self._leaves()
        start = {name: p.detach().clone() for name, p in leaves.items()}
        beta1 = self.t["betas"][0]
        self.losses, self.grad_norms = [], {}
        for k in range(self.t["checked_steps"]):
            metrics = self.trainer._train_step(next(self.feed))
            self.losses.append(float(metrics["loss"]))
            if k == 0:
                state = self.trainer.optimizer.state  # a leaf AdamW never stepped reads 0
                self.grad_norms = {name: float(state[p]["exp_avg"].double().norm()) / (1 - beta1)
                                   if "exp_avg" in state.get(p, {}) else 0.0 for name, p in leaves.items()}
        self.delta_norms = {name: float((p.detach() - start[name]).double().norm()) for name, p in leaves.items()}
        del start

    def _instrument(self) -> None:
        self.ranges.wrap(self.trainer, "_place_batch", "feed")
        self.ranges.wrap(self.policy, "loss_fn", "forward")
        self.ranges.wrap(self.trainer, "_grads", "backward")
        self.ranges.wrap(self.trainer, "_apply_update", "optimizer")

    def _step(self) -> None:
        with trace.span("step"):
            self.trainer._train_step(next(self.feed))
        self.steps += 1

    def window(self, seconds: float) -> Window:
        first = self.steps
        t0 = time.perf_counter()

        def step(i: int) -> bool:
            self._step()
            return True

        timed_loop(seconds, step)
        sync(self.device)  # the steps queued on the card are part of the window
        secs = time.perf_counter() - t0
        n = self.steps - first
        out = Window(seconds=secs, attempted=n, failed=0, units=n)
        out.metrics = {"samples_per_s": n * self.t["batch"] / secs}
        return out

    def profile(self) -> trace.Summary:
        def run():
            for _ in range(self.t["profile_steps"]):
                self._step()

        return trace.profile(run, self.device)

    def profiled_units(self) -> int:
        return self.t["profile_steps"]

    def window_flops(self, window: Window) -> float:
        t = self.t
        per_step = flops.policy_train(self.cfg, t["batch"], t["frame_hw"], t["image_size"],
                                      self.cfg.tokenizer_max_length)
        return per_step * window.attempted

    def release(self) -> None:
        if self.ranges is not None:
            self.ranges.restore()
        self.feed = self.trainer = self.policy = None

    # -- the comparison ----------------------------------------------------

    def reference_steps(self, P=None, fault: str = ""):
        """The checked steps in float32 (or with ``P``'s products): the losses,
        every reference leaf's first (clipped) gradient norm and its change
        after the steps. ``fault`` plants one of a training step's faults in
        the reference put in the program's place: "half_batch" (the loss the
        mean over the first half of the rows), "altered_gradient" (the
        action head's bias gradient doubled where it is produced)."""
        cfg, t, dev = self.cfg, self.t, self.device
        W = Weights(cfg, self.seed, dev)
        params = {name: W[name].clone().requires_grad_(True) for name in W.names()}
        W.drop()
        opt = AdamW(t["learning_rate"], tuple(t["betas"]), t["eps"], t["weight_decay"])
        total, warm = t["max_steps"], int(t["max_steps"] * t["warmup_ratio"])
        batches = self._batches()
        losses, grad_norms = [], {}
        start = {n: p.detach().clone() for n, p in params.items()}
        with R.exact_fp32():
            for k in range(t["checked_steps"]):
                batch = batches[k % len(batches)]
                ids, mask = tokenize_tasks(batch["tasks"], cfg.tokenizer_max_length)
                grads = {n: torch.zeros_like(p) for n, p in params.items()}
                loss_sum = 0.0
                b, rows = t["batch"], t["reference_rows"]
                used = b // 2 if fault == "half_batch" else b
                for lo in range(0, used, rows):
                    sl = slice(lo, min(lo + rows, used))
                    to = lambda a: torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)  # noqa: E731
                    preds = R.policy_actions(params, cfg, to(batch["images"]), to(ids), to(mask),
                                             to(batch["states"]), t["image_size"], P)
                    loss = (preds - to(batch["actions"])).square().sum() / (used * cfg.head.action_dim)
                    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
                    for (n, _), g in zip(params.items(), got):
                        if g is not None:
                            grads[n] += g
                    loss_sum += float(loss.detach())
                losses.append(loss_sum)
                if fault == "altered_gradient":
                    grads["head.action_head.bias"] *= 2.0
                clip_global_norm(grads, t["max_grad_norm"])
                if k == 0:
                    grad_norms = {n: float(g.double().norm()) for n, g in grads.items()}
                count = k
                lr = (t["learning_rate"] * count / max(1, warm) if count < warm else
                      t["learning_rate"] * max(0.0, (total - count) / max(1, total - warm)))
                with torch.no_grad():
                    opt.step({n: p.data for n, p in params.items()}, grads, lr)
        deltas = {n: float((p.detach() - start[n]).double().norm()) for n, p in params.items()}
        return losses, grad_norms, deltas

    def _errors(self, losses, grad_norms, deltas, ref) -> Dict[str, float]:
        """The program's (or the control's) losses and trainer-leaf norms
        against the reference's steps; ``self.worst`` names each number's
        worst leaf."""
        ref_losses, ref_grads, ref_deltas = ref
        rg, rd = _joined(self.cfg, ref_grads), _joined(self.cfg, ref_deltas)
        med_g, med_d = statistics.median(rg.values()), statistics.median(rd.values())
        moved = [n for n in rg if rg[n] >= SKIP_GRAD * med_g]
        g = {n: abs(grad_norms[n] - rg[n]) / max(rg[n], med_g) for n in rg}
        d = {n: abs(deltas[n] - rd[n]) / max(rd[n], med_d) for n in moved}
        self.worst = {"grad_err": max(g, key=g.get), "delta_err": max(d, key=d.get)}
        return {"loss_err": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
                "grad_err": max(g.values()), "delta_err": max(d.values())}

    def compare(self) -> Dict[str, float]:
        return self._errors(self.losses, self.grad_norms, self.delta_norms, self.reference_steps())

    def _as_program(self, P=None, fault: str = "") -> Dict[str, float]:
        losses, grads, deltas = self.reference_steps(P, fault)
        return self._errors(losses, _joined(self.cfg, grads), _joined(self.cfg, deltas), self._ref)

    def control(self) -> Dict[str, float]:
        """The reference with float8 products in the program's place."""
        self._ref = self.reference_steps()
        return self._as_program(R.FP8())

    def faults(self) -> Dict[str, Dict[str, float]]:
        """Each training fault planted in the reference put in the program's
        place, read against the float32 reference (after ``control``)."""
        return {fault: self._as_program(fault=fault) for fault in ("half_batch", "altered_gradient")}
