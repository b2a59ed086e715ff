"""Training runtime of the port (counterpart of
``vla_fastvlm_tpu/training/trainer.py``).

Same public surface: ``TrainingConfig`` (same fields and defaults) and
``Trainer(model, train_dl, eval_dl, config).fit()`` / ``.evaluate()``.

A step is eager PyTorch where JAX jits one program: the policy's
``loss_fn(train=True)`` (on the card the forward launches the flash and
RepMixer kernels), ``backward`` into the trainable parameters, their global
norm by one ``torch._foreach_norm`` and the clip
(``optax.clip_by_global_norm``), then
``torch.optim.AdamW`` with the learning rate of ``linear_warmup_decay`` at
this update. With ``gradient_accumulation_steps = k`` the gradients of k
batches are averaged before one update (``optax.MultiSteps``); the schedule
counts updates while ``global_step`` counts batches, the reference's
dual-clock quirk, kept as in JAX. The dropout masks come from the trainer's
``torch.Generator`` seeded with ``config.seed`` (the JAX step's
``dropout_rng``); the mask streams of the two packages differ.

Kept from the JAX trainer: ``logs/metrics.jsonl`` (tensorboard when
installed), evaluation, ``save_steps`` checkpoints in the JAX layout
(``io/checkpoint.py``) written on a background thread, ``keep_last_n``,
resume that restores the counters, the optimizer and the generator, the
SIGTERM / SIGINT preemption checkpoint, ``profile_start_step``
(``torch.profiler``, a Chrome trace under ``logs/profile``, which holds the
step's ``vft.`` spans, ``utils/tracing.py``) and ``debug_nans`` (raise on a
non-finite loss or gradient norm).

``mesh`` (``parallel/mesh.py``): every rank of the mesh runs the trainer
(SPMD). The policy's modules are placed by ``shard_params`` (TP pieces of
the decoder; with ``config.fsdp`` each large leaf also sharded over
``data``, ``fully_shard``) and AdamW's state follows them. Each rank takes
its ``data`` rows of every batch (``shard_batch``); gradients are averaged
over ``data``, by FSDP's reduce-scatter or by an all-reduce of the leaves
left whole. The global-norm clip sums each leaf's squares once: TP pieces
over ``model``, FSDP shards over ``data``, replicated leaves on one rank's
count. Rank 0 alone writes logs and checkpoints, which hold whole tensors
(``io/bridge.py`` gathers them), so they load unsharded in either package.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

from ..data.prefetch import device_prefetch
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_rank, axis_size, check_mesh
from ..parallel.sharding import all_reduce_sum, gather_tp, is_fsdp_param, shard_batch, shard_params, tp_pieces
from ..utils import tracing
from .schedule import clip_by_global_norm_, linear_warmup_decay

logger = logging.getLogger(__name__)


@dataclass
class TrainingConfig:
    """The JAX package's fields and defaults."""

    output_dir: str = "outputs/train"
    num_epochs: int = 10
    max_steps: Optional[int] = None
    gradient_accumulation_steps: int = 1
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    warmup_ratio: float = 0.03
    max_grad_norm: float = 1.0
    mixed_precision: Optional[str] = "bf16"
    logging_steps: int = 50
    eval_steps: int = 500
    save_steps: int = 1000
    seed: int = 42
    resume_from: Optional[str] = None
    gradient_checkpointing: bool = False
    report_to: list[str] = field(default_factory=lambda: ["tensorboard"])
    # torch.profiler over steps [profile_start_step, + profile_num_steps).
    profile_start_step: Optional[int] = None
    profile_num_steps: int = 3
    # Raise on a non-finite loss or gradient norm (one host sync a step).
    debug_nans: bool = False
    # On SIGTERM / SIGINT finish the step, save checkpoints/preempt-step-N, stop.
    save_on_preemption: bool = True
    # Checkpoints are copied to the host in the step loop and written on a thread.
    async_save: bool = True
    # Batches prepared and submitted to the card ahead of the step.
    prefetch_batches: int = 2
    # Keep only the newest N step-* checkpoints (None / 0: keep all).
    keep_last_n: Optional[int] = 5
    # FSDP (ZeRO-3-style) under a mesh: shard every large parameter, its
    # gradient and AdamW moments over ``data`` (parallel/sharding.py). A
    # no-op without a mesh.
    fsdp: bool = False


def policy_modules(model) -> List[torch.nn.Module]:
    """The modules that hold a policy's parameters: the backbone's
    ``FastVLM`` and, for the MLP policy, the head."""
    inner = getattr(model, "model", None)
    backbone = getattr(inner, "backbone", None) or model.backbone
    head = getattr(inner, "head", None)
    return [backbone.model] + ([head] if head is not None else [])


class Trainer:
    """Trainer of a FastVLA policy on one device (the policy's), or on every
    rank of a mesh."""

    def __init__(
        self,
        model,
        train_dataloader: Iterable[Dict],
        eval_dataloader: Optional[Iterable[Dict]] = None,
        config: TrainingConfig | None = None,
        mesh=None,
    ) -> None:
        self.config = config or TrainingConfig()
        self._validate_precision()
        self.model = model
        self.device = model.device
        if mesh is not None:
            check_mesh(mesh)
        self.mesh = mesh
        self.is_main = mesh is None or torch.distributed.get_rank() == 0
        if self.config.resume_from:
            # Whole weights go in before a mesh's placement cuts them; the
            # rest of the state at ``fit`` (``_load_checkpoint``).
            from ..io.checkpoint import load_policy_state

            model.load_jax_params(load_policy_state(_checkpoint_path(self.config.resume_from))[1])
        if mesh is not None:
            for module in policy_modules(model):
                shard_params(mesh, module, fsdp=self.config.fsdp)
        self.train_dataloader = train_dataloader
        self.eval_dataloader = eval_dataloader

        cfg = self.config
        self.num_training_steps = self._compute_total_training_steps()
        warmup_steps = int(self.num_training_steps * cfg.warmup_ratio)
        self._schedule = linear_warmup_decay(cfg.learning_rate, self.num_training_steps, warmup_steps)

        self.trainable = model.trainable_params()
        self._params: List[torch.nn.Parameter] = [p for sub in self.trainable.values() for p in sub.values()]
        for p in self._params:
            p.requires_grad_(True)
        self._fsdp = any(is_fsdp_param(p) for p in self._params)
        self.optimizer = torch.optim.AdamW(
            self._params, lr=self._schedule(0), betas=tuple(cfg.betas), eps=cfg.eps,
            weight_decay=cfg.weight_decay, fused=self.device.type == "cuda" and not self._fsdp,
        )
        self._layouts = self._param_layouts()
        # Each leaf's norm scaled by 1/sqrt(its copies across the mesh), so
        # that the squares summed over every rank count each element once.
        tp, data = axis_size(mesh, MODEL_AXIS), axis_size(mesh, DATA_AXIS)
        self._norm_scale = torch.tensor(
            [((1 if layout is not None else tp) * (1 if sharded else data)) ** -0.5
             for layout, sharded in self._layouts], dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.global_step = 0
        self.epoch = 0
        self.updates = 0  # optimizer updates (the schedule's clock)
        self._accum: Optional[List[torch.Tensor]] = None  # summed micro-batch gradients
        self._micro_steps = 0
        self._writer = None
        self._metrics_file = None
        self._profiler = None
        self._preempted = False
        self._save_executor = None
        self._save_future = None

    # ------------------------------------------------------------------

    def _validate_precision(self) -> None:
        precision = self.config.mixed_precision
        if precision in (None, "no", "bf16", "bfloat16", "fp16", "float16"):
            return
        logger.warning(
            "Mixed precision '%s' not supported on this backend; falling back to 'no'. (The port "
            "computes in the policy config's dtype.)",
            precision,
        )
        self.config.mixed_precision = "no"

    def _compute_total_training_steps(self) -> int:
        """Optimizer-update count."""
        if self.config.max_steps:
            return self.config.max_steps
        try:
            batches_per_epoch = len(self.train_dataloader)
        except TypeError:
            batches_per_epoch = 0
        if batches_per_epoch > 0:
            updates = max(batches_per_epoch // self.config.gradient_accumulation_steps, 1)
            return updates * self.config.num_epochs
        raise ValueError("Unable to infer total training steps from dataloader; please set max_steps.")

    # ------------------------------------------------------------------
    # the step

    @tracing.traced("train.feed")
    def _place_batch(self, batch: Dict) -> Dict:
        arrays = self.model.prepare_batch(batch)
        if self.mesh is not None:
            return shard_batch(self.mesh, arrays)
        return self.model.to_device(arrays)

    # -- the mesh's pieces -----------------------------------------------

    def _param_layouts(self) -> List[tuple]:
        """Per trainable parameter: (TP layout ``(dim, parts)`` or None,
        whether FSDP shards it); without a mesh every leaf is whole."""
        owners = {}
        for module in policy_modules(self.model) if self.mesh is not None else ():
            for m in module.modules():
                for leaf, layout in (getattr(m, "tp_layout", None) or {}).items():
                    owners[id(getattr(m, leaf))] = layout
        return [(owners.get(id(p)), is_fsdp_param(p)) for p in self._params]

    def _local(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Tensors shaped like the trainable parameters, each FSDP shard as
        its local tensor (its storage), for the ``_foreach_`` ops."""
        if not self._fsdp:
            return tensors
        return [t.to_local() if sharded else t for t, (_, sharded) in zip(tensors, self._layouts)]

    def _data_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ``data`` ranks, detached (every rank's
        batch share is equal; ``x`` itself without them)."""
        group = axis_group(self.mesh, DATA_AXIS)
        x = x.detach()
        if group is None:
            return x
        x = x.float().clone()
        torch.distributed.all_reduce(x, group=group)
        return x / axis_size(self.mesh, DATA_AXIS)

    def _grads(self, loss: torch.Tensor) -> List[torch.Tensor]:
        """Backward pass on this rank's rows; under a mesh the gradients
        averaged over ``data`` (FSDP reduce-scatters its shards; the rest
        all-reduce)."""
        for p in self._params:  # the step's gradients alone, whatever a caller left in .grad
            p.grad = None
        # Only the trainable leaves take a .grad; FSDP's hooks need every
        # unsharded leaf the forward used, so its backward runs whole.
        loss.backward(inputs=None if self._fsdp else self._params)
        grads = []
        group, data = axis_group(self.mesh, DATA_AXIS), axis_size(self.mesh, DATA_AXIS)
        for p, (_, sharded) in zip(self._params, self._layouts):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            if group is not None and not sharded:
                g = all_reduce_sum(g, group).div_(data)
            grads.append(g)
        return grads

    def _grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Global norm of the gradients (``global_norm``); under a mesh every
        leaf's squares counted once: each rank adds its pieces over the ranks
        that hold the same piece, then the sum runs over ``model`` and
        ``data``."""
        norms = torch.stack(torch._foreach_norm([t.float() for t in self._local(grads)]))
        total = torch.linalg.vector_norm(norms * self._norm_scale)
        groups = [g for g in (axis_group(self.mesh, a) for a in (MODEL_AXIS, DATA_AXIS)) if g is not None]
        if not groups:
            return total
        total = total.square()
        for group in groups:
            torch.distributed.all_reduce(total, group=group)
        return total.sqrt()

    @tracing.traced("train.step")
    def _train_step(self, arrays: Dict) -> Dict[str, torch.Tensor]:
        """One batch: loss and gradients, and an update once k batches are in.
        Returns ``{"loss", "mse", "grad_norm"}`` as device tensors (no sync)."""
        loss, metrics = self.model.loss_fn(arrays, train=True, generator=self.generator)
        grads = self._grads(loss)
        grad_norm = self._grad_norm(grads)
        metrics = {k: self._data_mean(v) for k, v in metrics.items()}
        if self.config.debug_nans and not (torch.isfinite(metrics["loss"]) and torch.isfinite(grad_norm)):
            raise FloatingPointError(
                f"non-finite loss {float(metrics['loss'])} or gradient norm {float(grad_norm)} "
                f"at step {self.global_step}"
            )
        k = self.config.gradient_accumulation_steps
        if k > 1:
            if self._accum is None:
                self._accum = grads
            else:
                torch._foreach_add_(self._local(self._accum), self._local(grads))
            self._micro_steps += 1
            if self._micro_steps < k:
                return dict(metrics, grad_norm=grad_norm)
            grads = self._accum
            torch._foreach_div_(self._local(grads), float(k))
            self._accum, self._micro_steps = None, 0
        self._apply_update(grads)
        return dict(metrics, grad_norm=grad_norm)

    def _apply_update(self, grads: List[torch.Tensor]) -> None:
        """Clip, then one AdamW update at the schedule's rate for this update."""
        if self.config.max_grad_norm is not None:
            clip_by_global_norm_(grads, self.config.max_grad_norm, self._grad_norm(grads))
        for p, g in zip(self._params, grads):
            p.grad = g
        lr = self._schedule(self.updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.updates += 1

    # ------------------------------------------------------------------
    # logging

    def _init_trackers(self) -> None:
        if not self.is_main:
            return
        output_dir = Path(self.config.output_dir)
        self._metrics_file = open(output_dir / "logs" / "metrics.jsonl", "a", encoding="utf-8")
        if "tensorboard" in (self.config.report_to or []):
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as exc:  # tensorboard is optional
                logger.warning("tensorboard tracker unavailable: %s", exc)
                return
            self._writer = SummaryWriter(log_dir=str(output_dir / "logs"))
            hparams = {k: (v if isinstance(v, (int, float, bool, str)) else str(v))
                       for k, v in asdict(self.config).items()}
            self._writer.add_text("vla_fastvlm/config", json.dumps(hparams, indent=2))

    def _log(self, metrics: Dict[str, float], step: int) -> None:
        if not self.is_main:
            return
        payload = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        self._metrics_file.write(json.dumps(payload) + "\n")
        self._metrics_file.flush()
        if self._writer is not None:
            for key, value in metrics.items():
                self._writer.add_scalar(key, float(value), step)

    # ------------------------------------------------------------------
    # fitting

    def fit(self) -> None:
        output_dir = Path(self.config.output_dir)
        if self.is_main:
            (output_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
            (output_dir / "logs").mkdir(exist_ok=True)
            with open(output_dir / "training_config.json", "w", encoding="utf-8") as f:
                json.dump(asdict(self.config), f, indent=2)
        self._init_trackers()

        if self.config.resume_from:
            self._load_checkpoint(self.config.resume_from)

        self._preempted = False
        restore_handlers = self._install_preemption_handlers()
        try:
            for epoch in range(self.epoch, self.config.num_epochs):
                self.epoch = epoch
                if hasattr(self.train_dataloader, "set_epoch"):
                    self.train_dataloader.set_epoch(epoch)
                self._train_one_epoch()
                if self._preempted or self.global_step >= self.num_training_steps:
                    break
        finally:
            restore_handlers()
            self._end_training()
        # Every rank of a mesh leaves fit() with rank 0's last checkpoint on
        # disk, as JAX's collective save returns on every host once written.
        self._mesh_barrier()

    def _mesh_barrier(self) -> None:
        """Wait for every rank of the mesh: the ``model`` groups, then the
        ``data`` groups (a rank passes its data group only after every rank
        of its row and of row 0 arrived)."""
        for axis in (MODEL_AXIS, DATA_AXIS):
            group = axis_group(self.mesh, axis)
            if group is not None:
                torch.distributed.barrier(group=group)

    def _install_preemption_handlers(self):
        if not self.config.save_on_preemption:
            return lambda: None
        import signal

        def handler(signum, frame):
            logger.warning("Received signal %s: saving preemption checkpoint after the current step.", signum)
            self._preempted = True

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                pass

        def restore():
            for sig, old in previous.items():
                signal.signal(sig, old)

        return restore

    def _end_training(self) -> None:
        if self._profiler is not None:
            self._stop_profile()
        self._join_pending_save()
        if self._save_executor is not None:
            self._save_executor.shutdown(wait=True)
            self._save_executor = None
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
            self._writer = None
        if self._metrics_file is not None:
            self._metrics_file.close()
            self._metrics_file = None

    def _maybe_profile(self) -> None:
        cfg = self.config
        if cfg.profile_start_step is None:
            return
        if self.global_step == cfg.profile_start_step and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            self._profiler = profile(activities=activities)
            self._profiler.start()
            logger.info("Started torch.profiler at step %d", self.global_step)
        elif self._profiler is not None and self.global_step >= cfg.profile_start_step + cfg.profile_num_steps:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        out = Path(self.config.output_dir) / "logs" / "profile"
        out.mkdir(parents=True, exist_ok=True)
        trace = out / f"trace_step{self.config.profile_start_step}.json"
        self._profiler.export_chrome_trace(str(trace))
        self._profiler = None
        logger.info("Stopped torch.profiler; trace in %s", trace)

    def _train_one_epoch(self) -> None:
        cfg = self.config
        # Steps are asynchronous on the card: time the window between syncs
        # (each metric fetch is one) and report the amortized step time.
        window_start = time.perf_counter()
        window_steps = 0
        stream = device_prefetch(self.train_dataloader, size=max(1, cfg.prefetch_batches), placer=self._place_batch)
        for arrays in stream:
            self._maybe_profile()
            metrics = self._train_step(arrays)
            # global_step counts batches; the schedule and the stop count use updates.
            self.global_step += 1
            window_steps += 1
            synced = False

            if self.global_step % cfg.logging_steps == 0:
                updates = self.global_step // cfg.gradient_accumulation_steps
                loss_value = float(metrics["loss"])
                step_time = (time.perf_counter() - window_start) / window_steps
                self._log(
                    {
                        "train/loss": loss_value,
                        "train/mse": metrics["mse"],
                        "train/grad_norm": metrics["grad_norm"],
                        "train/lr": self._schedule(updates),
                        "train/epoch": self.epoch,
                        "train/step_time_s": step_time,
                    },
                    step=self.global_step,
                )
                synced = True

            if self.global_step % cfg.eval_steps == 0 and self.eval_dataloader is not None:
                self._log(self.evaluate(), step=self.global_step)
                synced = True

            if self.global_step % cfg.save_steps == 0:
                self._save_checkpoint(suffix=f"step-{self.global_step}")
                synced = True

            if synced:
                window_start = time.perf_counter()
                window_steps = 0

            if self._preempted:
                self._save_checkpoint(suffix=f"preempt-step-{self.global_step}")
                break

            if cfg.max_steps and self.global_step >= cfg.max_steps:
                break

    def evaluate(self) -> Dict[str, float]:
        """Sample-weighted mean eval MSE."""
        if self.eval_dataloader is None:
            return {}
        total_loss, total_count = 0.0, 0
        for batch in self.eval_dataloader:
            arrays = self._place_batch(batch)
            _, metrics = self.model.loss_fn(arrays, train=False)
            n = arrays["actions"].shape[0] * axis_size(self.mesh, DATA_AXIS)
            total_loss += float(self._data_mean(metrics["mse"])) * n
            total_count += n
        return {"eval/mse": total_loss / max(total_count, 1)}

    # ------------------------------------------------------------------
    # checkpointing

    def _join_pending_save(self) -> None:
        if self._save_future is not None:
            future, self._save_future = self._save_future, None
            future.result()  # re-raises a failed background write

    def _whole(self, index: int, t: torch.Tensor) -> torch.Tensor:
        """A tensor shaped like trainable parameter ``index``'s piece -> the whole tensor."""
        if is_fsdp_param(t):
            t = t.full_tensor()
        layout = self._layouts[index][0]
        if layout is not None and t.ndim > 0:
            t = gather_tp(t, *layout, axis_group(self.mesh, MODEL_AXIS))
        return t

    def _piece(self, index: int, t: torch.Tensor) -> torch.Tensor:
        """A whole tensor -> this rank's piece, placed like trainable parameter ``index``."""
        from torch.distributed.tensor import distribute_tensor

        if t.ndim == 0:
            return t
        p = self._params[index]
        layout, sharded = self._layouts[index]
        t = t.to(self.device)
        if layout is not None:
            t = tp_pieces(t, layout[0], layout[1], axis_size(self.mesh, MODEL_AXIS), axis_rank(self.mesh, MODEL_AXIS))
        return distribute_tensor(t, p.device_mesh, p.placements) if sharded else t

    def _optimizer_state(self) -> Dict:
        """AdamW's state dict, every moment whole (gathered under a mesh)."""
        state = self.optimizer.state_dict()
        state["state"] = {i: {k: self._whole(i, t) for k, t in entry.items()} for i, entry in state["state"].items()}
        return state

    def _state(self) -> Dict:
        """The resumable state, copied to the host (the step goes on mutating it)."""
        snap = lambda obj: _map_tensors(obj, lambda t: t.detach().to("cpu", copy=True))
        return {
            "optimizer": snap(self._optimizer_state()),
            "global_step": self.global_step,
            "epoch": self.epoch,
            "updates": self.updates,
            "micro_steps": self._micro_steps,
            "accum": snap(None if self._accum is None else [self._whole(i, t) for i, t in enumerate(self._accum)]),
            "generator": self.generator.get_state(),
        }

    def _save_checkpoint(self, suffix: str) -> None:
        from ..io.checkpoint import prune_checkpoints, save_policy_checkpoint, save_train_state

        checkpoint_dir = Path(self.config.output_dir) / "checkpoints" / suffix
        self._join_pending_save()
        params = self.model.jax_params(as_numpy=False)  # whole tensors, gathered on every rank of a mesh
        state = self._state()
        if not self.is_main:
            return
        model_config = self.model.config
        keep_last_n = self.config.keep_last_n

        def write():
            save_policy_checkpoint(checkpoint_dir, model_config, params)
            save_train_state(checkpoint_dir, state)
            for path in prune_checkpoints(checkpoint_dir.parent, keep_last_n):
                logger.info("Pruned old checkpoint %s", path)
            logger.info("Saved checkpoint %s", checkpoint_dir)

        if not self.config.async_save:
            write()
            return
        if self._save_executor is None:
            import concurrent.futures

            self._save_executor = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-save")
        self._save_future = self._save_executor.submit(write)

    def _load_checkpoint(self, path: str) -> None:
        """The training state of a checkpoint: AdamW, the counters, the
        accumulated gradients and the generator (the weights went in at
        construction, before a mesh's placement)."""
        from ..io.checkpoint import load_train_state

        checkpoint_path = _checkpoint_path(path)
        logger.info("Resuming from checkpoint %s", path)
        state = load_train_state(checkpoint_path)
        optim = state["optimizer"]
        optim["state"] = {i: {k: self._piece(i, t) for k, t in entry.items()} for i, entry in optim["state"].items()}
        self.optimizer.load_state_dict(optim)
        self.global_step = int(state["global_step"])
        self.epoch = int(state["epoch"])
        self.updates = int(state["updates"])
        self._micro_steps = int(state["micro_steps"])
        self._accum = None if state["accum"] is None else [self._piece(i, t) for i, t in enumerate(state["accum"])]
        self.generator.set_state(state["generator"])


def _checkpoint_path(path: str) -> Path:
    checkpoint_path = Path(path)
    if not checkpoint_path.exists():
        raise FileNotFoundError(f"Checkpoint path {path} does not exist.")
    return checkpoint_path


def _map_tensors(obj, fn):
    """``fn`` applied to every tensor of nested dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj
