"""Rank workers for the port's sharded tests (not collected; no JAX).

``RankPool(world, tmp_path)`` starts ``world`` processes once, each a gloo
rank on the CPU joined through a file under ``tmp_path`` (so parallel test
workers never share a port), with one thread each. ``pool.run(name, *args)``
sends the task ``name`` of this module to every rank and returns the ranks'
results in rank order; a failing rank fails the call with its traceback,
and a call that takes longer than ``timeout`` seconds (``TIMEOUT`` unless
the pool was given its own) fails the pool.

The tasks build the port's models on the CPU from JAX-layout numpy
parameters (``io/bridge.py``), place them on a mesh of the first
``data * model`` ranks and return numpy results; ranks outside the mesh
return None.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import traceback

import torch

TIMEOUT = 240.0


def _worker(rank, world, init_file, tasks, results):
    torch.set_num_threads(1)
    from vla_fastvlm_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(f"file://{init_file}", world, rank, device="cpu")
    while True:
        task = tasks.get()
        if task is None:
            break
        name, args, kwargs = task
        try:
            results.put((rank, True, globals()[name](*args, **kwargs)))
        except BaseException:  # noqa: BLE001 - reported to the test
            results.put((rank, False, traceback.format_exc()))
    torch.distributed.destroy_process_group()


class RankPool:
    def __init__(self, world: int, tmp_dir, timeout: float = TIMEOUT) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        init_file = os.path.join(str(tmp_dir), "rendezvous")
        self.procs = [ctx.Process(target=_worker, args=(r, world, init_file, self.tasks[r], self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.broken = False

    def run(self, name: str, *args, **kwargs) -> list:
        if self.broken:
            raise RuntimeError("the rank pool failed in an earlier call")
        for q in self.tasks:
            q.put((name, args, kwargs))
        out = [None] * self.world
        errors = []
        for _ in range(self.world):
            try:
                rank, ok, value = self.results.get(timeout=self.timeout)
            except queue.Empty:
                # a rank failed while the others wait in a collective
                self.broken = True
                self.close()
                raise RuntimeError(f"task {name} timed out; errors: {errors}") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def close(self) -> None:
        for q, p in zip(self.tasks, self.procs):
            if p.is_alive() and not self.broken:
                q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()


# ----------------------------------------------------------------------
# helpers


def _mesh(data, model):
    from vla_fastvlm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data, model, devices=list(range(data * model)))
    return mesh if mesh.get_coordinate() is not None else None


def _np(t):
    if hasattr(t, "to_local"):
        t = t.to_local()
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def vlm(text_kw, jparams=None, quant=None, vlm_kw=None):
    """The port's tiny FastVLM (fp32 on the CPU) with JAX-layout weights."""
    from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch
    from vla_fastvlm_tpu_torch.io.quantize import quantize_params
    from vla_fastvlm_tpu_torch.models import fastvlm as t_vlm
    from vla_fastvlm_tpu_torch.models import qwen2 as t_qwen

    model = t_vlm.FastVLM(t_vlm.fastvlm_tiny(**(vlm_kw or {})).replace(text=t_qwen.qwen2_tiny(**text_kw)))
    if quant:
        quantize_params(model, mode=quant)
    if jparams is not None:
        model.load_state_dict(jax_params_to_torch(jparams), strict=True)
    return model.eval().requires_grad_(False)


def qwen(cfg_kw, jparams, quant=None, causal_lm=False):
    """A port Qwen2 decoder of ``cfg_kw`` (fp32) with JAX-layout weights."""
    from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch
    from vla_fastvlm_tpu_torch.io.quantize import quantize_params
    from vla_fastvlm_tpu_torch.models import qwen2 as t_qwen

    cfg = t_qwen.Qwen2Config(**cfg_kw)
    model = (t_qwen.Qwen2ForCausalLM if causal_lm else t_qwen.Qwen2Model)(cfg)
    if quant:
        quantize_params(model, mode=quant)
    model.load_state_dict(jax_params_to_torch(jparams), strict=True)
    return model.eval().requires_grad_(False)


def policy(cfg_kw, jparams):
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy

    p = FastVLAPolicy(FastVLAConfig(**cfg_kw), device="cpu")
    p.load_jax_params(jparams)
    return p


def _local_state(module):
    from torch.distributed.tensor import DTensor

    return {name: (_np(t), isinstance(t, DTensor)) for name, t in module.state_dict().items()}


# ----------------------------------------------------------------------
# tasks


def t_mesh():
    """The (2, 2) mesh's shape and this rank's coordinate; make_mesh's errors."""
    from vla_fastvlm_tpu_torch.parallel import make_mesh
    from vla_fastvlm_tpu_torch.parallel.mesh import mesh_shape

    mesh = make_mesh(2, 2)
    errors = []
    for kw in (dict(data=3, model=2), dict(model=3), dict(model=0)):
        try:
            make_mesh(**kw)
        except ValueError:
            errors.append("ValueError")
    return {"shape": mesh_shape(mesh), "coord": list(mesh.get_coordinate()), "errors": errors,
            "absorb": mesh_shape(make_mesh(model=2))}


def t_local_state(kind, build_args, data, model, fsdp=False, min_elements=None):
    """Each mesh rank's local pieces of every leaf: ``{part: {name: (array, fsdp_shard)}}``."""
    from vla_fastvlm_tpu_torch.parallel import shard_params

    mesh = _mesh(data, model)
    if mesh is None:
        return None
    if kind == "policy":
        p = policy(*build_args)
        parts = {"backbone": p.model.backbone.model, "head": p.model.head}
    else:
        parts = {"model": qwen(*build_args)}
    out = {}
    for name, module in parts.items():
        shard_params(mesh, module, fsdp=fsdp, fsdp_min_elements=min_elements)
        out[name] = _local_state(module)
    return out


def t_whole_state(kind, build_args, data, model, fsdp=False, min_elements=None):
    """The JAX-layout tree ``torch_params_to_jax`` gathers from a placed model (rank 0's)."""
    from vla_fastvlm_tpu_torch.io.bridge import torch_params_to_jax
    from vla_fastvlm_tpu_torch.parallel import shard_params

    mesh = _mesh(data, model)
    if mesh is None:
        return None
    module = qwen(*build_args) if kind == "qwen" else policy(*build_args).model.backbone.model
    shard_params(mesh, module, fsdp=fsdp, fsdp_min_elements=min_elements)
    return torch_params_to_jax(module)


def t_qwen_logits(build_args, data, model, ids):
    """Prefill logits of a placed ``Qwen2ForCausalLM``."""
    from vla_fastvlm_tpu_torch.parallel import shard_params

    mesh = _mesh(data, model)
    if mesh is None:
        return None
    m = qwen(*build_args)
    shard_params(mesh, m)
    with torch.no_grad():
        out = m(input_ids=torch.as_tensor(ids))
    return _np(out[0])


def t_policy(cfg_kw, jparams, data, model, images, states, tasks, queue_steps=0, select=None):
    """``ShardedPolicyRuntime``: forward, ``ActionQueuePolicy`` steps, ``select_action``."""
    from vla_fastvlm_tpu_torch.serving import ActionQueuePolicy
    from vla_fastvlm_tpu_torch.serving.sharded import ShardedPolicyRuntime

    mesh = _mesh(data, model)
    if mesh is None:
        return None
    runtime = ShardedPolicyRuntime(policy(cfg_kw, jparams), mesh)
    out = {"forward": _np(runtime.forward(images, states, tasks))}
    if queue_steps:
        q = ActionQueuePolicy(runtime, n_action_steps=queue_steps)
        batch = {"images": images, "states": states, "tasks": tasks}
        out["queue"] = [_np(torch.as_tensor(q.select_action(batch))) for _ in range(queue_steps)]
    if select is not None:
        out["select"] = _np(runtime.select_action(*select))
    try:
        runtime.forward(images[:-1], states[:-1], tasks[:-1])
    except ValueError as err:
        out["raise"] = str(err)
    return out


def t_generate(text_kw, jparams, data, model, images, ids, mask, new, lora=None, lora_ids=None, placed=False):
    """``sharded_generate`` tokens (with a JAX-layout adapter tree, multi-LoRA with per-row ids)."""
    from vla_fastvlm_tpu_torch.io.bridge import jax_lora_to_torch
    from vla_fastvlm_tpu_torch.io.lora import lora_with_ids, stack_loras
    from vla_fastvlm_tpu_torch.parallel import shard_params
    from vla_fastvlm_tpu_torch.serving.sharded import sharded_generate

    mesh = _mesh(data, model)
    if mesh is None:
        return None
    m = vlm(text_kw, jparams)
    tree = None
    if lora is not None:
        tree = [jax_lora_to_torch(x) for x in lora] if isinstance(lora, list) else jax_lora_to_torch(lora)
        if lora_ids is not None:
            tree = lora_with_ids(stack_loras(tree), lora_ids)
    if placed:
        shard_params(mesh, m)
    out = sharded_generate(m, None, images, ids, mask, mesh, max_new_tokens=new, eos_token_id=-1,
                           params_are_placed=placed, lora=tree)
    return _np(out)


def _drive(server, reqs, routes):
    pending = list(zip(reqs, routes))
    rids, outputs = [], {}
    while pending or server.num_active:
        while pending and server.has_free_slot():
            req, route = pending.pop(0)
            rids.append(server.submit(*req, lora_index=route))
        outputs.update(server.step())
    return [list(outputs[r]) for r in rids]


def t_server(kind, target, draft, data, model, reqs, routes=None, quant=None, lora=None, kw=None):
    """Greedy tokens of a server over ``reqs`` (``(ids, mask, image)``), by request order.
    ``target`` / ``draft``: ``(text_kw, jparams)``; ``lora``: JAX-layout adapter trees."""
    from vla_fastvlm_tpu_torch.io.bridge import jax_lora_to_torch
    from vla_fastvlm_tpu_torch import serving

    mesh = _mesh(data, model)
    if mesh is None:
        return None
    tm = vlm(*target, quant=quant)
    kw = dict(kw or {})
    if lora is not None:
        kw["lora"] = [jax_lora_to_torch(x) for x in lora] if isinstance(lora, list) else jax_lora_to_torch(lora)
    cls = {"dense": serving.GenerationServer, "paged": serving.PagedGenerationServer,
           "spec": serving.SpeculativeGenerationServer, "spec_paged": serving.SpeculativePagedGenerationServer}[kind]
    if kind.startswith("spec"):
        server = cls(tm, vlm(*draft), mesh=mesh, **kw)
    else:
        server = cls(tm, mesh=mesh, **kw)
    out = {"tokens": _drive(server, reqs, routes or [None] * len(reqs))}
    if kind == "paged":
        out["decode_impl"] = server.decode_impl
        out["pool_heads"] = server.pool.pool_k.shape[2]
    if kind == "dense":
        out["cache_heads"] = server.cache["k"].shape[3]
    return out


def t_train(cfg_kw, jparams, data, model, fsdp, batches, settings, min_elements=None):
    """A ``Trainer`` on the mesh: per batch the loss and gradient norm of
    ``_train_step``; the whole gradients of the first batch (before any
    update, by a separate backward pass); the whole trainable tree after
    the updates (rank 0)."""
    from vla_fastvlm_tpu_torch.io.bridge import torch_params_to_jax
    from vla_fastvlm_tpu_torch.parallel import sharding
    from vla_fastvlm_tpu_torch.training import Trainer, TrainingConfig

    if min_elements is not None:
        sharding.FSDP_MIN_ELEMENTS = min_elements
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    p = policy(cfg_kw, jparams)
    trainer = Trainer(p, batches, None, TrainingConfig(**settings, fsdp=fsdp), mesh=mesh)
    arrays = trainer._place_batch(batches[0])
    loss, _ = p.loss_fn(arrays, train=True, generator=trainer.generator)
    grads = trainer._grads(loss)
    whole = [trainer._whole(i, g) for i, g in enumerate(grads)]
    names = [f"{part}.{name}" for part, sub in trainer.trainable.items() for name in sub]
    out = {"grads": {n: _np(g) for n, g in zip(names, whole)}, "loss": [], "grad_norm": []}
    for batch in batches:
        m = trainer._train_step(trainer._place_batch(batch))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    backbone = torch_params_to_jax(p.model.backbone.model)
    head = torch_params_to_jax(p.model.head)
    out["params"] = {"backbone": backbone, "head": head}
    out["fsdp_shards"] = sum(sharding.is_fsdp_param(q) for q in trainer._params)
    out["moment_shards"] = sum(sharding.is_fsdp_param(v) for s in trainer.optimizer.state.values()
                               for v in s.values())
    return out if torch.distributed.get_rank() == 0 else None


def t_fit_checkpoint(cfg_kw, jparams, data, model, fsdp, batches, out_dir, min_elements=None):
    """``Trainer.fit`` on the mesh saving at the last step (rank 0 writes),
    then a fresh trainer on the mesh resumed from that checkpoint for one
    more step: ``(steps, (resumed step, updates), AdamW's step count)``."""
    from vla_fastvlm_tpu_torch.parallel import sharding
    from vla_fastvlm_tpu_torch.training import Trainer, TrainingConfig

    if min_elements is not None:
        sharding.FSDP_MIN_ELEMENTS = min_elements
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    p = policy(cfg_kw, jparams)
    n = len(batches)
    cfg = TrainingConfig(output_dir=out_dir, max_steps=n, save_steps=n, logging_steps=1, eval_steps=10**6,
                         report_to=[], fsdp=fsdp, prefetch_batches=1, learning_rate=1e-2, warmup_ratio=0.0,
                         mixed_precision=None, async_save=False)
    trainer = Trainer(p, batches, None, cfg, mesh=mesh)
    trainer.fit()
    resumed = Trainer(policy(cfg_kw, jparams), batches, None, dataclasses.replace(
        cfg, max_steps=n + 1, resume_from=f"{out_dir}/checkpoints/step-{n}", output_dir=f"{out_dir}/resumed"),
        mesh=mesh)
    resumed.fit()
    adam_steps = {float(s["step"]) for s in resumed.optimizer.state.values()}
    return trainer.global_step, (resumed.global_step, resumed.updates), sorted(adam_steps)


def _pipe_mesh(stages):
    from vla_fastvlm_tpu_torch.parallel import make_pipe_mesh

    mesh = make_pipe_mesh(stages)
    return mesh if mesh.get_coordinate() is not None else None


def _shared_grads(model):
    return {name: _np(model.get_parameter(name).grad) for name in ("embed_tokens.weight", "norm.weight")}


def t_pipeline(cfg_kw, jparams, stages, n_micro, ids, mask, targets=None, remat=False):
    """``pipeline_forward``'s hidden states on each pipe rank; with
    ``targets``, the MSE loss, the whole gradients gathered on stage 0 and
    each rank's gradients of the replicated leaves."""
    from vla_fastvlm_tpu_torch.parallel import gather_stages, pipeline_forward
    from vla_fastvlm_tpu_torch.parallel.pipeline import mse_loss

    mesh = _pipe_mesh(stages)
    if mesh is None:
        return None
    train = targets is not None
    model = qwen(cfg_kw, jparams).requires_grad_(train)
    with torch.set_grad_enabled(train):
        hidden = pipeline_forward(model, torch.as_tensor(ids), torch.as_tensor(mask), mesh, n_microbatches=n_micro,
                                  remat=remat)
    out = {"hidden": _np(hidden), "blocks": sum(not n.startswith(("embed", "norm")) for n in model.state_dict())}
    if train:
        loss = mse_loss(hidden, torch.as_tensor(targets))
        loss.backward()
        grads = gather_stages(model, mesh, grads=True)
        out.update(loss=float(loss), shared=_shared_grads(model),
                   grads=None if grads is None else {k: _np(v) for k, v in grads.items()})
    state = gather_stages(model, mesh)
    out["state"] = None if state is None else {k: _np(v) for k, v in state.items()}
    return out


def t_pipeline_train(cfg_kw, jparams, stages, n_micro, ids, mask, targets, steps, lr):
    """``make_pipeline_train_step`` with ``torch.optim.Adam``: the loss of
    each step and, after each update, this rank's replicated leaves."""
    from vla_fastvlm_tpu_torch.parallel import make_pipeline_train_step

    mesh = _pipe_mesh(stages)
    if mesh is None:
        return None
    model = qwen(cfg_kw, jparams)
    step, place = make_pipeline_train_step(model, lambda params: torch.optim.Adam(params, lr=lr), mesh,
                                           n_microbatches=n_micro)
    place()
    out = {"loss": [], "shared": []}
    for _ in range(steps):
        out["loss"].append(float(step(torch.as_tensor(ids), torch.as_tensor(mask), torch.as_tensor(targets))))
        out["shared"].append({n: _np(model.get_parameter(n)) for n in ("embed_tokens.weight", "norm.weight")})
    return out


def t_pipeline_guards(cfg_kw, jparams):
    """The ``ValueError`` messages of the pipeline's guards."""
    from vla_fastvlm_tpu_torch.parallel import make_pipe_mesh, pipeline_forward

    ids = torch.ones((4, 8), dtype=torch.int64)
    cases = {
        "layers": lambda: pipeline_forward(qwen(cfg_kw, jparams), ids, None, make_pipe_mesh(3)),
        "micro": lambda: pipeline_forward(qwen(cfg_kw, jparams), ids, None, make_pipe_mesh(2), n_microbatches=3),
        "scan": lambda: pipeline_forward(qwen(dict(cfg_kw, scan_layers=False), jparams), ids, None,
                                         make_pipe_mesh(2)),
        "devices": lambda: make_pipe_mesh(torch.distributed.get_world_size() + 1),
    }
    out = {}
    for name, case in cases.items():
        try:
            case()
        except ValueError as err:
            out[name] = str(err)
    return out
