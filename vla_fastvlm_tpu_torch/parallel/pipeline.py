"""Pipeline parallelism (GPipe) for the Qwen2 decoder stack (counterpart of
``vla_fastvlm_tpu/parallel/pipeline.py``).

The decoder's blocks are split over a 1-D ``pipe`` mesh of ranks, one
process a rank (``parallel/mesh.py``): stage ``p`` keeps blocks
``[p L/P, (p+1) L/P)`` on its device and drops the others
(``place_stages``). Microbatches flow stage to stage by point-to-point send
and receive in the pipe group, in the GPipe schedule of
``n_micro + P - 1`` ticks: at tick ``t`` stage ``p`` works on microbatch
``t - p``. Embeddings, RoPE tables, masks and the final norm run outside
the pipe on every rank, and the last stage's outputs are broadcast so that
every caller sees the whole ``(B, T, H)``, as JAX's masked ``psum`` gives it.

Differences in form from JAX, not in numbers:

- JAX runs the bubble ticks on clamped data to keep its program static;
  here a stage runs only the ticks where ``0 <= t - p < n_micro``, so a rank
  runs its blocks ``n_micro`` times a forward (the flash kernel
  ``L/P x n_micro`` times on the card).
- The module holds its parameters: ``pipeline_forward`` takes the model, and
  ``make_pipeline_train_step`` takes a ``make_optimizer(params)`` that builds
  a ``torch.optim`` optimizer over the rank's placed parameters (JAX's optax
  transform) and returns a stateful ``step``.

The backward is autograd through the schedule. Each tick's shift is an
autograd node whose backward is the reverse shift (the cotangent of what a
stage received goes back to the stage before it), as ``ppermute``
transposes in JAX. The shifts, the shared input and the output broadcast
are chained by an empty token tensor, so every rank runs their backward
passes in the same order (reverse tick order) and each blocking exchange
meets its partner. The broadcast's backward keeps the last stage's own
cotangent, since every rank computes the same loss from the replicated
output (summing the ranks' cotangents would scale the last stage's
gradients by P); the embedding's cotangent exists on stage 0 alone and is
broadcast to every rank, so the replicated leaves (``embed_tokens``,
``norm``) get equal gradients everywhere. Every rank calls ``backward`` on
the same loss, as every device differentiates the same program in JAX.

Transport, chosen by the backend rule of ``parallel/mesh.py``: ``nccl``
sends and receives CUDA tensors in place; ``gloo`` (ranks sharing a card)
has no device path for point-to-point messages, so a CUDA activation goes
through a pinned host copy on each side. Half types travel as their bytes.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.rope import rope_cos_sin
from .mesh import initialize_distributed, local_device

PIPE_AXIS = "pipe"


def make_pipe_mesh(stages: int, devices: Optional[Sequence[int]] = None):
    """1-D ``pipe`` mesh over the first ``stages`` ranks of the default group
    (or of ``devices``). Every rank of the group calls it; ranks outside the
    mesh take no part (``mesh.get_coordinate()`` is None there). Starts a
    one-rank group on the card when none exists."""
    from torch.distributed.device_mesh import DeviceMesh

    initialize_distributed()
    ranks = list(devices if devices is not None else range(dist.get_world_size()))[:stages]
    if len(ranks) != stages:
        raise ValueError(f"need {stages} devices for {stages} pipeline stages")
    return DeviceMesh(local_device().type, torch.tensor(ranks), mesh_dim_names=(PIPE_AXIS,))


def _check_layout(model, mesh) -> tuple:
    """``(stages, this rank's stage, layers a stage)``; JAX's errors."""
    cfg = model.cfg
    if not cfg.scan_layers:
        raise ValueError("pipeline_forward requires scan_layers=True")
    if tuple(getattr(mesh, "mesh_dim_names", None) or ()) != (PIPE_AXIS,):
        raise ValueError(f"mesh must be a 1-D DeviceMesh with dim 'pipe' (make_pipe_mesh), got {mesh!r}")
    stages = mesh.size()
    if cfg.num_hidden_layers % stages:
        raise ValueError(f"{cfg.num_hidden_layers} layers not divisible by {stages} stages")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not on the pipe mesh {mesh!r}")
    return stages, mesh.get_local_rank(PIPE_AXIS), cfg.num_hidden_layers // stages


class _Elsewhere(nn.Module):
    """Stand-in for a decoder block that another pipeline stage holds."""

    def __init__(self, index: int, stage: int):
        super().__init__()
        self.index, self.stage = index, stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"decoder layer {self.index} lives on pipeline stage {self.stage}")

    def extra_repr(self) -> str:
        return f"layer {self.index} on stage {self.stage}"


def place_stages(model, mesh):
    """Keep this rank's stage of ``model.layers`` (a ``Qwen2Model``) on its
    device and drop the other blocks; ``embed_tokens`` and ``norm`` stay on
    every rank. In place, and a no-op on a model already placed on this
    layout (JAX's ``device_put`` onto an identical sharding). Returns
    ``model``."""
    stages, stage, local = _check_layout(model, mesh)
    placed = getattr(model, "pipe_stage", None)
    if placed is not None:
        if placed != (stages, stage):
            raise ValueError(f"model is placed as stage {placed[1]} of {placed[0]}, not {stage} of {stages}")
        return model
    for i in range(model.cfg.num_hidden_layers):
        if i // local != stage:
            model.layers[i] = _Elsewhere(i, i // local)
    model.to(local_device())
    model.pipe_stage = (stages, stage)
    return model


class _Pipe:
    """This rank's view of the pipe group and its transport."""

    def __init__(self, mesh, device: torch.device):
        self.group = mesh.get_group(PIPE_AXIS)
        self.ranks = [int(r) for r in mesh.mesh.tolist()]
        self.stage = mesh.get_local_rank(PIPE_AXIS)
        self.last = len(self.ranks) - 1
        self.device = device
        self.host_staged = device.type == "cuda" and dist.get_backend(self.group) == "gloo"

    def exchange(self, send: Optional[torch.Tensor], to_stage: int, recv: Optional[tuple],
                 from_stage: int) -> Optional[torch.Tensor]:
        """Send ``send`` to ``to_stage`` and receive a tensor of ``recv``'s
        ``(shape, dtype)`` from ``from_stage``, both posted before either is
        waited on; returns what was received, on this rank's device."""
        ops, buf = [], None
        if send is not None:
            wire = send.detach().contiguous()
            if self.host_staged:
                wire = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True).copy_(wire)
            ops.append(dist.P2POp(dist.isend, _wire(wire), self.ranks[to_stage], self.group))
        if recv is not None:
            shape, dtype = recv
            buf = (torch.empty(shape, dtype=dtype, pin_memory=True) if self.host_staged
                   else torch.empty(shape, dtype=dtype, device=self.device))
            ops.append(dist.P2POp(dist.irecv, _wire(buf), self.ranks[from_stage], self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return None if buf is None else buf.to(self.device)

    def broadcast(self, x: torch.Tensor, from_stage: int) -> torch.Tensor:
        """``x`` of ``from_stage`` on every rank of the pipe (in place)."""
        dist.broadcast(_wire(x), self.ranks[from_stage], group=self.group)
        return x


def _wire(x: torch.Tensor) -> torch.Tensor:
    """Half types as their bytes, which every backend moves."""
    return x.view(torch.uint8) if x.dtype in (torch.bfloat16, torch.float16) else x


class _EnterPipe(torch.autograd.Function):
    """The embedded input: identity forward; the backward broadcasts stage
    0's cotangent (the only stage that feeds it to the pipe) to every rank."""

    @staticmethod
    def forward(ctx, x, token, pipe):
        ctx.pipe = pipe
        return x.view_as(x), token.clone()

    @staticmethod
    def backward(ctx, grad, grad_token):
        pipe = ctx.pipe
        grad = grad.contiguous() if pipe.stage == 0 else torch.empty_like(grad)
        return pipe.broadcast(grad, 0), grad_token, None


class _Shift(torch.autograd.Function):
    """One tick's shift: stage p sends ``x`` (or nothing: None) to p + 1 and,
    when ``receive``, takes from p - 1 the activation of ``like``'s
    ``(shape, dtype)`` that it runs next tick. The backward is the reverse
    shift."""

    @staticmethod
    def forward(ctx, x, token, pipe, receive: bool, like: tuple):
        ctx.pipe, ctx.received = pipe, receive
        ctx.sent = None if x is None else (x.shape, x.dtype)
        got = pipe.exchange(x, pipe.stage + 1, like if receive else None, pipe.stage - 1)
        return (got if got is not None else token.new_empty(0, dtype=like[1])), token.clone()

    @staticmethod
    def backward(ctx, grad, grad_token):
        pipe = ctx.pipe
        grad_x = pipe.exchange(grad if ctx.received else None, pipe.stage - 1, ctx.sent, pipe.stage + 1)
        return grad_x, grad_token, None, None, None


class _ExitPipe(torch.autograd.Function):
    """The last stage's outputs (None elsewhere) broadcast to every rank as
    ``like``'s ``(shape, dtype)``; the backward keeps the last stage's own
    cotangent (every rank computes the same loss)."""

    @staticmethod
    def forward(ctx, y, token, pipe, like: tuple):
        ctx.pipe, ctx.last = pipe, pipe.stage == pipe.last
        out = y.view_as(y) if ctx.last else token.new_empty(like[0], dtype=like[1])
        return pipe.broadcast(out, pipe.last)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.last else None), grad.new_zeros(0), None, None


def _run_layers(layers, x, kv_mask, cos, sin):
    for layer in layers:
        x, _ = layer(x, kv_mask, cos, sin, True)
    return x


def pipeline_forward(
    model,
    input_ids: torch.Tensor,  # (B, T)
    attention_mask: Optional[torch.Tensor],  # (B, T), 1 = real token
    mesh,
    n_microbatches: int = 2,
    remat: bool = False,
) -> torch.Tensor:
    """Full-causal decoder forward of a ``Qwen2Model``, its blocks pipelined
    over ``mesh``'s ``pipe`` ranks (placed first, ``place_stages``).

    Returns the post-final-norm hidden states on every rank, the numbers of
    the unpipelined ``model(input_ids=..., attention_mask=...)[0]``.
    ``remat=True`` recomputes each stage-tick's blocks in the backward
    (``torch.utils.checkpoint``), GPipe's activation trade.
    """
    stages, stage, local = _check_layout(model, mesh)
    cfg = model.cfg
    b, t = input_ids.shape
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches} microbatches")
    place_stages(model, mesh)
    dev = model.embed_tokens.weight.device
    input_ids = input_ids.to(dev)
    if attention_mask is None:
        attention_mask = torch.ones((b, t), dtype=torch.int32, device=dev)

    # Replicated pre-stages: embedding and RoPE tables outside the pipe.
    x = model.embed(input_ids).to(cfg.dtype)
    positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta, cfg.dtype)
    kv_mask = attention_mask.to(device=dev, dtype=torch.int32)

    layers = list(model.layers)[stage * local:(stage + 1) * local]
    run = functools.partial(_run_layers, layers)
    if remat:
        # The decoder draws no random numbers: no RNG state to restore.
        run = functools.partial(checkpoint, run, use_reentrant=False, preserve_rng_state=False)

    pipe = _Pipe(mesh, dev) if stages > 1 else None
    if pipe is not None:
        # The token orders the backward passes of the exchanges alike on every rank.
        needs_grad = torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters())
        token = torch.zeros(0, device=dev, requires_grad=needs_grad)
        x, token = _EnterPipe.apply(x, token, pipe)
    x_m, mask_m, cos_m, sin_m = (a.chunk(n_microbatches) for a in (x, kv_mask, cos, sin))
    micro = ((b // n_microbatches,) + tuple(x.shape[1:]), x.dtype)

    outputs, carry = [], None
    n_ticks = n_microbatches + stages - 1
    for tick in range(n_ticks):
        m = tick - stage
        out = None
        if 0 <= m < n_microbatches:
            out = run(x_m[m] if stage == 0 else carry, mask_m[m], cos_m[m], sin_m[m])
            if stage == stages - 1:
                outputs.append(out)
        if pipe is not None and tick < n_ticks - 1:
            # Stage p receives what stage p - 1 ran this tick: its microbatch of the next tick.
            receive = stage > 0 and 0 <= tick + 1 - stage < n_microbatches
            carry, token = _Shift.apply(out if stage < stages - 1 else None, token, pipe, receive, micro)
    y = torch.cat(outputs) if stage == stages - 1 else None
    if pipe is not None:
        y = _ExitPipe.apply(y, token, pipe, (tuple(x.shape), x.dtype))
    return model.norm(y)


def mse_loss(hidden: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """JAX's default pipeline loss: the mean squared error of the hidden states."""
    return torch.mean(torch.square(hidden - targets.to(hidden.dtype)))


def make_pipeline_train_step(
    model,
    make_optimizer: Callable,
    mesh,
    n_microbatches: int = 2,
    loss_fn: Optional[Callable] = None,
    remat: bool = True,
):
    """GPipe training step of a ``Qwen2Model``: ``(step, place)``.

    ``place()`` puts the model's stages on the pipe mesh (``place_stages``)
    and returns the model. ``step(input_ids, attention_mask, targets)``
    places it if needed, builds the optimizer on its first call from
    ``make_optimizer(params)`` over the rank's placed parameters (every one
    trained, as JAX differentiates the whole tree), runs the pipelined
    forward, ``loss_fn(hidden, targets)`` (default: MSE of the hidden
    states), ``backward`` and the update, and returns the loss. Gradients
    are stage-local for the blocks and equal on every rank for
    ``embed_tokens`` and ``norm``, so those stay equal across ranks.
    """
    loss_fn = loss_fn or mse_loss
    state: Dict[str, torch.optim.Optimizer] = {}

    def place():
        return place_stages(model, mesh)

    def step(input_ids, attention_mask, targets):
        place()
        if "optimizer" not in state:
            params = list(model.parameters())
            for p in params:
                p.requires_grad_(True)
            state["optimizer"] = make_optimizer(params)
        optimizer = state["optimizer"]
        optimizer.zero_grad(set_to_none=True)
        hidden = pipeline_forward(model, input_ids, attention_mask, mesh, n_microbatches=n_microbatches,
                                  remat=remat)
        loss = loss_fn(hidden, targets.to(hidden.device))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step, place


def gather_stages(model, mesh, grads: bool = False) -> Optional[Dict[str, torch.Tensor]]:
    """A placed model's whole ``state_dict`` (or, with ``grads``, the
    gradients of its parameters, zeros where none) by layer index, as CPU
    tensors on stage 0; None on the other stages. Every stage calls it."""
    stages, stage, local = _check_layout(model, mesh)
    place_stages(model, mesh)

    def tensors(module):
        if not grads:
            return dict(module.state_dict())
        return {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in module.named_parameters()}

    pipe = _Pipe(mesh, local_device())
    layers = {i: model.layers[i] for i in range(stage * local, (stage + 1) * local)}
    template = tensors(model.layers[0]) if stage == 0 else None
    out = None
    if stage == 0:
        out = {n: v.detach().cpu() for n, v in tensors(model).items() if not n.startswith("layers.")}
        for i, layer in layers.items():
            out.update({f"layers.{i}.{n}": v.detach().cpu() for n, v in tensors(layer).items()})
    for src in range(1, stages):
        for i in range(src * local, (src + 1) * local):
            names = list(tensors(layers[i]).items()) if stage == src else list(template.items()) if stage == 0 else []
            for name, value in names:
                if stage == src:
                    pipe.exchange(value, 0, None, 0)
                else:
                    out[f"layers.{i}.{name}"] = pipe.exchange(None, 0, (value.shape, value.dtype), src).cpu()
    return out
