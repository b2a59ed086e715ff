"""Device mesh and process-group start (counterpart of
``vla_fastvlm_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` with ``data`` x ``model``
axes and lets GSPMD insert the collectives. The port runs one process a
rank (SPMD): the mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with ``mesh_dim_names=("data", "model")`` over the ranks of the default
process group, and the modules call the collectives of their axis groups
themselves (``parallel/sharding.py``).

- ``data``: batch-dimension parallelism (the reference's DP).
- ``model``: tensor parallelism of the Qwen2 decoder.

Ranks are laid out as JAX lays out devices (``np.array(devices).reshape(data,
model)``): rank ``r`` sits at ``(r // model, r % model)``, so port rank ``r``
holds what JAX device ``r`` holds.

Backend and device, fixed by the layout: rank ``r`` uses
``cuda:(r % torch.cuda.device_count())``; the backend is ``nccl`` when every
rank of the host has a card of its own, and ``gloo`` when ranks share a card
or the caller asked for ``device="cpu"``. Nothing falls back to another
backend or to the CPU at run time.

``spawn_ranks`` starts a command's own ranks when it is not run under
``torchrun`` (the CLIs' ``--dp`` / ``--tp``), so one command works as the
JAX script does.
"""

from __future__ import annotations

import logging
import os
import pickle
import tempfile
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"

# The device of this process's rank, set by ``initialize_distributed``.
_DEVICE: Optional[torch.device] = None


def rank_device(rank: int, device: Optional[str] = None) -> torch.device:
    """The device of ``rank``: the CPU when asked for, else
    ``cuda:(rank % device_count)``; raises without CUDA."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(device: torch.device, ranks_on_host: int) -> str:
    """``nccl`` when each of the host's ranks has a card of its own, else ``gloo``."""
    if device.type == "cpu":
        return "gloo"
    return "nccl" if ranks_on_host <= torch.cuda.device_count() else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[str] = None,
) -> torch.device:
    """Start the default process group (the reference's accelerate-launch
    role) and return this rank's device.

    A no-op, returning the rank's device, when a group already exists. With
    no arguments it reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_WORLD_SIZE``),
    and without one it starts a group of one rank. ``coordinator_address``
    is ``host:port`` (TCP) or an ``init_method`` URL (``tcp://``,
    ``file://``). ``device="cpu"`` puts the ranks on the CPU (gloo).
    """
    global _DEVICE
    if dist.is_initialized():
        if _DEVICE is None:
            _DEVICE = rank_device(dist.get_rank(), device)
        return _DEVICE
    env = os.environ
    if coordinator_address is None and "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        rank = int(env["RANK"])
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        init_method = "env://"
    else:
        world = int(num_processes or 1)
        rank = int(process_id or 0)
        local_world = world
        init_method = coordinator_address
        if init_method is not None and "://" not in init_method:
            init_method = f"tcp://{init_method}"
    local_rank = int(env.get("LOCAL_RANK", rank % local_world))
    dev = rank_device(local_rank, device)
    backend = backend_for(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = dict(backend=backend, rank=rank, world_size=world)
    if dev.type == "cuda" and backend == "nccl":
        kwargs["device_id"] = dev
    if init_method is None:
        if world != 1:
            raise ValueError(f"{world} processes need a coordinator_address")
        dist.init_process_group(store=dist.HashStore(), **kwargs)
    else:
        dist.init_process_group(init_method=init_method, **kwargs)
    _DEVICE = dev
    logger.info("rank %d of %d on %s (%s)", rank, world, dev, backend)
    return dev


def local_device() -> torch.device:
    """This rank's device (``initialize_distributed`` must have run)."""
    if _DEVICE is None:
        raise RuntimeError("no process group: call initialize_distributed() first")
    return _DEVICE


def make_mesh(data: int = -1, model: int = 1, devices: Optional[Sequence[int]] = None):
    """Build a ("data", "model") mesh over the ranks (``devices``: the ranks
    to use, all of the default group by default).

    ``data=-1`` absorbs every rank not taken by ``model``. Rank
    ``devices[d * model + m]`` sits at ``(d, m)``, JAX's reshape, so the
    ``model`` axis, which carries the TP collectives, takes neighbouring
    ranks. Starts a one-rank group on the card when none exists.
    """
    from torch.distributed.device_mesh import DeviceMesh

    initialize_distributed()
    ranks = list(devices if devices is not None else range(dist.get_world_size()))
    n = len(ranks)
    if model <= 0:
        raise ValueError(f"model axis size must be positive, got {model}")
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model={model}")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"data*model = {data * model} != {n} devices")
    layout = torch.tensor(np.array(ranks).reshape(data, model))
    return DeviceMesh(local_device().type, layout, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def single_device_mesh(device: Optional[int] = None):
    """A (1, 1) mesh over one rank (this one by default)."""
    initialize_distributed()
    return make_mesh(1, 1, devices=[dist.get_rank() if device is None else int(device)])


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a ("data", "model") ``DeviceMesh``."""
    if tuple(getattr(mesh, "mesh_dim_names", None) or ()) != (DATA_AXIS, MODEL_AXIS):
        raise ValueError(f"mesh must be a DeviceMesh with dims ('data', 'model') (make_mesh), got {mesh!r}")


def mesh_shape(mesh) -> dict:
    """``{"data": d, "model": m}``, as ``jax.sharding.Mesh.shape``; a mapping
    of axis sizes stands for a mesh where only the sizes matter (the spec
    functions)."""
    if isinstance(mesh, dict):
        return {DATA_AXIS: 1, MODEL_AXIS: 1, **mesh}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else int(mesh_shape(mesh)[axis])


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank's ``axis`` (None on a size-1 axis)."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def _rank_entry(rank: int, fn: Callable, world: int, tmp: str, device: Optional[str], args: tuple) -> None:
    initialize_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", world, rank, device=device)
    try:
        result = fn(*args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, nprocs: int, *args, device: Optional[str] = None) -> Any:
    """Run ``fn(*args)`` in ``nprocs`` new processes, one rank each, joined
    through a file under a temporary directory; return rank 0's result.

    Each rank starts its group (``initialize_distributed``) before it calls
    ``fn`` and ends it after. A rank that fails fails the call. ``fn`` must
    be importable by name (the processes start fresh, ``spawn``).
    """
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_entry, args=(fn, nprocs, tmp, device, args), nprocs=nprocs, join=True,
                           start_method="spawn")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


def needs_own_ranks(world: int) -> bool:
    """Whether a command asked for ``world`` > 1 ranks must start them: no
    group exists and it was not launched by ``torchrun``."""
    return world > 1 and not dist.is_initialized() and "WORLD_SIZE" not in os.environ


def is_main_rank() -> bool:
    """Rank 0 of the group, or a process without one: the rank that prints and writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def cli_mesh(data: int, model: int, device: Optional[str]):
    """``(mesh, device)`` of a command's ``--dp`` / ``--tp``: no mesh and
    ``device`` resolved for one rank; else this rank's device (joining the
    ``torchrun`` group, or the one ``spawn_ranks`` started) and the
    ``(data, model)`` mesh over all ranks."""
    from ..device import resolve_device

    launched = dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1
    if max(data, 1) * model <= 1 and not launched:
        return None, resolve_device(device)
    dev = initialize_distributed(device=device)
    return make_mesh(data, model), dev
