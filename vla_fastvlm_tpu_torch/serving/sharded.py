"""TP / DP-sharded inference (counterpart of
``vla_fastvlm_tpu/serving/sharded.py``).

- ``ShardedPolicyRuntime``: the serving surface of ``FastVLAPolicy``
  (``config``, ``forward(images, states, tasks)``, ``select_action``,
  ``reset``) with the decoder TP-sharded over ``model`` and the batch split
  over ``data``; it plugs into ``ActionQueuePolicy`` and
  ``BatchedEnvRunner`` unchanged.
- ``sharded_generate``: KV-cached generation with the cache split as
  ``cache_shardings`` says: batch over ``data``, KV heads over ``model``,
  so decode reads and writes stay on the rank.

Every rank of the mesh runs the same call (SPMD) with the whole batch and
keeps its ``data`` rows; the vision tower runs whole on them (RepMixer is
not split), the decoder runs its local heads and MLP share with one
all-reduce over ``model`` after each row-split product, and the outputs are
all-gathered over ``data`` so that every rank returns the whole batch, as
JAX replicates its output.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..model.fastvlm_adapter import as_float32
from ..models.fastvlm import FastVLM
from ..parallel.mesh import DATA_AXIS, axis_size
from ..parallel.sharding import cache_shardings, gather_rows, shard_batch, shard_lora_rows, shard_params
from .generate import generate


class ShardedPolicyRuntime:
    """Mesh-sharded FastVLA policy step (TP decoder x DP batch).

    The policy's decoder is placed on the mesh once, in place, at
    construction; every ``forward`` keeps this rank's rows of the batch and
    gathers the actions of all rows.
    """

    def __init__(self, policy, mesh) -> None:
        self.policy = policy
        self.config = policy.config
        self.device = policy.device
        self.mesh = mesh
        self.data_size = axis_size(mesh, DATA_AXIS)
        shard_params(mesh, policy.model.backbone.model)

    @torch.no_grad()
    def forward(self, images, states, tasks: List[str] | str, device=None) -> torch.Tensor:
        """Batch observations -> actions (the whole batch), computed sharded over the mesh."""
        model = self.policy.model
        model.backbone.check_device(device)
        # A batch that ``data`` does not divide raises here, as in JAX.
        arrays = shard_batch(self.mesh, self.policy.prepare_batch({"images": images, "states": states, "tasks": tasks}))
        actions = model.apply_fn(arrays["images"], arrays["input_ids"], arrays["attention_mask"], arrays["states"])
        return gather_rows(actions, self.mesh)

    def select_action(self, image, state, task: str, device=None) -> torch.Tensor:
        action = self.forward(as_float32(image)[None], as_float32(state)[None], task, device=device)
        return action[0]

    def reset(self) -> None:
        return


@torch.no_grad()
def sharded_generate(
    model: FastVLM,
    params,
    images,
    input_ids,
    attention_mask,
    mesh,
    *,
    max_new_tokens: int = 32,
    eos_token_id: int = 2,
    temperature: float = 0.0,
    top_p: float = 1.0,
    rng: Optional[torch.Generator] = None,
    params_are_placed: bool = False,
    lora=None,
) -> torch.Tensor:
    """Mesh-sharded greedy / temperature generation -> (B, max_new_tokens)
    int32 ids of the whole batch on every rank.

    ``model`` carries the weights; ``params`` is None, or a ``state_dict``
    of the unplaced model loaded into it first (the JAX function's
    parameter tree). The model is placed on the mesh unless
    ``params_are_placed`` (placed already, e.g. reused across calls). The
    batch splits over ``data`` (a batch it does not divide raises, as in
    JAX), the cache is this rank's rows and KV heads
    (``cache_shardings``). ``lora``: an adapter tree (``io/lora.py``, single
    or ``lora_with_ids``-mounted multi), replicated; each rank takes its
    columns / rows at use and its rows' adapter ids. ``rng``: the sampling
    ``torch.Generator`` of every rank (the same seed on each).
    """
    if params is not None:
        model.load_state_dict(params)
    if not params_are_placed:
        shard_params(mesh, model)
    arrays = {"input_ids": input_ids, "attention_mask": attention_mask, "images": images}
    local = shard_batch(mesh, {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
                               for k, v in arrays.items() if v is not None})
    tokens = generate(
        model, local.get("images"), local["input_ids"], local["attention_mask"],
        max_new_tokens=max_new_tokens, eos_token_id=eos_token_id, temperature=temperature, top_p=top_p,
        generator=rng, lora=shard_lora_rows(mesh, lora),
    )
    return gather_rows(tokens, mesh)


__all__ = [
    "ShardedPolicyRuntime",
    "sharded_generate",
    "cache_shardings",
]
