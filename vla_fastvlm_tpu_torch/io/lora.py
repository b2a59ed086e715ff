"""LoRA adapters on the Qwen2 decoder (counterpart of
``vla_fastvlm_tpu/io/lora.py``).

The frozen base stays as it is and only rank-r deltas train: 7B fine-tuning
on one card, and multi-tenant serving over one base.

Same conventions as the JAX package:

- An adapter tree is a nested dict that mirrors the module paths of the
  JAX parameter tree, with the decoder's layers stacked on a leading axis
  (the JAX ``nn.scan`` layout): ``{"language_model": {"layers":
  {"self_attn": {"q_proj": {"a": (L, in, r), "b": (L, r, out)}, ...},
  "mlp": {...}}}}`` for a ``FastVLM``. The seven sites are the JAX
  package's (``DEFAULT_LORA_TARGETS``), though the port stores q/k/v as one
  ``qkv_proj`` and gate/up as one ``gate_up_proj``: the decoder adds each
  site's delta after the fused output is split (``models/qwen2.py``). The
  leaves are torch tensors; ``io/bridge.py::jax_lora_to_torch`` and
  ``torch_lora_to_jax`` cross to and from JAX's trees, scanned or not.
- **Pre-scaled**: ``A ~ N(0, (alpha/rank)/sqrt(fan_in))``, ``B = 0``, so the
  forward is ``y + x @ A @ B`` with no runtime scalar, ``merge_lora`` is
  exactly ``W + A @ B``, and at init the adapted model is the base, bit for
  bit. ``alpha`` defaults to ``rank``; adapters are fp32 by default.
- Each site draws from its own ``torch.Generator`` seeded from ``seed`` and
  the crc32 of the site's path, as JAX folds the crc32 into its key. The
  draws themselves differ from JAX's (another generator).
- Multi-LoRA: ``stack_loras`` adds an adapter axis after the layer axis,
  ``(L, N, in, r)``, with an all-zeros adapter at index 0 when
  ``include_base``; ``lora_with_ids`` mounts each batch row's adapter index
  on every site, ``(B,)`` (JAX tiles it to ``(L, B)`` for its scan).
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, FrozenSet, Iterable, Mapping, Optional

import torch

from ..models.qwen2 import LORA_SITE_PARENTS, Qwen2Model, lora_site_fans
from .bridge import flatten_params

# The seven Qwen2 decoder projections.
DEFAULT_LORA_TARGETS: FrozenSet[str] = frozenset(LORA_SITE_PARENTS)


def _is_site(node) -> bool:
    return isinstance(node, Mapping) and "a" in node and "b" in node


def init_lora(model: torch.nn.Module, rank: int, seed: int = 0, alpha: Optional[float] = None,
              targets: Iterable[str] = DEFAULT_LORA_TARGETS, dtype: torch.dtype = torch.float32,
              device=None) -> Dict:
    """An adapter tree for every decoder stack of ``model`` (a ``FastVLM``,
    ``Qwen2ForCausalLM`` or ``Qwen2Model``), on ``device`` (default: the
    model's). ``alpha`` defaults to ``rank`` (unit scale)."""
    if rank <= 0:
        raise ValueError(f"rank must be positive, got {rank}")
    alpha = float(rank) if alpha is None else float(alpha)
    targets = frozenset(targets)
    if device is None:
        device = next(model.parameters()).device
    tree: Dict = {}
    for name_, decoder in model.named_modules():
        if not isinstance(decoder, Qwen2Model):
            continue
        path = tuple(name_.split(".")) if name_ else ()
        n_layers, fans = decoder.cfg.num_hidden_layers, lora_site_fans(decoder.cfg)
        for name in sorted(targets & DEFAULT_LORA_TARGETS):
            fan_in, fan_out = fans[name]
            site_path = path + ("layers", LORA_SITE_PARENTS[name], name)
            gen = torch.Generator().manual_seed((int(seed) << 32) | zlib.crc32("/".join(site_path).encode()))
            std = (alpha / rank) / math.sqrt(fan_in)
            a = torch.randn((n_layers, fan_in, rank), generator=gen, dtype=torch.float32) * std
            node = tree
            for part in site_path[:-1]:
                node = node.setdefault(part, {})
            node[name] = {"a": a.to(device=device, dtype=dtype),
                          "b": torch.zeros((n_layers, rank, fan_out), dtype=dtype, device=device)}
    if not tree:
        raise ValueError(f"no LoRA targets {sorted(targets)} with kernels found in the model")
    return tree


def map_lora(fn, tree: Mapping) -> Dict:
    """A new tree with ``fn`` applied to every leaf."""
    return {k: map_lora(fn, v) if isinstance(v, Mapping) else fn(v) for k, v in tree.items()}


def merge_lora(params: Mapping, lora: Mapping) -> Dict:
    """Fold adapters into a float base in the JAX parameter layout (the
    ``backbone`` tree of ``jax_params(as_numpy=False)`` or of a checkpoint):
    every mounted site's ``kernel`` (L, in, out) becomes ``W + A @ B``, the
    sum taken in fp32 and cast back to the kernel's dtype, on the kernel's
    device. Returns a new tree; refuses a non-float kernel."""
    out = dict(params)
    for key, lchild in lora.items():
        pchild = params[key]
        if _is_site(lchild) and "kernel" in pchild:
            kernel = pchild["kernel"]
            if not (isinstance(kernel, torch.Tensor) and kernel.is_floating_point()):
                raise TypeError(f"cannot merge LoRA into quantized kernel ({kernel.dtype}) at {key!r}; merge "
                                "into the float checkpoint and re-quantize")
            a = lchild["a"].to(device=kernel.device, dtype=torch.float32)
            b = lchild["b"].to(device=kernel.device, dtype=torch.float32)
            merged = dict(pchild)
            merged["kernel"] = (kernel.float() + a @ b).to(kernel.dtype)
            out[key] = merged
        elif isinstance(lchild, Mapping):
            out[key] = merge_lora(pchild, lchild)
    return out


def lora_num_params(lora: Mapping) -> int:
    return int(sum(t.numel() for t in flatten_params(lora).values()))


def load_lora(checkpoint_dir) -> Dict:
    """The trained adapter tree of a policy checkpoint (its ``"lora"``
    sub-tree, written by a policy trained with ``lora_rank > 0``, by this
    package or the JAX one) as CPU tensors in the port's layout."""
    from .bridge import jax_lora_to_torch
    from .checkpoint import load_policy_state

    _, params = load_policy_state(checkpoint_dir)
    if "lora" not in params:
        raise ValueError(f"checkpoint {checkpoint_dir} has no 'lora' adapters (was it trained with lora_rank > 0?)")
    return jax_lora_to_torch(params["lora"])


def stack_loras(adapters, include_base: bool = True) -> Dict:
    """``[lora, ...]`` -> one tree whose sites hold ``(L, N, in, r)`` /
    ``(L, N, r, out)``: the adapter axis after the layer axis, an all-zeros
    adapter (exactly no delta) at index 0 with ``include_base``."""
    adapters = list(adapters)
    if not adapters:
        raise ValueError("stack_loras needs at least one adapter")
    flats = [flatten_params(a) for a in adapters]
    shapes = {k: tuple(v.shape) for k, v in flats[0].items()}
    for flat in flats[1:]:
        if {k: tuple(v.shape) for k, v in flat.items()} != shapes:
            raise ValueError("all adapters must share one structure (same rank/targets on the same base model)")

    def stack(path, node):
        out = {}
        for key, child in node.items():
            name = f"{path}{key}"
            if isinstance(child, Mapping):
                out[key] = stack(name + ".", child)
                continue
            leaves = [f[name] for f in flats]
            if include_base:
                leaves = [torch.zeros_like(leaves[0])] + leaves
            out[key] = torch.stack(leaves, dim=leaves[0].ndim - 2)
        return out

    return stack("", adapters[0])


def lora_with_ids(stacked: Mapping, ids) -> Dict:
    """A ``stack_loras`` tree with each batch row's adapter index, ``ids``
    (B,) int, mounted on every site: the decoder then adds
    ``x[b] @ A[ids[b]] @ B[ids[b]]`` to row ``b``. The stacked tensors are
    shared, not copied."""
    ids = torch.as_tensor(ids)
    if ids.ndim != 1:
        raise ValueError(f"ids must be (B,), got shape {tuple(ids.shape)}")
    leaves = list(flatten_params(stacked).values())
    ids = ids.to(device=leaves[0].device if leaves else None, dtype=torch.int64)

    def walk(node):
        if _is_site(node):
            return {"a": node["a"], "b": node["b"], "ids": ids}
        return {k: walk(v) for k, v in node.items()}

    return walk(stacked)


def lora_parameters(tree: Mapping) -> Dict:
    """The same tree with ``torch.nn.Parameter`` leaves: what a policy trains."""
    return map_lora(lambda t: t if isinstance(t, torch.nn.Parameter) else torch.nn.Parameter(t), tree)


def load_lora_params(current: Optional[Mapping], jax_tree: Mapping, device=None) -> Dict:
    """A JAX adapter tree (a checkpoint's ``"lora"``) -> a policy's adapter
    parameters: copied into ``current`` in place, where an optimizer holds
    them (names and shapes must match), or new parameters on ``device``."""
    from .bridge import jax_lora_to_torch

    new = jax_lora_to_torch(jax_tree)
    if current is None:
        return lora_parameters(map_lora(lambda t: t.to(device), new))
    cur, src = flatten_params(current), flatten_params(new)
    if sorted(cur) != sorted(src):
        raise KeyError(f"adapter sites differ: {sorted(set(cur) ^ set(src))[:4]}")
    with torch.no_grad():
        for name, p in cur.items():
            if p.shape != src[name].shape:
                raise ValueError(f"{name}: shape {tuple(src[name].shape)} != {tuple(p.shape)}")
            p.copy_(src[name])
    return dict(current)
