"""Sharding rules and their placement on the ranks (counterpart of
``vla_fastvlm_tpu/parallel/sharding.py``).

The spec functions are JAX's, as pure functions of JAX-style path names,
shapes and mesh sizes; a spec is a tuple of axis names (``None`` for an
unsharded dim), right-aligned to the leaf's rank, where JAX returns a
``PartitionSpec``: ``spec_for_param`` (with ``_TP_RULES``),
``fsdp_spec_for_param`` (``FSDP_MIN_ELEMENTS``), ``param_shardings``,
``fsdp_param_shardings``, ``batch_spec``, ``batch_shardings`` and
``cache_shardings``.

``shard_params``, ``shard_batch`` and ``shard_cache`` turn those specs into
each rank's local tensors. Where GSPMD inserts the collectives in JAX, the
port's modules call them (Megatron-style TP over the ``model`` group):

- q/k/v (the fused ``qkv_proj``) and gate/up (``gate_up_proj``) split by
  output, each part on its own: a rank holds its slice of q, of k and of v;
  ``Qwen2Attention`` then runs its local heads (whole heads only: the KV
  head count must divide by the ``model`` size, where JAX pads).
- o_proj and down split by input; their partial products are summed by one
  all-reduce over ``model`` after each (``reduce_from_model``).
- An untied ``lm_head`` splits by vocabulary; its logits are all-gathered.
- Quantized leaves follow JAX's shape rule: int8 scales of row-split
  kernels replicate; int4 group scales of row-split kernels split when the
  group count divides the ``model`` size, and otherwise replicate while the
  rank's product indexes the groups by global input position
  (``QuantDense.k_offset``). Packed int4 codes ``uint8 (N, K/2)`` split
  ``K/2`` on a row-split kernel.
- LoRA adapters stay replicated; each rank slices B's output columns at a
  column site (q, k and v each on their own) and A's rows at a row site,
  where the delta joins the partial sum before the all-reduce.

The autograd rules of the collectives make replicated leaves get whole,
equal gradients on every rank: ``copy_to_model`` (identity, all-reduce in
the backward pass) guards the input of column-split products,
``reduce_from_model`` (all-reduce, identity backward) ends row-split ones.

FSDP (``fsdp=True``) is ``torch.distributed.fsdp.fully_shard`` over the
``data`` sub-mesh: each parameter takes the ``Shard(dim)`` that
``fsdp_spec_for_param`` picks from JAX's (scan-stacked) shape, and leaves
under ``FSDP_MIN_ELEMENTS`` stay whole (``ignored_params``), their
gradients averaged over ``data`` by the trainer.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_rank, axis_size, check_mesh, local_device


def P(*axes) -> tuple:
    """A partition spec: one axis name (or None) per trailing dim."""
    return tuple(axes)


# (path-suffix, spec on the trailing dims), JAX's table; specs are
# right-aligned against the JAX leaf's rank (scan-stacked leaves carry a
# leading layer axis that stays unsharded).
_TP_RULES: tuple = (
    (("self_attn", "q_proj", "kernel"), P(None, MODEL_AXIS)),
    (("self_attn", "q_proj", "bias"), P(MODEL_AXIS)),
    (("self_attn", "k_proj", "kernel"), P(None, MODEL_AXIS)),
    (("self_attn", "k_proj", "bias"), P(MODEL_AXIS)),
    (("self_attn", "v_proj", "kernel"), P(None, MODEL_AXIS)),
    (("self_attn", "v_proj", "bias"), P(MODEL_AXIS)),
    (("self_attn", "o_proj", "kernel"), P(MODEL_AXIS, None)),
    (("mlp", "gate_proj", "kernel"), P(None, MODEL_AXIS)),
    (("mlp", "up_proj", "kernel"), P(None, MODEL_AXIS)),
    (("mlp", "down_proj", "kernel"), P(MODEL_AXIS, None)),
    (("lm_head", "kernel"), P(None, MODEL_AXIS)),
    # Weight-only int8 scales (1, N) follow their kernel's output split;
    # row-split kernels' per-output scales replicate (the default rule).
    (("self_attn", "q_proj", "scale"), P(None, MODEL_AXIS)),
    (("self_attn", "k_proj", "scale"), P(None, MODEL_AXIS)),
    (("self_attn", "v_proj", "scale"), P(None, MODEL_AXIS)),
    (("mlp", "gate_proj", "scale"), P(None, MODEL_AXIS)),
    (("mlp", "up_proj", "scale"), P(None, MODEL_AXIS)),
    (("lm_head", "scale"), P(None, MODEL_AXIS)),
)


def spec_for_param(path_names: tuple, ndim: int, shape: tuple = (), model_size: Optional[int] = None) -> tuple:
    """Spec of one JAX parameter, right-aligned to its rank.

    ``shape`` decides the one shape-dependent case, the ``scale`` of the
    row-split kernels (o_proj / down_proj): int8 scales ``(..., 1, N)``
    replicate; int4 group scales ``(..., K/G, N)`` split their group axis
    over ``model`` when it divides ``model_size`` (None: always), and
    replicate otherwise (0.5B's K = 896 has 7 groups).
    """
    path_names = tuple(path_names)
    if (path_names[-1:] == ("scale",) and path_names[-2:-1] in (("o_proj",), ("down_proj",))
            and len(shape) >= 2 and shape[-2] > 1):
        pad = ndim - 2
        if pad >= 0 and (model_size is None or shape[-2] % model_size == 0):
            return P(*([None] * pad + [MODEL_AXIS, None]))
        if pad >= 0:
            return P()
    for suffix, spec in _TP_RULES:
        if path_names[-len(suffix):] == suffix:
            pad = ndim - len(spec)
            if pad < 0:
                return P()
            return P(*([None] * pad + list(spec)))
    return P()  # replicate


def _map_tree(fn, tree: Mapping, prefix: tuple = ()) -> Dict:
    return {key: _map_tree(fn, value, prefix + (str(key),)) if isinstance(value, Mapping)
            else fn(prefix + (str(key),), value) for key, value in tree.items()}


def param_shardings(mesh, params: Mapping) -> Dict:
    """Tree of specs matching a JAX-layout parameter tree (leaves with
    ``.shape``: numpy arrays, tensors, meta tensors)."""
    model_size = axis_size(mesh, MODEL_AXIS)
    return _map_tree(lambda names, leaf: spec_for_param(names, len(leaf.shape), tuple(leaf.shape), model_size),
                     params)


# FSDP (ZeRO-3-style): leaves below this element count stay replicated.
FSDP_MIN_ELEMENTS = 2**16


def fsdp_spec_for_param(spec: tuple, shape: tuple, data_size: int, min_elements: Optional[int] = None) -> tuple:
    """Extend a parameter's TP spec with a ``data`` shard (FSDP): the
    *largest* dim the TP rules left unsharded that divides the data size.
    The leading (scan-stacked layer) axis of rank >= 3 leaves is never
    sharded."""
    if min_elements is None:
        min_elements = FSDP_MIN_ELEMENTS
    size = 1
    for d in shape:
        size *= int(d)
    if data_size <= 1 or size < min_elements:
        return spec
    ndim = len(shape)
    entries = [None] * (ndim - len(spec)) + list(spec)
    start = 1 if ndim >= 3 else 0
    best = None
    for i in range(start, ndim):
        if entries[i] is not None or shape[i] % data_size != 0:
            continue
        if best is None or shape[i] > shape[best]:
            best = i
    if best is None:
        return spec
    entries[best] = DATA_AXIS
    return P(*entries)


def fsdp_param_shardings(mesh, params: Mapping, min_elements: Optional[int] = None) -> Dict:
    """Tree of specs: the TP rules plus the ``data``-axis FSDP extension."""
    model_size, data_size = axis_size(mesh, MODEL_AXIS), axis_size(mesh, DATA_AXIS)

    def one(names, leaf):
        shape = tuple(leaf.shape)
        spec = spec_for_param(names, len(shape), shape, model_size)
        return fsdp_spec_for_param(spec, shape, data_size, min_elements)

    return _map_tree(one, params)


def batch_spec() -> tuple:
    """Batch arrays: leading dim over ``data``."""
    return P(DATA_AXIS)


def batch_shardings(mesh, arrays: Mapping[str, Any]) -> Dict[str, tuple]:
    return {key: P(DATA_AXIS) if getattr(v, "ndim", 0) > 0 else P() for key, v in arrays.items()}


_CACHE_SPECS = {
    "k": P(None, DATA_AXIS, None, MODEL_AXIS, None),
    "v": P(None, DATA_AXIS, None, MODEL_AXIS, None),
    # int8-cache scales (L, B, S, K) follow their buffer's batch / head split.
    "k_scale": P(None, DATA_AXIS, None, MODEL_AXIS),
    "v_scale": P(None, DATA_AXIS, None, MODEL_AXIS),
    "mask": P(DATA_AXIS, None),
    "index": P(DATA_AXIS),
}
def cache_shardings(mesh, cache: Mapping[str, Any]) -> Dict[str, tuple]:
    """Specs of a dense KV cache (``models/qwen2.py::init_kv_cache``): K/V
    (L, B, S, K, D) batch over ``data`` and KV heads over ``model``, so a
    rank keeps the rows and heads it computes; mask and cursor follow the
    batch."""
    return {key: _CACHE_SPECS[key] for key in cache}


# ----------------------------------------------------------------------
# local pieces


def local_slice(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's piece of a whole tensor under ``spec`` (a contiguous
    copy); as a ``PartitionSpec``, the spec names the leading dims."""
    entries = list(spec) + [None] * (t.ndim - len(spec))
    for dim, axis in enumerate(entries):
        if axis is None:
            continue
        n = axis_size(mesh, axis)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} not divisible by {axis} size {n}")
        t = t.chunk(n, dim=dim)[axis_rank(mesh, axis)]
    return t.contiguous()


def _to_local(value, device) -> torch.Tensor:
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return value.to(device)


def shard_batch(mesh, arrays: Mapping[str, Any]) -> Dict[str, Any]:
    """This rank's rows of each batch array (leading dim over ``data``), on
    the rank's device; 0-d arrays and non-arrays pass whole. A leading dim
    that ``data`` does not divide raises, as JAX's placement does."""
    dev = local_device()
    out = {}
    for key, value in arrays.items():
        if not isinstance(value, (np.ndarray, torch.Tensor)):
            out[key] = value
            continue
        spec = P(DATA_AXIS) if value.ndim > 0 else P()
        if value.ndim > 0 and value.shape[0] % axis_size(mesh, DATA_AXIS):
            raise ValueError(f"batch {value.shape[0]} not divisible by data-parallel size "
                             f"{axis_size(mesh, DATA_AXIS)}")
        out[key] = local_slice(_to_local(value, dev), spec, mesh)
    return out


def shard_cache(mesh, cache: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's piece of a dense KV cache (``cache_shardings``)."""
    dev = local_device()
    specs = cache_shardings(mesh, cache)
    return {key: local_slice(_to_local(value, dev), specs[key], mesh) for key, value in cache.items()}


def tp_text_config(cfg, tp: int):
    """The decoder config of one rank's heads and MLP width at TP ``tp``:
    what sizes its caches and pools. Raises where heads would split."""
    if tp == 1:
        return cfg
    for name in ("num_attention_heads", "num_key_value_heads", "intermediate_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"{name} = {getattr(cfg, name)} does not split over model = {tp}: the port's "
                             "rank-local kernels need whole heads")
    return cfg.replace(num_attention_heads=cfg.num_attention_heads // tp,
                       num_key_value_heads=cfg.num_key_value_heads // tp,
                       intermediate_size=cfg.intermediate_size // tp, head_dim=cfg.resolved_head_dim)


def rank_text_config(model: torch.nn.Module):
    """The decoder config that sizes ``model``'s caches and pools on this
    rank: the config's own, or its TP share once ``shard_params`` placed
    the model (read from its attention modules)."""
    cfg = model.cfg.text if hasattr(model.cfg, "text") else model.cfg
    for m in model.modules():
        if hasattr(m, "num_kv_heads"):
            return tp_text_config(cfg, cfg.num_key_value_heads // m.num_kv_heads)
    return cfg


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every ``data`` rank's rows of ``x``, concatenated (the whole batch)."""
    group = axis_group(mesh, DATA_AXIS)
    return x if group is None else all_gather_cat(x, 0, group)


def shard_lora_rows(mesh, lora):
    """A multi-LoRA tree with this rank's ``data`` rows of its per-row
    adapter ids (``lora_with_ids``); other trees unchanged."""
    if lora is None or axis_size(mesh, DATA_AXIS) == 1:
        return lora
    return {key: (local_slice(value, P(DATA_AXIS), mesh) if key == "ids" else
                  shard_lora_rows(mesh, value) if isinstance(value, Mapping) else value)
            for key, value in lora.items()}


# ----------------------------------------------------------------------
# collectives of the model axis, with their autograd rules


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` (half types travel as
    their bytes, which every backend gathers)."""
    n = dist.get_world_size(group)
    send = x.contiguous()
    wire = send.view(torch.uint8) if send.dtype in (torch.bfloat16, torch.float16) else send
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    if wire is not send:
        parts = [p.view(send.dtype) for p in parts]
    return torch.cat(parts, dim=dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of every rank's ``x``, reduced in fp32 for half types."""
    y = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        return grad.chunk(n, dim=ctx.dim)[dist.get_rank(ctx.group)].contiguous(), None, None


class _SliceToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad, ctx.dim, ctx.group), None, None


def copy_to_model(x, group):
    """Identity forward; the backward pass sums the gradient over ``model``
    (a replicated input of rank-partial work)."""
    return x if group is None or x is None else _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """Sum of the ranks' partial results over ``model`` (identity backward)."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x, group, dim: int = -1):
    """Concatenation of the ranks' pieces along ``dim``."""
    return x if group is None else _GatherFromModel.apply(x, dim % x.ndim, group)


def slice_to_model(x, group, dim: int = -1):
    """This rank's piece of a replicated ``x`` along ``dim``; the backward
    pass gathers the pieces' gradients into the whole."""
    return x if group is None or x is None else _SliceToModel.apply(x, dim % x.ndim, group)


def tp_lora_site(site, kind: str, group):
    """A LoRA site ``(A, B)`` as one rank uses it: at a column site the
    rank's columns of B (A whole), at a row site its rows of A (B whole)."""
    if site is None or group is None:
        return site
    a, b = site
    if kind == "col":
        return copy_to_model(a, group), slice_to_model(b, group, -1)
    return slice_to_model(a, group, -2), copy_to_model(b, group)


# ----------------------------------------------------------------------
# TP placement of the port's modules

# Fused projection -> its JAX parts, in order.
_PARTS = {"qkv_proj": ("q_proj", "k_proj", "v_proj"), "gate_up_proj": ("gate_proj", "up_proj")}


def _jax_leaf(leaf: str, kind: str, n: int, k: int, t: torch.Tensor):
    """(JAX leaf name, JAX shape of one part of ``n`` outputs) of a port leaf."""
    if leaf in ("weight", "qweight"):
        return "kernel", (k, n)
    if leaf == "bias":
        return "bias", (n,)
    return "scale", ((1, n) if kind == "int8" else (t.shape[-2], n))


def _port_dim(leaf: str, kind: str, spec: tuple, jax_ndim: int) -> Optional[int]:
    """The port dim that carries ``model`` under a JAX spec, or None."""
    entries = [None] * (jax_ndim - len(spec)) + list(spec)
    if MODEL_AXIS not in entries:
        return None
    i = entries.index(MODEL_AXIS)
    if leaf in ("weight", "qweight"):
        return 0 if i == 1 else 1  # (K, N) -> (N, K)
    if leaf == "scale" and kind == "int8":
        return 0  # (1, N) -> (N,)
    return i


def tp_pieces(t: torch.Tensor, dim: int, sizes, n: int, r: int) -> torch.Tensor:
    """Rank ``r`` of ``n``: each part's chunk along ``dim``, concatenated."""
    parts = t.split(list(sizes), dim=dim) if sizes else (t,)
    for p in parts:
        if p.shape[dim] % n:
            raise ValueError(f"a part of {p.shape[dim]} along dim {dim} does not split over model = {n}")
    return torch.cat([p.chunk(n, dim=dim)[r] for p in parts], dim=dim).contiguous()


def _shard_dense(dense, names: tuple, parts: tuple, sizes, tp: int, rank: int, group) -> None:
    """Replace ``dense``'s leaves by rank ``rank``'s pieces under JAX's rules
    for ``names + (part,)``; records each split in ``dense.tp_layout``."""
    kind = "float" if not hasattr(dense, "qweight") else dense.mode
    k_in = dense.in_features
    layout = {}
    for leaf in ("weight", "qweight", "bias", "scale"):
        t = getattr(dense, leaf, None)
        if t is None:
            continue
        jleaf, jshape = _jax_leaf(leaf, kind, (sizes[0] if sizes else dense.out_features), k_in, t)
        spec = spec_for_param(names + (parts[0], jleaf), len(jshape), jshape, model_size=tp)
        dim = _port_dim(leaf, kind, spec, len(jshape))
        if dim is None:
            if leaf == "scale" and kind == "int4" and jshape[0] > 1 and parts[0] in ("o_proj", "down_proj"):
                dense.k_offset = rank * (k_in // tp)  # whole group scales, rank-local codes
            continue
        out_dim = {"weight": 0, "qweight": 0, "bias": 0}.get(leaf, 0 if kind == "int8" else 1)
        split_sizes = sizes if dim == out_dim else None
        piece = tp_pieces(t.detach(), dim, split_sizes, tp, rank)
        if isinstance(t, torch.nn.Parameter):
            t.data = piece
        else:
            setattr(dense, leaf, piece)
        layout[leaf] = (dim, split_sizes)
    dense.tp_layout = layout
    dense.tp_group = group


def _shard_tp(module: torch.nn.Module, tp: int, rank: int, group) -> None:
    from ..models.qwen2 import Qwen2Attention, Qwen2MLP

    for name, m in list(module.named_modules()):
        if getattr(m, "tp_group", None) is not None:
            continue  # placed already
        path = tuple(name.split(".")) if name else ()
        if isinstance(m, Qwen2Attention):
            n, kh, d = m.num_heads, m.num_kv_heads, m.cfg.resolved_head_dim
            if n % tp or kh % tp:
                raise ValueError(f"{kh} KV heads / {n} query heads do not split over model = {tp}: the port's "
                                 "rank-local kernels need whole heads")
            _shard_dense(m.qkv_proj, path, _PARTS["qkv_proj"], (n * d, kh * d, kh * d), tp, rank, group)
            _shard_dense(m.o_proj, path, ("o_proj",), None, tp, rank, group)
            m.num_heads, m.num_kv_heads = n // tp, kh // tp
            m.tp_group = group
        elif isinstance(m, Qwen2MLP):
            i = m.cfg.intermediate_size
            _shard_dense(m.gate_up_proj, path, _PARTS["gate_up_proj"], (i, i), tp, rank, group)
            _shard_dense(m.down_proj, path, ("down_proj",), None, tp, rank, group)
            m.tp_group = group
        elif path[-1:] == ("lm_head",) and hasattr(m, "out_features"):
            _shard_dense(m, path[:-1], ("lm_head",), None, tp, rank, group)


# ----------------------------------------------------------------------
# FSDP placement

# Modules that read their children's parameters directly (the RepMixer
# kernel takes the block's weights): each is one FSDP unit.
_UNIT_CLASSES = ("Qwen2Block", "RepMixerBlock", "AttentionBlock")


def _jax_names_and_shape(module: torch.nn.Module, name: str, p: torch.Tensor, layers: Dict[str, int], tp: int):
    """JAX path names, whole scan-stacked JAX shape and JAX-dim -> port-dim
    map of a (TP-local) port parameter (a fused one as its first part)."""
    owner, _, leaf = name.rpartition(".")
    parts = owner.split(".") if owner else []
    m = module.get_submodule(owner) if owner else module
    fused = _PARTS.get(parts[-1]) if parts else None
    shape = tuple(p.shape)
    perm = tuple(range(p.ndim))
    if fused:
        parent = module.get_submodule(".".join(parts[:-1]))
        parts = parts[:-1] + [fused[0]]
        first = (parent.num_heads * parent.cfg.resolved_head_dim if fused[0] == "q_proj"
                 else shape[0] // 2) if leaf != "bias" else None
    if leaf == "weight" and p.ndim == 2 and hasattr(m, "in_features"):
        jleaf, jshape, perm = "kernel", (shape[1], first if fused else shape[0]), (1, 0)
    elif leaf == "weight" and p.ndim == 4:
        jleaf, jshape, perm = "kernel", (shape[2], shape[3], shape[1], shape[0]), (2, 3, 1, 0)  # HWIO
    else:
        jleaf, jshape = leaf, shape
    split = (getattr(m, "tp_layout", None) or {}).get(leaf)
    if split is not None:  # the whole JAX leaf, as the FSDP rule sizes it
        jdim = perm.index(split[0])
        jshape = tuple(d * tp if i == jdim else d for i, d in enumerate(jshape))
    for i, part in enumerate(parts):
        if part == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
            stack = layers.get(".".join(parts[:i + 1]))
            parts = parts[:i + 1] + parts[i + 2:]
            if stack:
                jshape = (stack,) + jshape
            break
    return tuple(parts) + (jleaf,), jshape, perm


def _fsdp_dim(jspec: tuple, jshape: tuple, perm: tuple) -> Optional[int]:
    """The port dim that carries ``data`` under a JAX FSDP spec."""
    entries = [None] * (len(jshape) - len(jspec)) + list(jspec)
    if DATA_AXIS not in entries:
        return None
    return perm[entries.index(DATA_AXIS) - (len(jshape) - len(perm))]


def _shard_fsdp(module: torch.nn.Module, mesh, min_elements: Optional[int]) -> None:
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    data_mesh = mesh[DATA_AXIS]
    data_size = axis_size(mesh, DATA_AXIS)
    model_size = axis_size(mesh, MODEL_AXIS)
    layers = {name: len(m) for name, m in module.named_modules()
              if name.split(".")[-1] == "layers" and isinstance(m, torch.nn.ModuleList)}
    placement: Dict[int, Optional[int]] = {}
    for name, p in module.named_parameters():
        names, jshape, perm = _jax_names_and_shape(module, name, p, layers, model_size)
        tp_spec = spec_for_param(names, len(jshape), jshape, model_size)
        spec = fsdp_spec_for_param(tp_spec, jshape, data_size, min_elements)
        dim = _fsdp_dim(spec, jshape, perm) if spec != tp_spec else None
        placement[id(p)] = dim if dim is not None and p.shape[dim] % data_size == 0 else None
    whole = {p for p in module.parameters() if placement[id(p)] is None}

    def place(p):
        return Shard(placement[id(p)])

    named = list(module.named_modules())
    units = [(n, m) for n, m in named if type(m).__name__ in _UNIT_CLASSES]
    inside = {id(p) for _, u in units for p in u.parameters()}
    owners = [(n, m) for n, m in named if type(m).__name__ not in _UNIT_CLASSES
              and any(id(p) not in inside for p in m.parameters(recurse=False))]
    # Bottom-up, as fully_shard wants: deeper modules first.
    for _, unit in sorted(units + owners, key=lambda item: -len(item[0].split("."))):
        ignored = {p for p in unit.parameters() if p in whole}
        if all(p in whole for p in unit.parameters()):
            continue
        fully_shard(unit, mesh=data_mesh, shard_placement_fn=place, ignored_params=ignored or None,
                    reshard_after_forward=True)
        if hasattr(unit, "attend"):
            register_fsdp_forward_method(unit, "attend")
    module.fsdp_whole_params = whole


def shard_params(mesh, module: torch.nn.Module, fsdp: bool = False,
                 fsdp_min_elements: Optional[int] = None) -> torch.nn.Module:
    """Place ``module``'s parameters on the mesh, in place, and return it:
    each rank keeps its TP pieces (``spec_for_param``) and, with ``fsdp``,
    its ``data`` shard of every large leaf (``fsdp_spec_for_param``).
    A module placed already is left as it is."""
    check_mesh(mesh)
    tp, data = axis_size(mesh, MODEL_AXIS), axis_size(mesh, DATA_AXIS)
    if tp > 1:
        _shard_tp(module, tp, axis_rank(mesh, MODEL_AXIS), axis_group(mesh, MODEL_AXIS))
    if fsdp and data > 1 and not hasattr(module, "fsdp_whole_params"):
        _shard_fsdp(module, mesh, fsdp_min_elements)
    return module


def is_fsdp_param(p) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(p, DTensor)


def gather_tp(t: torch.Tensor, dim: int, sizes, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    whole = all_gather_cat(t, dim, group)
    if not sizes:
        return whole
    local = [s // n for s in sizes]
    chunks = [c.split(local, dim=dim) for c in whole.chunk(n, dim=dim)]
    return torch.cat([torch.cat([chunks[r][j] for r in range(n)], dim=dim) for j in range(len(sizes))], dim=dim)


def full_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded leaf gathered whole (FSDP
    shards, then TP pieces, fused parts in place). Every rank of the mesh
    must call it; each gets the whole tensors."""
    from torch.distributed.tensor import DTensor

    owners = dict(module.named_modules())
    out = {}
    for name, t in module.state_dict().items():
        if isinstance(t, DTensor):
            t = t.full_tensor()
        owner, _, leaf = name.rpartition(".")
        m = owners.get(owner)
        layout = getattr(m, "tp_layout", None) or {}
        if leaf in layout:
            t = gather_tp(t, *layout[leaf], m.tp_group)
        out[name] = t
    return out
