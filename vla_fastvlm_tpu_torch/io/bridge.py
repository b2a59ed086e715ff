"""Weight bridge between the JAX package's parameters and the port's modules.

``jax_params_to_torch``: JAX parameters (as numpy) -> the port's state_dict.

Input is a nested dict of arrays, or the flat dotted names that
``vla_fastvlm_tpu/io/checkpoint.py::flatten_params`` produces. No JAX is
needed: the arrays are numpy (bf16 leaves arrive as ``ml_dtypes.bfloat16``
and are widened to float32). Per leaf:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in); that covers the 1x1
  ``ConvAct`` stored as a Dense (C, F) over the channel axis;
- conv ``kernel`` HWIO (kh, kw, in/groups, out) -> ``weight`` OIHW
  (out, in/groups, kh, kw), depthwise and grouped alike (the grouping of
  output channels is the same in both frameworks);
- LayerNorm / ChannelAffine ``scale`` -> ``weight``; ``embedding`` -> ``weight``;
- the scanned decoder's stacked ``layers.*`` leaves (leading L axis) ->
  ``layers.<i>.*``; an unscanned ``layers_<i>`` -> ``layers.<i>``;
- ``q_proj``/``k_proj``/``v_proj`` -> one ``qkv_proj`` (q, k, v order) and
  ``gate_proj``/``up_proj`` -> one ``gate_up_proj`` (gate, up order).

Prefixes pass through, so ``{"backbone": ..., "head": ...}`` maps to
``backbone.*`` and ``head.*`` names.

Quantized projections (``io/quantize.py``) cross too: an int8 ``kernel``
``(L, K, N)`` with its ``scale`` ``(L, 1, N)`` becomes a ``QuantDense``'s
``qweight`` ``(N, K)`` and ``scale`` ``(N,)`` per layer; an
``ml_dtypes.int4`` kernel, packed two codes a byte, ``qweight`` ``(N, K/2)``
with ``scale`` ``(K/G, N)`` as it is; fused groups concatenate their scales
along the output axis. Back in the JAX layout int4 kernels are
``ml_dtypes.int4`` arrays (numpy, even with ``as_numpy=False``: torch has no
int4 tensor), which no safetensors file holds, as in JAX.

``torch_params_to_jax(module)`` is the inverse: a module's state_dict ->
the JAX tree (nested dict), the decoder's layers stacked again along a
leading axis (``scanned``, the JAX default) or named ``layers_<i>``. The
owning module's class says which JAX leaf a ``weight`` was (``kernel`` of a
Dense or conv, ``scale`` of a LayerNorm or ChannelAffine, ``embedding``;
RMSNorm keeps ``weight``), and the fused projections are split back into
their parts by the attention config's head counts.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from ..parallel.sharding import full_state_dict

_UNSCANNED = re.compile(r"^layers_(\d+)$")
_FUSED = {
    "self_attn": ("qkv_proj", ("q_proj", "k_proj", "v_proj")),
    "mlp": ("gate_up_proj", ("gate_proj", "up_proj")),
}


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> flat dotted names (same rule as the JAX checkpoint I/O)."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, prefix=path + "."))
        else:
            flat[path] = value
    return flat


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):  # a checkpoint read by the port's own reader
        x = x.detach().cpu()
        x = x.float() if x.dtype == torch.bfloat16 else x
    arr = np.asarray(x)
    if arr.dtype.name == "int4":  # ml_dtypes: the codes, widened
        return arr.astype(np.int8)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _quant_kind(arr) -> str | None:
    """"int8" or "int4" for a quantized JAX kernel, else None."""
    name = getattr(getattr(arr, "dtype", None), "name", None) or str(getattr(arr, "dtype", ""))
    if name == "int4":
        return "int4"
    if name in ("int8", "torch.int8"):
        return "int8"
    return None


def _quant_leaf(path: str, arr: np.ndarray, kind: str):
    """A quantized Dense's JAX leaf -> the ``QuantDense`` buffer or bias."""
    parts = path.split(".")
    if parts[-1] == "kernel":
        q = np.ascontiguousarray(arr.T)
        if kind == "int4":
            from ..ops.quant import pack_int4

            q = pack_int4(torch.from_numpy(q)).numpy()
        return ".".join(parts[:-1] + ["qweight"]), q
    if parts[-1] == "scale" and kind == "int8":
        return path, arr[0]
    return path, arr


def _unstack_layers(path: str, arr: np.ndarray):
    """Yield (path, array) with decoder layers unstacked / renamed."""
    parts = path.split(".")
    if "layers" in parts:
        i = parts.index("layers")
        for layer in range(arr.shape[0]):
            yield ".".join(parts[:i] + ["layers", str(layer)] + parts[i + 1:]), arr[layer]
        return
    for i, part in enumerate(parts):
        match = _UNSCANNED.match(part)
        if match:
            parts = parts[:i] + ["layers", match.group(1)] + parts[i + 1:]
            break
    yield ".".join(parts), arr


def _leaf(path: str, arr: np.ndarray):
    parts = path.split(".")
    leaf = parts[-1]
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{path}: kernel of rank {arr.ndim} has no torch layout")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(parts[:-1] + [leaf]), arr


def jax_params_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameters (nested or flat, numpy leaves) -> the port's state_dict."""
    flat = flatten_params(params)
    # A quantized Dense: an integer kernel beside a "scale" (no float Dense has one).
    quantized = {path[:-7]: kind for path, value in flat.items()
                 if path.endswith(".kernel") and path[:-7] + ".scale" in flat and (kind := _quant_kind(value))}
    mapped: Dict[str, np.ndarray] = {}
    for path, value in flat.items():
        kind = quantized.get(path.rpartition(".")[0])
        for p, a in _unstack_layers(path, _as_numpy(value)):
            name, arr = _quant_leaf(p, a, kind) if kind else _leaf(p, a)
            mapped[name] = arr

    out: Dict[str, np.ndarray] = {}
    fused_parts: Dict[str, Dict[str, np.ndarray]] = {}
    for name, arr in mapped.items():
        parts = name.split(".")
        if len(parts) >= 3 and parts[-3] in _FUSED and parts[-2] in _FUSED[parts[-3]][1]:
            target = _FUSED[parts[-3]][0]
            key = ".".join(parts[:-2] + [target, parts[-1]])
            fused_parts.setdefault(key, {})[parts[-2]] = arr
            continue
        out[name] = arr
    for key, pieces in fused_parts.items():
        order = _FUSED[key.split(".")[-3]][1]
        missing = [p for p in order if p not in pieces]
        if missing:
            raise KeyError(f"{key}: missing {missing} to fuse")
        # Scales are per output column: (N,) for int8, (K/G, N) for int4.
        out[key] = np.concatenate([pieces[p] for p in order], axis=-1 if key.endswith(".scale") else 0)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


# Owning module class -> the JAX name of its ``weight``.
_JAX_WEIGHT = {"Dense": "kernel", "Conv2d": "kernel", "LayerNorm": "scale", "ChannelAffine": "scale",
               "Embed": "embedding"}
_LAYER = re.compile(r"^(.*\.)?layers\.(\d+)\.(.*)$")
# Fused projection -> (its parent module's name, the JAX parts in order).
_SPLIT = {target: (parent, names) for parent, (target, names) in _FUSED.items()}


def _split_fused(module: torch.nn.Module, owner: str, leaf: str, t: torch.Tensor):
    """Yield (owner, leaf, tensor) with a fused projection split into its parts."""
    parts = owner.split(".")
    if parts[-1] not in _SPLIT or len(parts) < 2 or parts[-2] != _SPLIT[parts[-1]][0]:
        yield owner, leaf, t
        return
    names = _SPLIT[parts[-1]][1]
    dim = -1 if leaf == "scale" else 0  # scales run along the output axis last
    if parts[-1] == "qkv_proj":
        cfg = module.get_submodule(".".join(parts[:-1])).cfg
        n, kh, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.resolved_head_dim
        sizes = [n * d, kh * d, kh * d]
    else:
        sizes = [t.shape[dim] // 2] * 2
    for name, piece in zip(names, t.split(sizes, dim=dim)):
        yield ".".join(parts[:-1] + [name]), leaf, piece


def _jax_quant_leaf(leaf: str, t: torch.Tensor):
    """A ``QuantDense`` buffer -> (JAX leaf name, value): the kernel ``(K, N)``
    (int8, or int4 codes to be cast), an int8 scale ``(1, N)``."""
    if leaf == "qweight":
        if t.dtype == torch.uint8:
            from ..ops.quant import unpack_int4

            t = unpack_int4(t)
        return "kernel", t.t()
    if leaf == "scale" and t.ndim == 1:
        return "scale", t[None]
    return leaf, t


def _int4_array(t: torch.Tensor):
    try:
        import ml_dtypes
    except ImportError as err:
        raise TypeError("int4 kernels cross to the JAX layout as ml_dtypes.int4 arrays; ml_dtypes is not "
                        "installed") from err
    return t.numpy().astype(ml_dtypes.int4)


def torch_params_to_jax(module: torch.nn.Module, scanned: bool = True, as_numpy: bool = True) -> Dict:
    """A module's state_dict -> the JAX package's parameter tree.

    Leaves are new CPU tensors in the JAX layout, or numpy arrays with
    ``as_numpy`` (bf16 widened to float32, since numpy has no bf16). On the
    meta device only the shapes are made (``as_numpy=False``). A module
    placed on a mesh (``parallel/sharding.py``) gives its whole tensors:
    every rank of the mesh must call it.
    """
    # fully_shard renames a module's class "FSDP" + its name.
    owners = {name: type(m).__name__.removeprefix("FSDP") for name, m in module.named_modules()}
    flat: Dict[str, torch.Tensor] = {}
    int4 = set()
    for name, value in full_state_dict(module).items():
        t = value.detach()
        if not t.is_meta:
            t = t.to("cpu", copy=True)  # a snapshot: the parameters may change after
        owner, _, leaf = name.rpartition(".")
        cls = owners.get(owner)
        for owner_, leaf_, piece in _split_fused(module, owner, leaf, t):
            if cls == "QuantDense":
                if leaf_ == "qweight" and piece.dtype == torch.uint8:
                    int4.add(f"{owner_}.kernel")
                leaf_, piece = _jax_quant_leaf(leaf_, piece)
            elif leaf_ == "weight" and cls in _JAX_WEIGHT:
                leaf_ = _JAX_WEIGHT[cls]
                if leaf_ == "kernel":
                    piece = piece.t() if piece.ndim == 2 else piece.permute(2, 3, 1, 0)
            flat[f"{owner_}.{leaf_}" if owner_ else leaf_] = piece

    stacked: Dict[str, Dict[int, torch.Tensor]] = {}
    out: Dict[str, torch.Tensor] = {}
    out_int4 = set()
    for name, t in flat.items():
        match = _LAYER.match(name)
        if match is None:
            new = name
            out[name] = t
        elif scanned:
            new = f"{match.group(1) or ''}layers.{match.group(3)}"
            stacked.setdefault(new, {})[int(match.group(2))] = t
        else:
            new = f"{match.group(1) or ''}layers_{match.group(2)}.{match.group(3)}"
            out[new] = t
        if name in int4:
            out_int4.add(new)
    for name, layers in stacked.items():
        out[name] = torch.stack([layers[i] for i in range(len(layers))])

    tree: Dict = {}
    for name, t in out.items():
        t = t.contiguous()
        if name in out_int4 and not t.is_meta:
            t = _int4_array(t)
        elif as_numpy:
            t = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


def _lora_leaf(x) -> torch.Tensor:
    """A JAX adapter leaf (numpy, ``ml_dtypes`` bf16 included, or a tensor) -> a CPU tensor of its dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(arr)


def jax_lora_to_torch(tree: Mapping) -> Dict:
    """A JAX adapter tree (``io/lora.py`` of the JAX package: single,
    ``stack_loras``-stacked, or with ``lora_with_ids`` ids; scanned or with
    ``layers_<i>`` nodes) -> the port's tree of CPU tensors: the layers
    stacked on a leading axis, ids ``(B,)``."""

    def walk(node):
        out, layers = {}, {}
        for key, child in node.items():
            match = _UNSCANNED.match(key)
            if match:
                layers[int(match.group(1))] = walk(child)
            elif key == "ids":
                ids = _lora_leaf(child)
                out[key] = (ids[0] if ids.ndim == 2 else ids).to(torch.int64)
            else:
                out[key] = walk(child) if isinstance(child, Mapping) else _lora_leaf(child)
        if layers:
            out["layers"] = _stack_layers([layers[i] for i in range(len(layers))])
        return out

    return walk(tree)


def _stack_layers(trees: list) -> Dict:
    """Per-layer trees -> one tree, each leaf stacked on a leading layer axis (ids are shared)."""
    return {k: _stack_layers([t[k] for t in trees]) if isinstance(v, Mapping)
            else v if k == "ids" else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def torch_lora_to_jax(tree: Mapping, scanned: bool = True, as_numpy: bool = True) -> Dict:
    """The port's adapter tree -> the JAX package's: the stacked ``layers``
    as they are (``scanned``, the JAX default) or split into ``layers_<i>``;
    ids tiled to ``(L, B)`` for a scanned stacked site, as JAX's
    ``lora_with_ids`` does. Leaves are CPU copies, or numpy arrays with
    ``as_numpy`` (bf16 widened to float32)."""

    def leaf(t: torch.Tensor):
        if t.is_meta:  # shapes only (as_numpy=False)
            return t.detach()
        t = t.detach().to("cpu", copy=True).contiguous()
        if as_numpy:
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return t

    def walk(node, in_layers=False):
        out = {}
        for key, child in node.items():
            if key == "layers" and isinstance(child, Mapping) and not scanned:
                n_layers = next(iter(flatten_params(child).values())).shape[0]
                for i in range(n_layers):
                    out[f"layers_{i}"] = walk(_select_layer(child, i))
            elif key == "ids":
                ids = child
                if scanned and in_layers and node["a"].ndim == 4:
                    ids = ids[None].expand(node["a"].shape[0], -1)
                out[key] = leaf(ids.to(torch.int32))
            elif isinstance(child, Mapping):
                out[key] = walk(child, in_layers or key == "layers")
            else:
                out[key] = leaf(child)
        return out

    return walk(tree)


def _select_layer(node: Mapping, i: int) -> Dict:
    return {k: (_select_layer(v, i) if isinstance(v, Mapping) else (v if k == "ids" else v[i]))
            for k, v in node.items()}
