"""Weight bridge: JAX-package parameters (as numpy) -> the port's state_dict.

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
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

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
    arr = np.asarray(x)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


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
    mapped: Dict[str, np.ndarray] = {}
    for path, value in flat.items():
        for p, a in _unstack_layers(path, _as_numpy(value)):
            name, arr = _leaf(p, a)
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
        out[key] = np.concatenate([pieces[p] for p in order], axis=0)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
