"""Checkpoint I/O of the port, in the JAX package's layout (counterpart of
``vla_fastvlm_tpu/io/checkpoint.py``)::

    output_dir/training_config.json
    output_dir/checkpoints/step-N/
        policy_config.json              # dataclass asdict of the policy config
        policy_state_dict.safetensors   # full params: the JAX tree's dotted flat keys
        train_state/train_state.pt      # optimizer state + counters (resume)

``policy_state_dict.safetensors`` holds the JAX package's tree (stacked
decoder layers, ``kernel``/``scale``/``embedding`` leaves, separate q/k/v and
gate/up), so either package loads what the other wrote: the port maps it
through the weight bridge (``io/bridge.py``). The safetensors format is read
and written here without the ``safetensors`` package: an 8-byte
little-endian header length, a JSON header (dtype, shape, byte offsets per
tensor), then the raw little-endian bytes; bf16 goes through a ``uint16``
view.

The resumable train state is the port's own ``train_state/train_state.pt``
(``torch.save`` of the optimizer state, ``global_step``, ``epoch``, the
update count and the dropout generator's state). The JAX package's
``train_state/`` is an orbax tree of optax state: resuming a run across
packages is out of scope; the policy weights cross both ways.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import re
import shutil
import struct
import sys
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from .bridge import flatten_params

logger = logging.getLogger(__name__)

POLICY_CONFIG = "policy_config.json"
POLICY_WEIGHTS = "policy_state_dict.safetensors"
TRAIN_STATE_DIR = "train_state"
TRAIN_STATE_FILE = "train_state.pt"

# safetensors dtype names <-> torch dtypes.
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024


def _host_array(t: torch.Tensor) -> np.ndarray:
    """The little-endian bytes of ``t`` as a numpy array (bf16 as uint16)."""
    t = t.detach().cpu().contiguous()
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()


def save_safetensors(tensors: Mapping[str, Any], path: str | Path,
                     metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``{name: tensor or numpy array}`` in the safetensors format."""
    if sys.byteorder != "little":
        raise RuntimeError("the safetensors writer assumes a little-endian host")
    arrays, header, offset = {}, {}, 0
    for name in sorted(tensors):
        value = tensors[name]
        if not isinstance(value, torch.Tensor) and np.asarray(value).dtype.name == "int4":
            # ml_dtypes' int4 (a quantized policy's kernels): safetensors has no such dtype.
            raise TypeError(f"{name}: dtype {np.asarray(value).dtype} has no safetensors name")
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value, copy=None, order="C"))
        if t.dtype not in _ST_NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        arrays[name] = _host_array(t)
        nbytes = arrays[name].nbytes
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = dict(metadata)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in sorted(arrays):
            f.write(memoryview(arrays[name].reshape(-1)).cast("B"))


def load_safetensors(path: str | Path) -> Dict[str, torch.Tensor]:
    """Read a safetensors file into CPU tensors."""
    path = Path(path)
    size = path.stat().st_size
    out: Dict[str, torch.Tensor] = {}
    if size < 8:
        raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        if n > min(_MAX_HEADER, size - 8):
            raise ValueError(f"{path}: header of {n} bytes in a file of {size}")
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _ST_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the reader does not take")
            shape = [int(s) for s in info["shape"]]
            begin, end = (int(o) for o in info["data_offsets"])
            count = int(np.prod(shape, dtype=np.int64))
            storage = torch.uint16 if dtype == torch.bfloat16 else dtype
            itemsize = torch.empty((), dtype=storage).element_size()
            if end - begin != count * itemsize or not 0 <= begin <= end <= size - base:
                raise ValueError(f"{path}: {name} offsets {begin}..{end} do not hold {shape} {info['dtype']}")
            f.seek(base + begin)
            np_dtype = torch.empty((), dtype=storage).numpy().dtype
            arr = np.fromfile(f, dtype=np_dtype, count=count)
            t = torch.from_numpy(arr).reshape(shape)
            out[name] = t.view(torch.bfloat16) if dtype == torch.bfloat16 else t
    return out


def unflatten_params(flat: Mapping[str, Any]) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


# ----------------------------------------------------------------------
# policy checkpoints


def save_policy_checkpoint(checkpoint_dir: str | Path, config: Any, params: Mapping) -> None:
    """Write policy_config.json + policy_state_dict.safetensors. ``params``
    is the JAX tree (``FastVLAPolicy.jax_params(as_numpy=False)``)."""
    checkpoint_dir = Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    config_dict = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else dict(config)
    with open(checkpoint_dir / POLICY_CONFIG, "w", encoding="utf-8") as f:
        json.dump(config_dict, f, indent=2)
    save_safetensors(flatten_params(params), checkpoint_dir / POLICY_WEIGHTS)


def load_policy_state(checkpoint_dir: str | Path) -> Tuple[Dict[str, Any], Dict]:
    """Read (config_dict, params_tree) from a checkpoint directory; the tree
    is the JAX package's, with CPU tensors as leaves."""
    checkpoint_dir = Path(checkpoint_dir)
    config_path = checkpoint_dir / POLICY_CONFIG
    weights_path = checkpoint_dir / POLICY_WEIGHTS
    if not config_path.exists():
        raise FileNotFoundError(f"Missing {POLICY_CONFIG} in {checkpoint_dir}")
    if not weights_path.exists():
        raise FileNotFoundError(f"Missing {POLICY_WEIGHTS} in {checkpoint_dir}")
    with open(config_path, encoding="utf-8") as f:
        config_dict = json.load(f)
    return config_dict, unflatten_params(load_safetensors(weights_path))


def _filter_known_fields(cls, config: Mapping[str, Any]) -> Dict[str, Any]:
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(config) - known
    if unknown:
        logger.warning("Ignoring unknown config fields %s for %s", sorted(unknown), cls.__name__)
    return {k: v for k, v in config.items() if k in known}


def load_policy_from_checkpoint(checkpoint_dir: str | Path, device: DeviceLike = None, strict: bool = True):
    """Build the policy a checkpoint directory describes and load its
    weights: ``(policy, device)``. The card unless ``device="cpu"``.

    The JAX rule dispatches: a config with ``vlm_model_name`` is FastVLA,
    ``FastVLMTokenPolicy`` when it says ``action_head == "token"`` (the same
    layout with no ``head`` sub-tree), else ``FastVLAPolicy``; a config
    without it is the legacy ``FastVLMPolicy`` (its ``backbone`` sub-dict
    and its own fields filtered to the known ones).
    ``strict=False`` lets the checkpoint leave parameters at their init.
    A ``"lora"`` sub-tree (a policy trained with ``lora_rank > 0``, JAX's
    key names and scanned shapes) loads into the policy's adapters.
    """
    from ..fastvla import FastVLAConfig, FastVLAPolicy, FastVLMTokenPolicy
    from ..model.fastvlm_adapter import FastVLMBackboneConfig
    from ..model.policy import FastVLMPolicy, FastVLMPolicyConfig

    config_dict, params = load_policy_state(checkpoint_dir)
    if "vlm_model_name" in config_dict:
        config = FastVLAConfig(**_filter_known_fields(FastVLAConfig, config_dict))
        policy_cls = FastVLMTokenPolicy if config.action_head == "token" else FastVLAPolicy
        policy = policy_cls(config, device=device)
    else:
        own = dict(config_dict)
        backbone = FastVLMBackboneConfig(**_filter_known_fields(FastVLMBackboneConfig, own.pop("backbone")))
        policy = FastVLMPolicy(FastVLMPolicyConfig(backbone=backbone, **_filter_known_fields(FastVLMPolicyConfig, own)),
                               device=device)
    if strict:
        policy.load_jax_params(params)
    else:
        from .bridge import jax_params_to_torch

        if isinstance(policy, FastVLAPolicy):
            backbone, head = policy.model.backbone, policy.model.head
        else:  # the token policy has no head
            backbone, head = policy.backbone, getattr(policy, "head", None)
        backbone.model.load_state_dict(jax_params_to_torch(params.get("backbone", {})), strict=False)
        if head is not None:
            head.load_state_dict(jax_params_to_torch(params.get("head", {})), strict=False)
        owner = policy.model if isinstance(policy, FastVLAPolicy) else policy
        if "lora" in params and getattr(owner, "lora", None) is not None:
            from .lora import load_lora_params

            owner.lora = load_lora_params(owner.lora, params["lora"])
    return policy, policy.device


def prune_checkpoints(checkpoints_dir: str | Path, keep_last_n: Optional[int]) -> list:
    """Delete the oldest ``step-N`` checkpoint dirs beyond ``keep_last_n``.

    Only numbered ``step-N`` directories take part; preemption and final
    checkpoints are never pruned. Returns the removed paths.
    """
    checkpoints_dir = Path(checkpoints_dir)
    if keep_last_n is None or keep_last_n <= 0 or not checkpoints_dir.exists():
        return []
    steps = []
    for child in checkpoints_dir.iterdir():
        match = re.fullmatch(r"step-(\d+)", child.name)
        if match and child.is_dir():
            steps.append((int(match.group(1)), child))
    steps.sort()
    removed = []
    for _, path in steps[:-keep_last_n]:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


# ----------------------------------------------------------------------
# train state (resume)


def save_train_state(checkpoint_dir: str | Path, state: Mapping[str, Any]) -> None:
    """Persist the trainer's state (optimizer state, counters, generator state)."""
    path = Path(checkpoint_dir) / TRAIN_STATE_DIR
    path.mkdir(parents=True, exist_ok=True)
    torch.save(dict(state), path / TRAIN_STATE_FILE)


def load_train_state(checkpoint_dir: str | Path) -> Dict[str, Any]:
    """Read what ``save_train_state`` wrote (tensors on the CPU)."""
    path = Path(checkpoint_dir) / TRAIN_STATE_DIR / TRAIN_STATE_FILE
    if not path.exists():
        raise FileNotFoundError(f"Missing {TRAIN_STATE_DIR}/{TRAIN_STATE_FILE} in {checkpoint_dir}")
    return torch.load(path, map_location="cpu", weights_only=True)
