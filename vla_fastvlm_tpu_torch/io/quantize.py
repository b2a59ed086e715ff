"""Weight quantization of a model in place (counterpart of
``vla_fastvlm_tpu/io/quantize.py``).

``quantize_params`` replaces the decoder's projections (and an untied
``lm_head``) by ``QuantDense`` modules holding int8 or packed int4 codes and
float32 scales (``ops/quant.py``); embeddings, norms, the vision tower and
the projector stay float. It works on a ``Qwen2Model``, a
``Qwen2ForCausalLM``, a ``FastVLM`` or anything holding one, by module
name, as JAX matches parameter names.

``names`` are JAX's: the port's fused ``qkv_proj`` stands for
``q_proj``/``k_proj``/``v_proj`` and ``gate_up_proj`` for
``gate_proj``/``up_proj``. A fused weight quantizes to the codes and scales
of its parts concatenated (scales are per output row, int4 groups run along
the input), and a ``names`` set that holds only part of a fused group
raises ``ValueError``, as JAX's ``fused_dense_apply`` refuses a mixed group.

Each weight is quantized on its own device and the float module dropped
once it is replaced, so a model on the card never holds a second float copy.
``"w8a8"`` stores what ``"int8"`` stores. A projection takes the w8a8
product (``act_quant``) when ``mode`` is "w8a8" or its owning module's
config says ``quantization == "w8a8"`` (JAX reads the config at apply
time), so a float-built model smoothed by ``io/smooth.py`` and quantized
with ``mode="w8a8"`` serves w8a8.
"""

from __future__ import annotations

import re
from typing import Iterable, Optional

import torch

from ..models.layers import Dense, QuantDense
from ..ops.quant import INT4_GROUP

# Qwen2 decoder matmul names eligible for quantization (JAX's).
DEFAULT_QUANT_NAMES: frozenset = frozenset(
    {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj", "lm_head"}
)
# The port's module name -> the JAX names it holds.
PORT_NAMES = {"qkv_proj": ("q_proj", "k_proj", "v_proj"), "gate_up_proj": ("gate_proj", "up_proj"),
              "o_proj": ("o_proj",), "down_proj": ("down_proj",), "lm_head": ("lm_head",)}
_LAYER = re.compile(r"(^|\.)layers\.\d+(?=\.)")


def _model_quantization(module: torch.nn.Module) -> Optional[str]:
    cfg = getattr(module, "cfg", None)
    cfg = getattr(cfg, "text", cfg)
    return getattr(cfg, "quantization", None)


def quantize_params(module: torch.nn.Module, names: Iterable[str] = DEFAULT_QUANT_NAMES, mode: str = "int8",
                    group_size: Optional[int] = None) -> torch.nn.Module:
    """Quantize ``module``'s matching float projections in place and return it.

    ``mode``: "int8" (per-row scales), "w8a8" (the same storage, int8
    activations at apply time) or "int4" (``group_size``, default 128,
    shrunk to ``gcd(K, group_size)``). Biases stay float.
    """
    if mode not in ("int8", "w8a8", "int4"):
        raise ValueError(f"unknown quantization mode {mode!r}")
    names = frozenset(names)
    group = INT4_GROUP if group_size is None else int(group_size)
    targets = []
    for path, child in module.named_modules():
        parts = PORT_NAMES.get(path.rpartition(".")[2])
        if parts is None or not isinstance(child, Dense):
            continue
        held = names.intersection(parts)
        if held and len(held) < len(parts):
            raise ValueError(f"{path} fuses {list(parts)}: quantize all of them or none, got {sorted(held)}")
        if held and child.weight.is_floating_point():
            targets.append(path)
    for path in targets:
        parent_path, _, attr = path.rpartition(".")
        parent = module.get_submodule(parent_path)
        act_quant = "w8a8" in (mode, _model_quantization(parent))
        setattr(parent, attr, QuantDense.from_dense(getattr(parent, attr), mode, group, act_quant))
    return module


def count_quantized(module: torch.nn.Module) -> int:
    """Quantized kernels in JAX's units: each of the scanned decoder's
    projections once for all layers, a fused ``qkv_proj`` as 3 and
    ``gate_up_proj`` as 2."""
    seen = set()
    count = 0
    for path, child in module.named_modules():
        if isinstance(child, QuantDense):
            key = _LAYER.sub(r"\1layers", path)
            if key not in seen:
                seen.add(key)
                count += len(PORT_NAMES.get(path.rpartition(".")[2], (path,)))
    return count
