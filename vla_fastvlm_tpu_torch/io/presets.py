"""FastVLM preset resolution (the port's copy of the preset part of
``vla_fastvlm_tpu/io/model_loader.py``).

A preset id ("apple/FastVLM-0.5B", "fastvlm-0.5b", "tiny", ...) names an
architecture; weights are random from a seed until checkpoints can be
loaded. Loading a local ``config.json`` checkpoint directory is not ported
yet and raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import torch

from ..models.fastvit import fastvithd, fastvithd_tiny
from ..models.fastvlm import FastVLMConfig
from ..models.qwen2 import qwen2_0_5b, qwen2_1_5b, qwen2_7b, qwen2_tiny

# HF ids used throughout the reference docs plus short aliases for offline use.
_PRESETS = {
    "apple/fastvlm-0.5b": (qwen2_0_5b, 1024),
    "apple/fastvlm-1.5b": (qwen2_1_5b, 1024),
    "apple/fastvlm-7b": (qwen2_7b, 1024),
    "fastvlm-0.5b": (qwen2_0_5b, 1024),
    "fastvlm-1.5b": (qwen2_1_5b, 1024),
    "fastvlm-7b": (qwen2_7b, 1024),
    "llava-fastvithd_0.5b_stage3": (qwen2_0_5b, 1024),
    "llava-fastvithd_1.5b_stage3": (qwen2_1_5b, 1024),
    "llava-fastvithd_7b_stage3": (qwen2_7b, 1024),
    "fastvlm-tiny": (qwen2_tiny, 64),
    "tiny": (qwen2_tiny, 64),
}


def _preset_for(model_id: str):
    return _PRESETS.get(model_id.lower())


def resolve_fastvlm_config(
    model_id: str,
    bootstrap_model_id: str = "apple/FastVLM-0.5B",
    dtype: torch.dtype = torch.float32,
    param_dtype: torch.dtype = torch.float32,
    image_token_mode: str = "prefix",
) -> Tuple[FastVLMConfig, Optional[dict]]:
    """Resolve a preset ``model_id`` to ``(FastVLMConfig, None)``.

    ``bootstrap_model_id`` only matters for local checkpoint directories,
    which are not ported yet.
    """
    if Path(model_id).is_dir():
        raise NotImplementedError(
            f"loading the checkpoint directory {model_id!r} is not ported to "
            "PyTorch yet; pass a preset id"
        )
    preset = _preset_for(model_id)
    if preset is None:
        raise ValueError(
            f"Unknown model_id '{model_id}': not a known FastVLM preset. "
            "Pass one of: " + ", ".join(sorted(set(_PRESETS)))
        )
    text_fn, image_size = preset
    text = text_fn(dtype=dtype, param_dtype=param_dtype)
    vision = (
        fastvithd_tiny(dtype=dtype, param_dtype=param_dtype)
        if text.hidden_size <= 256
        else fastvithd(dtype=dtype, param_dtype=param_dtype)
    )
    cfg = FastVLMConfig(
        vision=vision, text=text, image_size=image_size, image_token_mode=image_token_mode,
    )
    return cfg, None

