"""FastVLM config resolution (the port's copy of the config half of
``vla_fastvlm_tpu/io/model_loader.py``).

``model_id`` is either

1. a preset id ("apple/FastVLM-0.5B", "fastvlm-0.5b", "tiny", ...), which
   names an architecture, or
2. a local directory in the HF layout whose ``config.json`` describes one:
   - ``model_type == "llava_qwen2"``: the full multimodal architecture,
     fields that the file leaves out borrowed from ``bootstrap_model_id``
     (a preset or a directory with its own ``config.json``), the image size
     parsed from the vision tower's name;
   - ``model_type == "qwen2"``: a text-only decoder (``image_token_mode``
     "none").

Only the config is resolved here. The weights of such a directory are
converted by ``io/model_loader.py`` and laid over the backbone's seeded
init (``model/fastvlm_adapter.py``); with no ``*.safetensors`` they stay
random.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.fastvit import fastvithd, fastvithd_tiny
from ..models.fastvlm import FastVLMConfig
from ..models.qwen2 import Qwen2Config, qwen2_0_5b, qwen2_1_5b, qwen2_7b, qwen2_tiny

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


def _text_config_from_json(cfg: Dict[str, Any], base: Qwen2Config) -> Qwen2Config:
    """A Qwen2Config from an HF config dict, each absent field from ``base``."""

    def get(key, default):
        value = cfg.get(key)
        return default if value is None else value

    return base.replace(
        vocab_size=int(get("vocab_size", base.vocab_size)),
        hidden_size=int(get("hidden_size", base.hidden_size)),
        num_hidden_layers=int(get("num_hidden_layers", base.num_hidden_layers)),
        num_attention_heads=int(get("num_attention_heads", base.num_attention_heads)),
        num_key_value_heads=int(get("num_key_value_heads", base.num_key_value_heads)),
        intermediate_size=int(get("intermediate_size", base.intermediate_size)),
        rope_theta=float(get("rope_theta", base.rope_theta)),
        rms_norm_eps=float(get("rms_norm_eps", base.rms_norm_eps)),
        tie_word_embeddings=bool(get("tie_word_embeddings", base.tie_word_embeddings)),
        max_position_embeddings=int(get("max_position_embeddings", base.max_position_embeddings)),
    )


def _read_json(path: Path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _resolve_directory(
    path: Path, bootstrap_model_id: str, dtype: torch.dtype, param_dtype: torch.dtype, image_token_mode: str,
) -> Tuple[FastVLMConfig, Dict[str, Any]]:
    config_path = path / "config.json"
    if not config_path.is_file():
        raise RuntimeError(
            "Local checkpoint directories must contain config.json. "
            f"Got model_id='{path}'."
        )
    raw = _read_json(config_path)
    model_type = raw.get("model_type")
    bootstrap = _preset_for(bootstrap_model_id)
    if bootstrap is not None:
        base_text = bootstrap[0]()
    else:
        # The bootstrap may itself be a local directory: its fields are the defaults.
        base_text = qwen2_0_5b()
        boot_cfg_file = Path(bootstrap_model_id) / "config.json"
        if boot_cfg_file.is_file():
            base_text = _text_config_from_json(_read_json(boot_cfg_file), base_text)

    if model_type == "llava_qwen2":
        text = _text_config_from_json(raw, base_text)
        tower_name = raw.get("mm_vision_tower") or raw.get("vision_tower") or ""
        image_size = infer_size_from_tower_name(tower_name) or (bootstrap[1] if bootstrap else 1024)
        vision = fastvithd() if text.hidden_size > 256 else fastvithd_tiny()
        cfg = FastVLMConfig(
            vision=vision.replace(dtype=dtype, param_dtype=param_dtype),
            text=text.replace(dtype=dtype, param_dtype=param_dtype),
            image_size=int(image_size),
            image_token_mode=image_token_mode,
        )
        return cfg, raw
    if model_type == "qwen2":
        text = _text_config_from_json(raw, base_text)
        cfg = FastVLMConfig(
            vision=fastvithd(dtype=dtype, param_dtype=param_dtype),
            text=text.replace(dtype=dtype, param_dtype=param_dtype),
            image_token_mode="none",
        )
        return cfg, raw
    raise RuntimeError(
        "Bootstrap fallback was triggered, but the local model_type is not "
        f"llava_qwen2. Got '{model_type}'."
    )


def resolve_fastvlm_config(
    model_id: str,
    bootstrap_model_id: str = "apple/FastVLM-0.5B",
    dtype: torch.dtype = torch.float32,
    param_dtype: torch.dtype = torch.float32,
    image_token_mode: str = "prefix",
) -> Tuple[FastVLMConfig, Optional[Dict[str, Any]]]:
    """Resolve ``model_id`` to ``(FastVLMConfig, raw config.json dict or None)``.

    RuntimeError for a directory without ``config.json`` or of another
    ``model_type``, ValueError for an unknown id, as in JAX.
    """
    path = Path(model_id)
    if path.is_dir():
        return _resolve_directory(path, bootstrap_model_id, dtype, param_dtype, image_token_mode)
    preset = _preset_for(model_id)
    if preset is None:
        raise ValueError(
            f"Unknown model_id '{model_id}': not a local checkpoint directory "
            "and not a known FastVLM preset. Pass a directory with config.json "
            "or one of: " + ", ".join(sorted(set(_PRESETS)))
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


def infer_size_from_tower_name(tower_name: Any) -> Optional[int]:
    """The input resolution in a vision tower's name: anchored suffixes first
    (``mobileclip_l_1024``, ``...patch14-384``), then the last number in
    [64, 4096] that is not a model scale (``so400m``)."""
    if not isinstance(tower_name, str):
        return None
    name = tower_name.lower()

    for pattern in (
        r"(?:^|[_-])(\d{2,4})$",
        r"patch\d+[-_](\d{2,4})(?:$|[_-])",
    ):
        match = re.search(pattern, name)
        if match is not None:
            value = int(match.group(1))
            if 64 <= value <= 4096:
                return value

    fallback_values = []
    for match in re.finditer(r"(\d{2,4})", name):
        value = int(match.group(1))
        if not (64 <= value <= 4096):
            continue
        if name[match.end(): match.end() + 1] in {"m", "b"}:
            continue
        fallback_values.append(value)
    return fallback_values[-1] if fallback_values else None
