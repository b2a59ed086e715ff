"""FastVLM HF weights -> the port's ``FastVLM`` state_dict (the weight half of
``vla_fastvlm_tpu/io/model_loader.py``; the config half is
``io/presets.py``).

A local llava_qwen2 directory holds ``config.json`` and one or more
``*.safetensors`` shards. Every shard is read, in sorted order, by the
port's own reader (``io/checkpoint.py::load_safetensors``), which returns
torch tensors of the stored dtype, bf16 included, with neither the
``safetensors`` package nor ``ml_dtypes``. Then:

- the Qwen2 decoder under ``model.`` -> ``language_model.*`` (and an untied
  ``lm_head.weight``), q/k/v and gate/up fused (``io/weights.py``), each
  leaf cast to ``dtype`` on its own;
- the llava ``mlp2x_gelu`` projector ``model.mm_projector.{0,2}`` ->
  ``mm_projector.fc1`` / ``fc2``, when the model has image tokens;
- the FastViTHD tower under ``model.vision_tower.`` when the model has
  image tokens: folded in float32 (``io/vision_convert.py``), then cast. A
  name the converter cannot match leaves the tower random, with JAX's
  warning.

The result is a partial ``state_dict``: the backbone overlays it on its
seeded init (``model/fastvlm_adapter.py``), so a decoder-only checkpoint
still runs, as in JAX.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from ..models.fastvlm import FastVLMConfig
from .checkpoint import load_safetensors
from .vision_convert import convert_vision_tower
from .weights import as_tensor, convert_qwen2_state_dict

logger = logging.getLogger(__name__)


def _read_safetensors_state(model_dir: Path) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}
    for shard in sorted(model_dir.glob("*.safetensors")):
        state.update(load_safetensors(shard))
    return state


def load_fastvlm_params(
    model_dir: str | Path,
    cfg: FastVLMConfig,
    dtype: torch.dtype = torch.float32,
    timings: Optional[Dict[str, float]] = None,
) -> Optional[Dict[str, torch.Tensor]]:
    """Read and convert a llava_qwen2 directory's shards into the port's
    ``FastVLM`` names, CPU tensors of ``dtype``.

    Returns None when the directory holds no safetensors (the caller then
    keeps its random init, the offline path). ``timings``, when given,
    receives the seconds of each part: "read", "decoder" (names, fusion and
    casts of the decoder and projector) and "fold" (the tower).
    """
    model_dir = Path(model_dir)
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        if timings is not None:
            timings[name] = now - clock[0]
        clock[0] = now

    state = _read_safetensors_state(model_dir)
    lap("read")
    if not state:
        logger.warning("No *.safetensors found in %s; model will be randomly initialized.", model_dir)
        return None

    # Decoder: llava_qwen2 keeps the Qwen2 stack under "model." at top level
    # (next to model.vision_tower / model.mm_projector).
    params: Dict[str, torch.Tensor] = {}
    for name, value in convert_qwen2_state_dict(state, cfg.text, prefix="model.", dtype=dtype).items():
        params["language_model." + name[len("model."):] if name.startswith("model.") else name] = value

    # Projector: llava mlp2x_gelu = Sequential(Linear, GELU, Linear); a
    # text-only model holds none.
    images = cfg.image_token_mode != "none"
    for hf_idx, ours in (("0", "fc1"), ("2", "fc2")):
        w_key = f"model.mm_projector.{hf_idx}.weight"
        if images and w_key in state:
            params[f"mm_projector.{ours}.weight"] = as_tensor(state[w_key], dtype)
            params[f"mm_projector.{ours}.bias"] = as_tensor(state[f"model.mm_projector.{hf_idx}.bias"], dtype)
    lap("decoder")

    if images and any(k.startswith("model.vision_tower.") for k in state):
        try:
            tower = convert_vision_tower(state, cfg.vision, dtype=dtype)
            params.update({"vision_tower." + k: v for k, v in tower.items()})
        except KeyError as exc:
            logger.warning(
                "Vision tower weights present but could not be converted (%s); "
                "vision tower will be randomly initialized.",
                exc,
            )
    lap("fold")
    return params
