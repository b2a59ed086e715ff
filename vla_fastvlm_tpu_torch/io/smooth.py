"""SmoothQuant activation smoothing for the w8a8 mode (counterpart of
``vla_fastvlm_tpu/io/smooth.py``).

w8a8 quantizes each projection's input per token, and one outlier channel
inflates every token's scale. Smoothing moves the outliers into the
weights, where per-row weight scales absorb them, without changing the
float model:

    rms_norm(x, g) @ W^T  ==  rms_norm(x, g / s) @ (W * s)^T   (W's input columns)

with ``s = a^alpha / w^(1 - alpha)`` per input channel (``a`` the
calibrated activation absmax, ``w`` the weight absmax). Sites, as in JAX:
``input_layernorm`` -> ``qkv_proj`` (one ``s`` from the fused weight, the
maximum over q, k and v), ``post_attention_layernorm`` -> ``gate_up_proj``,
and optionally the final ``norm`` -> an untied ``lm_head`` (off by
default: it keeps the logits but not the hidden states that the policy
pools; a tied model refuses it).

Usage, on the float model before ``io/quantize.py::quantize_params``::

    calib = collect_norm_absmax(model, images, ids, mask)
    smooth_params_w8a8(model, calib, alpha=0.5)
    quantize_params(model, mode="w8a8")
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..models.layers import Dense
from ..models.qwen2 import Qwen2Model


def _find_decoder(model: torch.nn.Module) -> Qwen2Model:
    found = [m for m in model.modules() if isinstance(m, Qwen2Model)]
    if len(found) != 1:
        raise ValueError(f"expected exactly one Qwen2 decoder in the model, found {len(found)}")
    return found[0]


@torch.no_grad()
def collect_norm_absmax(model: torch.nn.Module, *args, **kwargs) -> Dict[str, torch.Tensor]:
    """Per-channel absmax of the RMSNorm outputs at the smoothing sites over
    one forward ``model(*args, **kwargs)`` (a ``FastVLM``,
    ``Qwen2ForCausalLM`` or ``Qwen2Model``): ``{"attn": (L, H), "mlp": (L,
    H), "final": (H,)}`` float32 on the model's device. Padded positions
    count, as in JAX: calibrate on unpadded prompts where possible."""
    decoder = _find_decoder(model)
    seen: Dict[str, torch.Tensor] = {}
    sites = {"final": decoder.norm}
    for i, layer in enumerate(decoder.layers):
        sites[f"attn{i}"] = layer.input_layernorm
        sites[f"mlp{i}"] = layer.post_attention_layernorm

    def hook(name):
        def record(_module, _inputs, out):
            seen[name] = out.detach().float().abs().flatten(0, -2).amax(dim=0)
        return record

    handles = [m.register_forward_hook(hook(name)) for name, m in sites.items()]
    try:
        model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    n = len(decoder.layers)
    return {"attn": torch.stack([seen[f"attn{i}"] for i in range(n)]),
            "mlp": torch.stack([seen[f"mlp{i}"] for i in range(n)]), "final": seen["final"]}


def _smooth_scales(act_absmax: torch.Tensor, weight_absmax: torch.Tensor, alpha: float) -> torch.Tensor:
    """``s = a^alpha / w^(1 - alpha)``; 1 where the calibration saw nothing; clipped to [1e-4, 1e4]."""
    a = act_absmax.float()
    w = weight_absmax.float().clamp_min(1e-8)
    s = a.clamp_min(1e-8).pow(alpha) / w.pow(1.0 - alpha)
    return torch.where(a > 0, s, torch.ones_like(s)).clamp(1e-4, 1e4)


def _smooth_site(norm_weight: torch.nn.Parameter, dense: torch.nn.Module, act_absmax, alpha: float) -> None:
    if not isinstance(dense, Dense):
        raise TypeError(f"smoothing needs the float weights: {type(dense).__name__} is quantized; smooth first")
    w = dense.weight
    s = _smooth_scales(torch.as_tensor(act_absmax, device=w.device), w.detach().float().abs().amax(dim=0), alpha)
    norm_weight.copy_((norm_weight.float() / s).to(norm_weight.dtype))
    w.copy_((w.float() * s).to(w.dtype))


@torch.no_grad()
def smooth_params_w8a8(model: torch.nn.Module, calib: Mapping, alpha: float = 0.5,
                       include_lm_head: bool = False) -> torch.nn.Module:
    """Fold activation outliers into the weights of ``model`` in place
    (float-identical) and return it. ``calib`` is ``collect_norm_absmax``'s
    (tensors or JAX's numpy arrays)."""
    decoder = _find_decoder(model)
    for i, layer in enumerate(decoder.layers):
        _smooth_site(layer.input_layernorm.weight, layer.self_attn.qkv_proj, calib["attn"][i], alpha)
        _smooth_site(layer.post_attention_layernorm.weight, layer.mlp.gate_up_proj, calib["mlp"][i], alpha)
    if include_lm_head:
        owner = next((m for m in model.modules() if decoder in m.children() and hasattr(m, "lm_head")), None)
        if owner is None:
            raise ValueError("include_lm_head=True but the model has no lm_head (tied embeddings compute logits "
                             "through the embedding table, which is also the input lookup and cannot be smoothed)")
        _smooth_site(decoder.norm.weight, owner.lm_head, calib["final"], alpha)
    return model
