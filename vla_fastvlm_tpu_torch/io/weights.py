"""HF checkpoint weights -> the port's ``state_dict`` names (the port's copy
of ``vla_fastvlm_tpu/io/weights.py``).

The JAX package transposes HF's ``(out, in)`` Linear weights and OIHW conv
kernels into Flax layouts; the port's modules keep torch layouts, so the
names map straight onto its ``state_dict`` and the only reshaping left is
the fused projections: q/k/v -> one ``qkv_proj`` (q, k, v order) and
gate/up -> one ``gate_up_proj`` (gate, up order), as the weight bridge
fuses them (``io/bridge.py``). Each leaf is cast to ``dtype`` on its own,
so a bf16 checkpoint never exists whole in float32 on the host.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..models.qwen2 import Qwen2Config

# HF suffix under ``layers.<i>.`` -> (the port's name, its parts in fused order).
_LAYER_LEAVES = {
    "input_layernorm.weight": ("input_layernorm.weight", None),
    "post_attention_layernorm.weight": ("post_attention_layernorm.weight", None),
    "self_attn.qkv_proj.weight": (None, ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                                         "self_attn.v_proj.weight")),
    "self_attn.qkv_proj.bias": (None, ("self_attn.q_proj.bias", "self_attn.k_proj.bias", "self_attn.v_proj.bias")),
    "self_attn.o_proj.weight": ("self_attn.o_proj.weight", None),
    "mlp.gate_up_proj.weight": (None, ("mlp.gate_proj.weight", "mlp.up_proj.weight")),
    "mlp.down_proj.weight": ("mlp.down_proj.weight", None),
}


def as_tensor(value: Any, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A CPU tensor (or numpy array) as a CPU tensor, cast to ``dtype``."""
    t = value.detach() if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
    return t if dtype is None else t.to(dtype)


def convert_qwen2_state_dict(
    state_dict: Mapping[str, Any],
    cfg: Qwen2Config,
    prefix: str = "model.",
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """An HF Qwen2(ForCausalLM) state dict -> the port's ``Qwen2ForCausalLM``
    names (``model.*`` and, untied, ``lm_head.weight``).

    ``prefix`` is the HF name prefix of the decoder ("model." for a plain
    Qwen2ForCausalLM; "model." also inside llava_qwen2 checkpoints where the
    decoder lives at the top level next to ``model.vision_tower.*``). A
    missing name raises ``KeyError``, as in JAX.
    """

    def grab(name: str) -> torch.Tensor:
        return as_tensor(state_dict[name], dtype)

    out = {"model.embed_tokens.weight": grab(prefix + "embed_tokens.weight"),
           "model.norm.weight": grab(prefix + "norm.weight")}
    for i in range(cfg.num_hidden_layers):
        base = f"{prefix}layers.{i}."
        for name, (single, parts) in _LAYER_LEAVES.items():
            value = grab(base + single) if parts is None else torch.cat([grab(base + p) for p in parts])
            out[f"model.layers.{i}.{name}"] = value
    if not cfg.tie_word_embeddings and "lm_head.weight" in state_dict:
        out["lm_head.weight"] = grab("lm_head.weight")
    return out


def sqrt_rounded(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, through float64: torch's
    vectorized float32 ``sqrt`` on the CPU is off by an ulp in about one
    value of a hundred, numpy's (the JAX package's folds) is not."""
    return torch.sqrt(x.double()).to(x.dtype)


def fold_conv_bn(
    conv_w: torch.Tensor,  # (O, I/g, kH, kW)
    conv_b: Optional[torch.Tensor],
    bn_gamma: torch.Tensor,
    bn_beta: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    eps: float = 1e-5,
) -> tuple:
    """Fold a BatchNorm into the preceding conv (inference reparameterization).

    Returns (folded_w, folded_b) in the (O, I/g, kH, kW) layout: the
    standard RepVGG/MobileOne fold, w' = w * gamma/sqrt(var+eps),
    b' = beta + (b - mean) * gamma/sqrt(var+eps).
    """
    std = sqrt_rounded(bn_var + eps)
    scale = bn_gamma / std
    folded_w = conv_w * scale[:, None, None, None]
    bias = conv_b if conv_b is not None else torch.zeros_like(bn_mean)
    folded_b = bn_beta + (bias - bn_mean) * scale
    return folded_w, folded_b
