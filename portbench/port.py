"""The program under test as the harness builds it: configurations of the
port (``vla_fastvlm_tpu_torch``) from a benchmark configuration, and the
benchmark's seeded weights loaded into the port's modules.

The port stores q/k/v as one ``qkv_proj`` and gate/up as one
``gate_up_proj``; the seeded weights keep them apart, so they are joined
here, group by group, as the port's own checkpoint loader joins a
published checkpoint's.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

from .reference.config import ModelCfg
from .reference.weights import iter_weights

_FUSED = (("self_attn.qkv_proj", ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")),
          ("mlp.gate_up_proj", ("mlp.gate_proj", "mlp.up_proj")))


def join_names(names) -> Dict[str, List[str]]:
    """Port leaf name -> the seeded leaves it holds, in order."""
    out = {n: [n] for n in names}
    for fused, parts in _FUSED:
        for suffix in (".weight", ".bias"):
            for prefix in [n[: -len(parts[0] + suffix)] for n in out if n.endswith(parts[0] + suffix)]:
                out[prefix + fused + suffix] = [out.pop(prefix + p + suffix)[0] for p in parts]
    return out


def port_leaves(group: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One seeded group under the port's names, the fused leaves joined."""
    return {name: torch.cat([group[p] for p in parts]) if len(parts) > 1 else group[parts[0]]
            for name, parts in join_names(group).items()}


def fastvlm_state(cfg: ModelCfg, seed: int, device, dtype: torch.dtype) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every FastVLM leaf (no action head) under the port's names, in ``dtype``."""
    for group, leaves in iter_weights(cfg, seed, device):
        if group == "head":
            continue
        for name, t in port_leaves(leaves).items():
            yield name, t.to(dtype)


def head_state(cfg: ModelCfg, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    for _, leaves in iter_weights(cfg, seed, device, prefix="head"):
        return {name[len("head."):]: t.to(dtype) for name, t in leaves.items()}
    raise ValueError(f"{cfg.name} has no action head")


def fastvlm_config(cfg: ModelCfg, image_size: int, dtype: torch.dtype, param_dtype: torch.dtype, **text_kw):
    """The port's ``FastVLMConfig`` of a benchmark configuration."""
    from vla_fastvlm_tpu_torch.models.fastvit import FastViTHDConfig
    from vla_fastvlm_tpu_torch.models.fastvlm import FastVLMConfig
    from vla_fastvlm_tpu_torch.models.qwen2 import Qwen2Config

    t, v = cfg.text, cfg.vision
    text = Qwen2Config(vocab_size=t.vocab_size, hidden_size=t.hidden_size, num_hidden_layers=t.num_hidden_layers,
                       num_attention_heads=t.num_attention_heads, num_key_value_heads=t.num_key_value_heads,
                       intermediate_size=t.intermediate_size, rope_theta=t.rope_theta, rms_norm_eps=t.rms_norm_eps,
                       tie_word_embeddings=t.tie_word_embeddings, dtype=dtype, param_dtype=param_dtype, **text_kw)
    vision = FastViTHDConfig(embed_dims=v.embed_dims, depths=v.depths, token_mixers=v.token_mixers,
                             mlp_ratios=v.mlp_ratios, pos_embs=v.pos_embs, attn_head_dim=v.attn_head_dim,
                             final_expand_ratio=v.final_expand_ratio, dtype=dtype, param_dtype=param_dtype)
    return FastVLMConfig(vision=vision, text=text, image_size=image_size)


def check_same_shapes(port_cfg, cfg: ModelCfg) -> None:
    """Raise unless the port's model config has the benchmark config's sizes
    (a policy built from a preset name takes the preset's)."""
    want = fastvlm_config(cfg, port_cfg.image_size, port_cfg.text.dtype, port_cfg.text.param_dtype)
    for part in ("text", "vision"):
        got, expect = getattr(port_cfg, part), getattr(want, part)
        for f in ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
                  "intermediate_size", "rope_theta", "rms_norm_eps", "tie_word_embeddings", "embed_dims", "depths",
                  "token_mixers", "mlp_ratios", "pos_embs", "attn_head_dim", "final_expand_ratio"):
            if hasattr(expect, f) and getattr(got, f) != getattr(expect, f):
                raise ValueError(f"the port's {part} {f} is {getattr(got, f)}, {cfg.name} has {getattr(expect, f)}")


def build_fastvlm(cfg: ModelCfg, seed: int, device, image_size: int, dtype: torch.dtype):
    """A port ``FastVLM`` holding the seeded weights, built on ``meta`` and
    given the weights by assignment (no second copy, no init of its own)."""
    from vla_fastvlm_tpu_torch.models.fastvlm import FastVLM

    with torch.device("meta"):
        model = FastVLM(fastvlm_config(cfg, image_size, dtype, dtype))
    model.load_state_dict(dict(fastvlm_state(cfg, seed, device, dtype)), strict=True, assign=True)
    return model.eval().requires_grad_(False)


def load_policy_weights(policy, cfg: ModelCfg, seed: int) -> None:
    """Copy the seeded weights into a port ``FastVLAPolicy`` (its backbone
    and head), in the dtype its parameters have."""
    backbone = policy.model.backbone.model
    check_same_shapes(policy.model.backbone.model_config, cfg)
    dtype = next(backbone.parameters()).dtype
    with torch.no_grad():
        backbone.load_state_dict(dict(fastvlm_state(cfg, seed, policy.device, dtype)), strict=True)
        policy.model.head.load_state_dict(head_state(cfg, seed, policy.device, dtype), strict=True)
