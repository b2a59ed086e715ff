"""Apple FastViTHD checkpoint -> the port's fused vision tower (the port's
copy of ``vla_fastvlm_tpu/io/vision_convert.py``).

The llava_qwen2 checkpoints carry the vision tower under
``model.vision_tower.vision_tower.model.*`` in the ml-fastvlm/MobileCLIP
module layout, mapped onto the port's ``FastViTHD`` names:

    patch_embed.{0,1,2}          stem MobileOneBlocks        -> stem_0/1/2
    network.{i}                  interleaved list per stage:
        PatchEmbed(proj.0 = ReparamLargeKernelConv, proj.1 = MobileOneBlock)
                                                             -> patch_embed_s
        RepCPE                   (attention stages)          -> pos_emb_s
        Sequential(blocks)       RepMixerBlock | AttentionBlock
                                                             -> stage{s}_block{b}
    conv_exp                     MobileOneBlock              -> conv_exp

Both storage modes are read:
- train mode, multi-branch (``rbr_conv/rbr_scale/rbr_skip``, RepMixer
  ``norm``/``mixer``/``layer_scale``, RepLKC ``lkb_origin`` +
  ``small_conv``, the ConvFFN's ``conv.conv`` + ``conv.bn``), folded in
  float32 with ``io/reparam.py``;
- inference mode, fused (``reparam_conv``, ``lkb_reparam``): copies.

The fold math is exact; the name mapping is the JAX package's
reconstruction of Apple's public layout and is not yet checked against a
real Apple checkpoint. An unmatched name raises ``KeyError`` with JAX's
message, and the loader then keeps a random tower with JAX's warning
(``io/model_loader.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..models.fastvit import FastViTHDConfig
from .reparam import bn_to_affine, fuse_large_kernel_conv, fuse_mobileone_block, fuse_repcpe, fuse_repmixer
from .weights import as_tensor, fold_conv_bn

DEFAULT_PREFIX = "model.vision_tower.vision_tower.model."

_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


class _Src:
    """Name-indexed float32 access into the checkpoint's tower names."""

    def __init__(self, state: Mapping, prefix: str) -> None:
        self.state = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}

    def has(self, name: str) -> bool:
        return name in self.state

    def get(self, name: str) -> torch.Tensor:
        if name not in self.state:
            raise KeyError(f"vision tower param not found: {name!r}")
        return as_tensor(self.state[name], torch.float32)

    def bn(self, base: str) -> dict:
        return {k: self.get(f"{base}.{k}") for k in _BN_KEYS}

    def maybe_bn(self, base: str) -> Optional[dict]:
        return self.bn(base) if self.has(f"{base}.weight") else None


def _mobileone_fused(src: _Src, base: str, kernel: int, out_ch: int, groups: int):
    """MobileOneBlock -> fused (w, b), from either storage mode."""
    if src.has(f"{base}.reparam_conv.weight"):
        return src.get(f"{base}.reparam_conv.weight"), src.get(f"{base}.reparam_conv.bias")
    conv_branches = []
    j = 0
    while src.has(f"{base}.rbr_conv.{j}.conv.weight"):
        conv_branches.append((src.get(f"{base}.rbr_conv.{j}.conv.weight"), src.bn(f"{base}.rbr_conv.{j}.bn")))
        j += 1
    scale = None
    if src.has(f"{base}.rbr_scale.conv.weight"):
        scale = (src.get(f"{base}.rbr_scale.conv.weight"), src.bn(f"{base}.rbr_scale.bn"))
    skip = src.maybe_bn(f"{base}.rbr_skip")
    if not conv_branches and scale is None and skip is None:
        raise KeyError(f"no MobileOne branches found under {base!r}")
    return fuse_mobileone_block(conv_branches, scale, skip, kernel, out_ch, groups)


def _conv_act(name: str, w: torch.Tensor, b: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A ``ConvAct``'s leaves: a pointwise ungrouped conv is a ``Dense``
    (O, I) in the port (a depthwise 1x1, I/g == 1, stays a conv)."""
    o, i, kh, kw = w.shape
    if (kh, kw) == (1, 1) and i != 1:
        w = w[:, :, 0, 0]
    return {f"{name}.conv.weight": w, f"{name}.conv.bias": b}


def _repmixer_fused(src: _Src, base: str, dim: int, name: str) -> Dict[str, torch.Tensor]:
    """RepMixer -> the port's ``RepDWConv`` (replacement conv with identity)."""
    if src.has(f"{base}.reparam_conv.weight"):
        return _conv_act(name, src.get(f"{base}.reparam_conv.weight"), src.get(f"{base}.reparam_conv.bias"))
    mixer_w, mixer_b = _mobileone_fused(src, f"{base}.mixer", 3, dim, dim)
    norm_w, norm_b = _mobileone_fused(src, f"{base}.norm", 3, dim, dim)
    ls = None
    for ls_name in (f"{base}.layer_scale", f"{base}.layer_scale.gamma"):
        if src.has(ls_name):
            ls = src.get(ls_name).reshape(-1)
            break
    return _conv_act(name, *fuse_repmixer(norm_w, norm_b, mixer_w, mixer_b, ls, dim, 3))


def _repcpe_fused(src: _Src, base: str, dim: int, name: str) -> Dict[str, torch.Tensor]:
    if src.has(f"{base}.reparam_conv.weight"):
        return _conv_act(name, src.get(f"{base}.reparam_conv.weight"), src.get(f"{base}.reparam_conv.bias"))
    w = src.get(f"{base}.pe.weight") if src.has(f"{base}.pe.weight") else src.get(f"{base}.proj.weight")
    b_name = f"{base}.pe.bias" if src.has(f"{base}.pe.bias") else f"{base}.proj.bias"
    b = src.get(b_name) if src.has(b_name) else torch.zeros(dim, dtype=torch.float32)
    return _conv_act(name, *fuse_repcpe(w, b, dim, w.shape[-1]))


def _large_kernel_fused(src: _Src, base: str) -> tuple:
    if src.has(f"{base}.lkb_reparam.weight"):
        return src.get(f"{base}.lkb_reparam.weight"), src.get(f"{base}.lkb_reparam.bias")
    lkb_w = src.get(f"{base}.lkb_origin.conv.weight")
    lkb_bn = src.bn(f"{base}.lkb_origin.bn")
    small_w = small_bn = None
    if src.has(f"{base}.small_conv.conv.weight"):
        small_w = src.get(f"{base}.small_conv.conv.weight")
        small_bn = src.bn(f"{base}.small_conv.bn")
    return fuse_large_kernel_conv(lkb_w, lkb_bn, small_w, small_bn, lkb_w.shape[-1])


def _convffn(src: _Src, base: str, name: str) -> Dict[str, torch.Tensor]:
    """ConvFFN: conv(dw7x7)+bn -> dw; fc1/fc2 1x1 convs."""
    bn = src.bn(f"{base}.conv.bn")
    conv_b = src.get(f"{base}.conv.conv.bias") if src.has(f"{base}.conv.conv.bias") else None
    dw = fold_conv_bn(src.get(f"{base}.conv.conv.weight"), conv_b, bn["weight"], bn["bias"], bn["running_mean"],
                      bn["running_var"])
    return {**_conv_act(f"{name}.dw", *dw),
            **_conv_act(f"{name}.fc1", src.get(f"{base}.fc1.weight"), src.get(f"{base}.fc1.bias")),
            **_conv_act(f"{name}.fc2", src.get(f"{base}.fc2.weight"), src.get(f"{base}.fc2.bias"))}


def _attention(src: _Src, base: str, name: str) -> Dict[str, torch.Tensor]:
    """Attention: qkv/proj Linears, (out, in) as the port's ``Dense``."""
    out = {f"{name}.qkv.weight": src.get(f"{base}.qkv.weight"),
           f"{name}.proj.weight": src.get(f"{base}.proj.weight"),
           f"{name}.proj.bias": src.get(f"{base}.proj.bias")}
    if src.has(f"{base}.qkv.bias"):
        # The port's SpatialAttention.qkv is bias-free (FastViT uses qkv
        # bias=False): a biased checkpoint is refused, not silently cut.
        if src.get(f"{base}.qkv.bias").abs().max() > 0:
            raise KeyError(f"{base}.qkv.bias present and nonzero; unsupported")
    return out


def _layer_scale(src: _Src, name: str) -> torch.Tensor:
    for candidate in (name, f"{name}.gamma"):
        if src.has(candidate):
            return src.get(candidate).reshape(-1)
    raise KeyError(f"layer scale not found: {name!r}")


def convert_vision_tower(
    state_dict: Mapping,
    cfg: FastViTHDConfig,
    prefix: str = DEFAULT_PREFIX,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """The whole tower -> the port's ``FastViTHD`` state_dict names (see the
    module docstring), folded in float32, then cast to ``dtype``."""
    src = _Src(state_dict, prefix)
    if not src.state:
        raise KeyError(f"no parameters under prefix {prefix!r}")
    out: Dict[str, torch.Tensor] = {}

    # stem: patch_embed.{0,1,2}
    d0 = cfg.embed_dims[0]
    for idx, (kernel, groups, out_ch) in enumerate([(3, 1, d0), (3, d0, d0), (1, 1, d0)]):
        out.update(_conv_act(f"stem_{idx}", *_mobileone_fused(src, f"patch_embed.{idx}", kernel, out_ch, groups)))

    # network walk
    net_idx = 0
    for stage, (dim, depth, mixer, cpe) in enumerate(zip(cfg.embed_dims, cfg.depths, cfg.token_mixers,
                                                          cfg.pos_embs)):
        if stage > 0:
            base = f"network.{net_idx}"
            out.update(_conv_act(f"patch_embed_{stage}.large_kernel", *_large_kernel_fused(src, f"{base}.proj.0")))
            out.update(_conv_act(f"patch_embed_{stage}.pointwise",
                                 *_mobileone_fused(src, f"{base}.proj.1", 1, dim, 1)))
            net_idx += 1
        if cpe:
            out.update(_repcpe_fused(src, f"network.{net_idx}", dim, f"pos_emb_{stage}"))
            net_idx += 1
        for blk in range(depth):
            base = f"network.{net_idx}.{blk}"
            name = f"stage{stage}_block{blk}"
            if mixer == "repmixer":
                out.update(_repmixer_fused(src, f"{base}.token_mixer", dim, f"{name}.token_mixer"))
                out.update(_convffn(src, f"{base}.convffn", f"{name}.convffn"))
                out[f"{name}.layer_scale.gamma"] = _layer_scale(src, f"{base}.layer_scale")
            else:  # attention
                scale, bias = bn_to_affine(src.bn(f"{base}.norm"))
                out[f"{name}.norm.weight"], out[f"{name}.norm.bias"] = scale, bias
                out.update(_attention(src, f"{base}.token_mixer", f"{name}.token_mixer"))
                out[f"{name}.layer_scale_1.gamma"] = _layer_scale(src, f"{base}.layer_scale_1")
                out.update(_convffn(src, f"{base}.convffn", f"{name}.convffn"))
                out[f"{name}.layer_scale_2.gamma"] = _layer_scale(src, f"{base}.layer_scale_2")
        net_idx += 1

    # conv_exp: depthwise-expand MobileOneBlock
    out.update(_conv_act("conv_exp", *_mobileone_fused(src, "conv_exp", 3, cfg.out_channels, cfg.embed_dims[-1])))
    return {k: v.to(dtype).contiguous() for k, v in out.items()}
