"""Seeded weights of a configuration, in groups that can be made one at a time.

Every leaf has a name, a shape and a kind. A group (the stem, one tower
block, one decoder layer, the embedding, the head ...) is made by one
``torch.randn`` call from a generator seeded by the run's seed and the
group's name, on the device asked for, then each leaf is scaled in place and
rounded to bfloat16. So the program's set-up and the reference after the
window make the same values, and the reference can remake one decoder layer
at a time.

Kinds: ``w`` a product's weight, N(0, 1 / fan_in); ``dirac`` a depthwise
kernel that replaces its input (FastViT's reparameterized mixer and
positional conv): the identity tap plus N(0, 0.09 / fan_in); ``b`` a bias,
N(0, 0.02^2); ``g`` a norm's scale, 1 + N(0, 0.1^2); ``ls`` a layer scale,
N(0, 0.1^2); ``e`` an embedding table, N(0, 1 / width).

Names follow the port's module tree, with q/k/v and gate/up as separate
leaves (the published checkpoints' layout); ``head.*`` is the action head.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, List, Tuple

import torch

from .config import ModelCfg

Leaf = Tuple[str, Tuple[int, ...], str, int]  # name, shape, kind, fan_in


def _tower_groups(cfg: ModelCfg) -> List[Tuple[str, List[Leaf]]]:
    v = cfg.vision
    d0 = v.embed_dims[0]
    p = "vision_tower."
    groups = [(p + "stem", [
        (p + "stem_0.conv.weight", (d0, 3, 3, 3), "w", 27), (p + "stem_0.conv.bias", (d0,), "b", 0),
        (p + "stem_1.conv.weight", (d0, 1, 3, 3), "w", 9), (p + "stem_1.conv.bias", (d0,), "b", 0),
        (p + "stem_2.conv.weight", (d0, d0), "w", d0), (p + "stem_2.conv.bias", (d0,), "b", 0),
    ])]
    prev = d0
    for s, (c, depth, mixer, ratio, cpe) in enumerate(zip(v.embed_dims, v.depths, v.token_mixers, v.mlp_ratios,
                                                          v.pos_embs)):
        if s > 0:
            g = math.gcd(prev, c)
            q = f"{p}patch_embed_{s}."
            groups.append((q[:-1], [
                (q + "large_kernel.conv.weight", (c, prev // g, 7, 7), "w", 49 * prev // g),
                (q + "large_kernel.conv.bias", (c,), "b", 0),
                (q + "pointwise.conv.weight", (c, c), "w", c), (q + "pointwise.conv.bias", (c,), "b", 0),
            ]))
        if cpe:
            q = f"{p}pos_emb_{s}."
            groups.append((q[:-1], [(q + "conv.weight", (c, 1, 7, 7), "dirac", 49), (q + "conv.bias", (c,), "b", 0)]))
        f = int(c * ratio)
        for i in range(depth):
            q = f"{p}stage{s}_block{i}."
            ffn = [
                (q + "convffn.dw.conv.weight", (c, 1, 7, 7), "w", 49), (q + "convffn.dw.conv.bias", (c,), "b", 0),
                (q + "convffn.fc1.conv.weight", (f, c), "w", c), (q + "convffn.fc1.conv.bias", (f,), "b", 0),
                (q + "convffn.fc2.conv.weight", (c, f), "w", f), (q + "convffn.fc2.conv.bias", (c,), "b", 0),
            ]
            if mixer == "repmixer":
                leaves = [(q + "token_mixer.conv.weight", (c, 1, 3, 3), "dirac", 9),
                          (q + "token_mixer.conv.bias", (c,), "b", 0), *ffn,
                          (q + "layer_scale.gamma", (c,), "ls", 0)]
            elif mixer == "attention":
                leaves = [(q + "norm.weight", (c,), "g", 0), (q + "norm.bias", (c,), "b", 0),
                          (q + "token_mixer.qkv.weight", (3 * c, c), "w", c),
                          (q + "token_mixer.proj.weight", (c, c), "w", c), (q + "token_mixer.proj.bias", (c,), "b", 0),
                          (q + "layer_scale_1.gamma", (c,), "ls", 0), *ffn, (q + "layer_scale_2.gamma", (c,), "ls", 0)]
            else:
                raise ValueError(f"unknown token mixer {mixer!r}")
            groups.append((q[:-1], leaves))
        prev = c
    out = v.out_channels
    # A grouped 3x3 conv, one group per input channel (groups = embed_dims[-1]).
    groups.append((p + "conv_exp", [(p + "conv_exp.conv.weight", (out, 1, 3, 3), "w", 9),
                                     (p + "conv_exp.conv.bias", (out,), "b", 0)]))
    return groups


def weight_groups(cfg: ModelCfg) -> List[Tuple[str, List[Leaf]]]:
    """Every group of ``cfg``'s weights, tower first, in a fixed order."""
    t = cfg.text
    h, d = t.hidden_size, t.head_dim
    groups = _tower_groups(cfg)
    groups.append(("mm_projector", [
        ("mm_projector.fc1.weight", (h, cfg.mm_hidden_size), "w", cfg.mm_hidden_size),
        ("mm_projector.fc1.bias", (h,), "b", 0),
        ("mm_projector.fc2.weight", (h, h), "w", h), ("mm_projector.fc2.bias", (h,), "b", 0),
    ]))
    groups.append(("language_model.embed_tokens", [("language_model.embed_tokens.weight", (t.vocab_size, h), "e", h)]))
    n, k, i_ = t.num_attention_heads * d, t.num_key_value_heads * d, t.intermediate_size
    for layer in range(t.num_hidden_layers):
        q = f"language_model.layers.{layer}."
        groups.append((q[:-1], [
            (q + "input_layernorm.weight", (h,), "g", 0),
            (q + "self_attn.q_proj.weight", (n, h), "w", h), (q + "self_attn.q_proj.bias", (n,), "b", 0),
            (q + "self_attn.k_proj.weight", (k, h), "w", h), (q + "self_attn.k_proj.bias", (k,), "b", 0),
            (q + "self_attn.v_proj.weight", (k, h), "w", h), (q + "self_attn.v_proj.bias", (k,), "b", 0),
            (q + "self_attn.o_proj.weight", (h, n), "w", n),
            (q + "post_attention_layernorm.weight", (h,), "g", 0),
            (q + "mlp.gate_proj.weight", (i_, h), "w", h), (q + "mlp.up_proj.weight", (i_, h), "w", h),
            (q + "mlp.down_proj.weight", (h, i_), "w", i_),
        ]))
    groups.append(("language_model.norm", [("language_model.norm.weight", (h,), "g", 0)]))
    if not t.tie_word_embeddings:
        groups.append(("lm_head", [("lm_head.weight", (t.vocab_size, h), "w", h)]))
    if cfg.head is not None:
        a = cfg.head
        groups.append(("head", [
            ("head.state_norm.weight", (a.state_dim,), "g", 0), ("head.state_norm.bias", (a.state_dim,), "b", 0),
            ("head.state_proj.weight", (a.hidden_dim, a.state_dim), "w", a.state_dim),
            ("head.state_proj.bias", (a.hidden_dim,), "b", 0),
            ("head.fusion_fc1.weight", (a.fusion_dim, h + a.hidden_dim), "w", h + a.hidden_dim),
            ("head.fusion_fc1.bias", (a.fusion_dim,), "b", 0),
            ("head.fusion_norm.weight", (a.fusion_dim,), "g", 0), ("head.fusion_norm.bias", (a.fusion_dim,), "b", 0),
            ("head.fusion_fc2.weight", (a.fusion_dim, a.fusion_dim), "w", a.fusion_dim),
            ("head.fusion_fc2.bias", (a.fusion_dim,), "b", 0),
            ("head.action_head.weight", (a.action_dim, a.fusion_dim), "w", a.fusion_dim),
            ("head.action_head.bias", (a.action_dim,), "b", 0),
        ]))
    return groups


def group_seed(seed: int, group: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def make_group(seed: int, group: str, leaves: List[Leaf], device) -> Dict[str, torch.Tensor]:
    """One group's leaves as bfloat16 tensors on ``device`` (or empty meta
    tensors on ``meta``)."""
    device = torch.device(device)
    if device.type == "meta":
        return {name: torch.empty(shape, dtype=torch.bfloat16, device=device) for name, shape, _, _ in leaves}
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, group))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, shape, kind, fan_in in leaves:
        n = math.prod(shape)
        x = z[offset: offset + n].view(shape)
        offset += n
        if kind in ("w", "e"):
            x.mul_(fan_in ** -0.5)
        elif kind == "dirac":
            x.mul_(0.3 * fan_in ** -0.5)
            x[:, 0, shape[2] // 2, shape[3] // 2] += 1.0
        elif kind == "b":
            x.mul_(0.02)
        elif kind == "g":
            x.mul_(0.1).add_(1.0)
        elif kind == "ls":
            x.mul_(0.1)
        else:
            raise ValueError(f"unknown leaf kind {kind!r}")
        out[name] = x.to(torch.bfloat16)
    return out


def iter_weights(cfg: ModelCfg, seed: int, device, prefix: str = "") -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    """``(group, leaves)`` for every group whose name starts with ``prefix``."""
    for group, leaves in weight_groups(cfg):
        if group.startswith(prefix):
            yield group, make_group(seed, group, leaves, device)


class Weights:
    """Float32 views of a configuration's seeded weights, made group by group
    on first use; ``drop(prefix)`` frees the groups made so far under it."""

    def __init__(self, cfg: ModelCfg, seed: int, device) -> None:
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self._groups = {g: leaves for g, leaves in weight_groups(cfg)}
        self._owner = {name: g for g, leaves in self._groups.items() for name, _, _, _ in leaves}
        self._made: Dict[str, Dict[str, torch.Tensor]] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        group = self._owner[name]
        if group not in self._made:
            made = make_group(self.seed, group, self._groups[group], self.device)
            self._made[group] = {k: v.float() for k, v in made.items()}
        return self._made[group][name]

    def names(self, prefix: str = ""):
        return [n for n in self._owner if n.startswith(prefix)]

    def drop(self, prefix: str = "") -> None:
        """Free the made groups named ``prefix`` or under ``prefix.``."""
        for group in [g for g in self._made if not prefix or g == prefix or g.startswith(prefix + ".")]:
            del self._made[group]
