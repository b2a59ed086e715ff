"""A configuration file of ``portbench/configs/`` as the reference reads it.

The files keep the keys of the published ``config.json`` (``llava_qwen2``:
the Qwen2 text model's keys at the top level), a ``vision_config`` group for
the FastViTHD tower and, for a policy, an ``action_head`` group.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple


@dataclass(frozen=True)
class TextCfg:
    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    intermediate_size: int
    rope_theta: float
    rms_norm_eps: float
    tie_word_embeddings: bool

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class VisionCfg:
    embed_dims: Tuple[int, ...]
    depths: Tuple[int, ...]
    token_mixers: Tuple[str, ...]
    mlp_ratios: Tuple[float, ...]
    pos_embs: Tuple[bool, ...]
    attn_head_dim: int
    final_expand_ratio: float

    @property
    def out_channels(self) -> int:
        return int(self.embed_dims[-1] * self.final_expand_ratio)

    @property
    def downsample(self) -> int:
        return 4 * 2 ** (len(self.depths) - 1)


@dataclass(frozen=True)
class HeadCfg:
    state_dim: int
    action_dim: int
    hidden_dim: int
    fusion_dim: int
    dropout: float


@dataclass(frozen=True)
class ModelCfg:
    name: str
    dtype: str
    text: TextCfg
    vision: VisionCfg
    mm_hidden_size: int
    head: Optional[HeadCfg]
    tokenizer_max_length: int

    def image_tokens(self, image_size: int) -> int:
        side = image_size // self.vision.downsample
        return side * side


def parse_config(raw: dict) -> ModelCfg:
    text = TextCfg(**{k: raw[k] for k in TextCfg.__dataclass_fields__})
    v = raw["vision_config"]
    vision = VisionCfg(tuple(v["embed_dims"]), tuple(v["depths"]), tuple(v["token_mixers"]),
                       tuple(float(r) for r in v["mlp_ratios"]), tuple(bool(p) for p in v["pos_embs"]),
                       int(v["attn_head_dim"]), float(v["final_expand_ratio"]))
    head = None
    if "action_head" in raw:
        h = raw["action_head"]
        head = HeadCfg(h["state_dim"], h["action_dim"], h["hidden_dim"], h["fusion_dim"], float(h["dropout"]))
    if vision.out_channels != raw["mm_hidden_size"]:
        raise ValueError(f"{raw['name']}: the tower gives {vision.out_channels} channels, "
                         f"mm_hidden_size is {raw['mm_hidden_size']}")
    return ModelCfg(raw["name"], raw.get("torch_dtype", "bfloat16"), text, vision, int(raw["mm_hidden_size"]),
                    head, int(raw.get("tokenizer_max_length", 64)))


def load_config(path) -> ModelCfg:
    return parse_config(json.loads(Path(path).read_text()))
