"""The port's config resolution for local HF-layout directories against the
JAX package's ``io/model_loader.py``, on the CPU.

``resolve_fastvlm_config`` on ``config.json`` directories written here
(nothing is downloaded) gives JAX's config field for field, dtypes by name,
and JAX's raw dict; the same errors for a directory without ``config.json``
or of another ``model_type``. The tower-name parser on JAX's cases. A
backbone built from such a directory resolves JAX's image size, warns that
its weights are random and runs a forward; one with ``*.safetensors``
loads them (``tests/test_torch_hf_weights.py`` holds the loader against
JAX).
"""

import dataclasses
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.io import model_loader as jloader
from vla_fastvlm_tpu.model.fastvlm_adapter import FastVLMBackbone as JBackbone
from vla_fastvlm_tpu.model.fastvlm_adapter import FastVLMBackboneConfig as JBackboneConfig
from vla_fastvlm_tpu_torch.io import presets
from vla_fastvlm_tpu_torch.io.checkpoint import save_safetensors
from vla_fastvlm_tpu_torch.model import FastVLMBackbone, FastVLMBackboneConfig

TINY_FIELDS = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
               "intermediate_size": 128, "vocab_size": 512}
FULL_FIELDS = dict(TINY_FIELDS, rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
                   max_position_embeddings=4096)


def _write(path, config):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config))
    return str(path)


def _fields(cfg):
    """A config as a flat dict, dtypes by name."""

    def name(value):
        if isinstance(value, torch.dtype):
            return str(value).removeprefix("torch.")
        try:
            return np.dtype(value).name
        except TypeError:
            return value

    out = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            out.update({f"{f.name}.{k}": v for k, v in _fields(value).items()})
        else:
            out[f.name] = value if isinstance(value, (str, int, float, bool, tuple, type(None))) else name(value)
    return out


def _both(model_id, bootstrap, dtype="float32"):
    j = jloader.resolve_fastvlm_config(model_id, bootstrap_model_id=bootstrap, dtype=getattr(jnp, dtype))
    t = presets.resolve_fastvlm_config(model_id, bootstrap_model_id=bootstrap, dtype=getattr(torch, dtype))
    return j, t


CASES = {
    "llava_qwen2 with fields": (dict(FULL_FIELDS, model_type="llava_qwen2", mm_vision_tower="mobileclip_l_768"),
                                "fastvlm-tiny"),
    "llava_qwen2 from a preset": ({"model_type": "llava_qwen2"}, "fastvlm-1.5b"),
    "llava_qwen2 from a directory": ({"model_type": "llava_qwen2", "vision_tower": "vit-base-patch16-224"}, "boot"),
    "llava_qwen2, no tower name": ({"model_type": "llava_qwen2", "hidden_size": 64}, "fastvlm-tiny"),
    "qwen2 text-only": (dict(TINY_FIELDS, model_type="qwen2"), "fastvlm-tiny"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_directory_config_matches_jax(case, dtype, tmp_path):
    config, bootstrap = CASES[case]
    if bootstrap == "boot":  # a bootstrap directory's fields are the defaults
        bootstrap = _write(tmp_path / "boot", dict(TINY_FIELDS, model_type="llava_qwen2", vocab_size=640))
    path = _write(tmp_path / "model", config)
    (jcfg, jraw), (tcfg, traw) = _both(path, bootstrap, dtype)
    assert traw == jraw == config
    assert _fields(tcfg) == _fields(jcfg)
    assert _fields(tcfg)["text.dtype"] == dtype
    if case == "qwen2 text-only":
        assert tcfg.image_token_mode == "none" and tcfg.num_image_tokens == 0


def test_presets_match_jax():
    for model_id in ("fastvlm-tiny", "apple/FastVLM-0.5B", "fastvlm-7b"):
        (jcfg, jraw), (tcfg, traw) = _both(model_id, "apple/FastVLM-0.5B")
        assert traw is None and jraw is None
        assert _fields(tcfg) == _fields(jcfg)


@pytest.mark.parametrize("config,match", [(None, "must contain config.json"),
                                          ({"model_type": "llama"}, "model_type is not\\s+llava_qwen2")])
def test_directory_errors_match_jax(config, match, tmp_path):
    path = _write(tmp_path, config) if config is not None else str(tmp_path)
    with pytest.raises(RuntimeError, match=match) as jerr:
        jloader.resolve_fastvlm_config(path)
    with pytest.raises(RuntimeError, match=match) as terr:
        presets.resolve_fastvlm_config(path)
    assert str(terr.value) == str(jerr.value)


def test_unknown_id_raises():
    with pytest.raises(ValueError, match="Unknown model_id"):
        presets.resolve_fastvlm_config("not-a-model")


@pytest.mark.parametrize("name", ["mobileclip_l_1024", "openai/clip-vit-large-patch14-336",
                                  "siglip-so400m-patch14-384", "vit-base-patch16-224", "tower-48", "so400m",
                                  "no-numbers-here", None, 123, "mobileclip_l_768", "clip_336_base_m"])
def test_tower_name_matches_jax(name):
    assert presets.infer_size_from_tower_name(name) == jloader.infer_size_from_tower_name(name)


SIZE_LAYOUTS = {
    "tower name": ({"mm_vision_tower": "mobileclip_l_128"}, None),
    "vision_config": ({"vision_config": {"image_size": [96, 96]}}, None),
    "preprocessor": ({}, {"size": {"height": 80, "width": 80}}),
    "fallback": ({}, None),
}


@pytest.mark.parametrize("layout", sorted(SIZE_LAYOUTS))
def test_backbone_image_size_matches_jax(layout, tmp_path):
    extra, processor = SIZE_LAYOUTS[layout]
    path = _write(tmp_path, dict(TINY_FIELDS, model_type="llava_qwen2", **extra))
    if processor is not None:
        (tmp_path / "preprocessor_config.json").write_text(json.dumps(processor))
    kw = dict(model_id=path, bootstrap_model_id="fastvlm-tiny", fallback_image_size=112, tokenizer_max_length=8)
    # JAX's own priority chain, without building its backbone.
    jbackbone = JBackbone.__new__(JBackbone)
    jbackbone.config = JBackboneConfig(**kw)
    jbackbone.model_config, jbackbone._raw_hf_config = jloader.resolve_fastvlm_config(path, "fastvlm-tiny")
    jsize = jbackbone._resolve_expected_image_size()
    backbone = FastVLMBackbone(FastVLMBackboneConfig(**kw), device="meta")
    assert backbone.expected_size == jsize == backbone.model_config.image_size


def test_force_image_size_below_the_tower_raises(tmp_path):
    path = _write(tmp_path, dict(TINY_FIELDS, model_type="llava_qwen2", mm_vision_tower="mobileclip_l_128"))
    with pytest.raises(ValueError, match="too small"):
        FastVLMBackbone(FastVLMBackboneConfig(model_id=path, force_image_size=64), device="meta")


def test_backbone_from_a_directory_runs(tmp_path, caplog):
    path = _write(tmp_path, dict(TINY_FIELDS, model_type="llava_qwen2", mm_vision_tower="mobileclip_l_64"))
    with caplog.at_level(logging.WARNING):
        backbone = FastVLMBackbone(FastVLMBackboneConfig(model_id=path, bootstrap_model_id="fastvlm-tiny",
                                                         tokenizer_max_length=8), device="cpu")
    assert any("No *.safetensors found" in r.getMessage() and "randomly initialized" in r.getMessage()
               for r in caplog.records)
    assert backbone.expected_size == 64 and backbone.output_dim == 64
    images = np.random.default_rng(0).random((2, 3, 48, 64), dtype=np.float32)
    feats = backbone.forward(images, ["pick\n", "place\n"], device="cpu")
    assert tuple(feats.shape) == (2, 64) and bool(torch.isfinite(feats).all())


def test_directory_with_safetensors_raises(tmp_path):
    """A shard that is not a safetensors file raises, naming it; once it
    holds the checkpoint, the directory loads (``io/model_loader.py``):
    the decoder's leaves land, fused, over the seeded init."""
    path = _write(tmp_path, dict(TINY_FIELDS, model_type="llava_qwen2"))
    (tmp_path / "model.safetensors").write_bytes(b"")
    kw = dict(model_id=path, bootstrap_model_id="fastvlm-tiny", tokenizer_max_length=8)
    with pytest.raises(ValueError, match="model.safetensors: 0 bytes"):
        FastVLMBackbone(FastVLMBackboneConfig(**kw), device="cpu")
    rng = np.random.default_rng(1)
    base = FastVLMBackbone(FastVLMBackboneConfig(model_id="fastvlm-tiny", tokenizer_max_length=8), device="cpu")
    hf = {"model.embed_tokens.weight": rng.standard_normal((512, 64)).astype(np.float32),
          "model.norm.weight": np.ones(64, np.float32)}
    for name, value in base.model.language_model.state_dict().items():
        if name.startswith("layers."):
            for part, piece in zip(*_hf_parts(name, value)):
                hf["model." + part] = rng.standard_normal(tuple(piece.shape)).astype(np.float32)
    save_safetensors(hf, tmp_path / "model.safetensors")
    backbone = FastVLMBackbone(FastVLMBackboneConfig(**kw), device="cpu")
    state = backbone.model.state_dict()
    assert torch.equal(state["language_model.embed_tokens.weight"], torch.from_numpy(hf["model.embed_tokens.weight"]))
    qkv = np.concatenate([hf[f"model.layers.1.self_attn.{p}_proj.weight"] for p in "qkv"])
    assert torch.equal(state["language_model.layers.1.self_attn.qkv_proj.weight"], torch.from_numpy(qkv))
    assert torch.equal(state["vision_tower.stem_0.conv.weight"], base.model.state_dict()["vision_tower.stem_0.conv.weight"])
    feats = backbone.forward(np.zeros((1, 3, 64, 64), np.float32), ["pick\n"], device="cpu")
    assert tuple(feats.shape) == (1, 64) and bool(torch.isfinite(feats).all())


def _hf_parts(name, value):
    """The port's decoder leaf ``layers.<i>.*`` -> its HF names and pieces."""
    fused = {"qkv_proj": ("q_proj", "k_proj", "v_proj"), "gate_up_proj": ("gate_proj", "up_proj")}
    owner = name.split(".")[-2]
    if owner not in fused:
        return [name], [value]
    sizes = [64, 32, 32] if owner == "qkv_proj" else [value.shape[0] // 2] * 2  # qwen2_tiny: 4 + 2 + 2 heads of 16
    return [name.replace(owner, part) for part in fused[owner]], list(value.split(sizes))
