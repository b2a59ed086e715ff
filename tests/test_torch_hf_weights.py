"""HF FastVLM checkpoints in the port against the JAX package, on the CPU.

Synthetic llava_qwen2 directories are written here from numpy seeds (nothing
is downloaded): a Qwen2 decoder and projector under HF names and a
FastViTHD tower in Apple's layout, train mode with every branch kind and
random BatchNorm statistics, or inference mode. At ``fastvithd_tiny`` /
``qwen2_tiny``, in fp32:

- each fold of ``io/reparam.py`` / ``io/weights.py`` against JAX's (1e-6
  abs), and each fused module against its branch sum in torch;
- ``convert_vision_tower`` on train- and inference-mode dicts against
  ``jax_params_to_torch`` of JAX's conversion (copies bit-equal, folds
  within 1e-6 rel.), and JAX's ``KeyError`` messages on unmatched names;
- ``convert_qwen2_state_dict`` tied and untied: logits within 1e-5;
- a directory of two shards, the decoder's in bf16: the backbone's weights
  and features, the policy's actions (head bridged), int8 / int4 codes
  after loading, JAX's warning for a tower that does not convert, a
  decoder-only checkpoint over the init, and ``convert_checkpoint``'s
  output read by JAX's ``load_policy_from_checkpoint``.

JAX's backbone inits through ``jax.eval_shape`` filled with seeded values
(``_torch_parity.random_params``): its compiled init would take most of a
minute, and a full checkpoint overwrites every leaf of it.
"""

import importlib.util
import json
import logging
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vla_fastvlm_tpu.io import reparam as j_reparam
from vla_fastvlm_tpu.io import vision_convert as j_vc
from vla_fastvlm_tpu.io import weights as j_weights
from vla_fastvlm_tpu.model import fastvlm_adapter as j_adapter
from vla_fastvlm_tpu.models.fastvit import fastvithd_tiny as j_tower_cfg
from vla_fastvlm_tpu.models.qwen2 import Qwen2ForCausalLM as JQwen2
from vla_fastvlm_tpu.models.qwen2 import qwen2_tiny as j_qwen2_tiny
from vla_fastvlm_tpu_torch.io import reparam, vision_convert, weights
from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch
from vla_fastvlm_tpu_torch.io.checkpoint import save_safetensors
from vla_fastvlm_tpu_torch.models.fastvit import FastViTHD, fastvithd_tiny
from vla_fastvlm_tpu_torch.models.qwen2 import Qwen2ForCausalLM, qwen2_tiny

from _torch_parity import random_params

P = vision_convert.DEFAULT_PREFIX
TINY_FIELDS = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
               "intermediate_size": 128, "vocab_size": 512}
POLICY = dict(bootstrap_model_name="fastvlm-tiny", state_dim=6, action_dim=5, hidden_dim=16, fusion_dim=16,
              tokenizer_max_length=16)
# Leaves the tower converter copies (no fold): bit-equal to JAX's.
COPIED = (".fc1.", ".fc2.", ".qkv.", ".proj.", ".gamma")


# ---------------------------------------------------------------------------
# synthetic checkpoints (numpy, HF / Apple names)

def _bn(sd, rng, base, c):
    sd[f"{base}.weight"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    sd[f"{base}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    sd[f"{base}.running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    sd[f"{base}.running_var"] = (0.5 + rng.random(c)).astype(np.float32)


def _w(rng, *shape):
    fan_in = int(np.prod(shape[1:]))
    return (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)


def _mobileone(sd, rng, base, out, in_per_group, k, branches=1, scale=True, skip=False):
    """A train-mode MobileOneBlock: ``branches`` k x k conv+BN, a 1x1 scale
    branch, a BN identity skip."""
    for j in range(branches):
        sd[f"{base}.rbr_conv.{j}.conv.weight"] = _w(rng, out, in_per_group, k, k)
        _bn(sd, rng, f"{base}.rbr_conv.{j}.bn", out)
    if scale:
        sd[f"{base}.rbr_scale.conv.weight"] = _w(rng, out, in_per_group, 1, 1)
        _bn(sd, rng, f"{base}.rbr_scale.bn", out)
    if skip:
        _bn(sd, rng, f"{base}.rbr_skip", out)


def _layer_scale(rng, c):
    return (0.1 + 0.05 * rng.standard_normal((c, 1, 1))).astype(np.float32)


def _convffn(sd, rng, base, dim, hidden):
    sd[f"{base}.conv.conv.weight"] = _w(rng, dim, 1, 7, 7)
    _bn(sd, rng, f"{base}.conv.bn", dim)
    sd[f"{base}.fc1.weight"], sd[f"{base}.fc1.bias"] = _w(rng, hidden, dim, 1, 1), _w(rng, hidden, 1)[:, 0]
    sd[f"{base}.fc2.weight"], sd[f"{base}.fc2.bias"] = _w(rng, dim, hidden, 1, 1), _w(rng, dim, 1)[:, 0]


def train_mode_tower(cfg, seed, prefix=P):
    """Apple's train-mode tower names for ``cfg`` with every branch kind."""
    rng = np.random.default_rng(seed)
    sd = {}
    d0 = cfg.embed_dims[0]
    _mobileone(sd, rng, "patch_embed.0", d0, 3, 3, branches=2)
    _mobileone(sd, rng, "patch_embed.1", d0, 1, 3)
    _mobileone(sd, rng, "patch_embed.2", d0, d0, 1, scale=False, skip=True)
    net, prev = 0, d0
    for stage, (dim, depth, mixer, ratio, cpe) in enumerate(
        zip(cfg.embed_dims, cfg.depths, cfg.token_mixers, cfg.mlp_ratios, cfg.pos_embs)
    ):
        if stage > 0:
            g = math.gcd(prev, dim)
            sd[f"network.{net}.proj.0.lkb_origin.conv.weight"] = _w(rng, dim, prev // g, 7, 7)
            _bn(sd, rng, f"network.{net}.proj.0.lkb_origin.bn", dim)
            sd[f"network.{net}.proj.0.small_conv.conv.weight"] = _w(rng, dim, prev // g, 3, 3)
            _bn(sd, rng, f"network.{net}.proj.0.small_conv.bn", dim)
            _mobileone(sd, rng, f"network.{net}.proj.1", dim, dim, 1, scale=False, skip=True)
            net += 1
        if cpe:
            sd[f"network.{net}.pe.weight"] = _w(rng, dim, 1, 7, 7)
            sd[f"network.{net}.pe.bias"] = _w(rng, dim, 1)[:, 0]
            net += 1
        for blk in range(depth):
            base = f"network.{net}.{blk}"
            if mixer == "repmixer":
                _mobileone(sd, rng, f"{base}.token_mixer.norm", dim, 1, 3, branches=0, scale=False, skip=True)
                _mobileone(sd, rng, f"{base}.token_mixer.mixer", dim, 1, 3, skip=True)
                sd[f"{base}.token_mixer.layer_scale"] = _layer_scale(rng, dim)
                sd[f"{base}.layer_scale"] = _layer_scale(rng, dim)
            else:
                _bn(sd, rng, f"{base}.norm", dim)
                sd[f"{base}.token_mixer.qkv.weight"] = _w(rng, 3 * dim, dim)
                sd[f"{base}.token_mixer.proj.weight"] = _w(rng, dim, dim)
                sd[f"{base}.token_mixer.proj.bias"] = _w(rng, dim, 1)[:, 0]
                sd[f"{base}.layer_scale_1"] = _layer_scale(rng, dim)
                sd[f"{base}.layer_scale_2"] = _layer_scale(rng, dim)
            _convffn(sd, rng, f"{base}.convffn", dim, int(dim * ratio))
        net += 1
        prev = dim
    _mobileone(sd, rng, "conv_exp", cfg.out_channels, 1, 3)
    return {prefix + k: v for k, v in sd.items()}


def hf_decoder(cfg, seed, tied=True, projector_in=None):
    """HF llava_qwen2 decoder (+ projector) names for a Qwen2 config."""
    rng = np.random.default_rng(seed)
    h, d = cfg.hidden_size, cfg.resolved_head_dim
    n, kh, f = cfg.num_attention_heads * d, cfg.num_key_value_heads * d, cfg.intermediate_size
    norm = lambda: (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    sd = {"model.embed_tokens.weight": rng.standard_normal((cfg.vocab_size, h)).astype(np.float32),
          "model.norm.weight": norm()}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"], sd[p + "post_attention_layernorm.weight"] = norm(), norm()
        for name, rows in (("q_proj", n), ("k_proj", kh), ("v_proj", kh)):
            sd[p + f"self_attn.{name}.weight"] = _w(rng, rows, h)
            sd[p + f"self_attn.{name}.bias"] = _w(rng, rows, 1)[:, 0]
        sd[p + "self_attn.o_proj.weight"] = _w(rng, h, n)
        sd[p + "mlp.gate_proj.weight"], sd[p + "mlp.up_proj.weight"] = _w(rng, f, h), _w(rng, f, h)
        sd[p + "mlp.down_proj.weight"] = _w(rng, h, f)
    if not tied:
        sd["lm_head.weight"] = _w(rng, cfg.vocab_size, h)
    if projector_in is not None:
        sd["model.mm_projector.0.weight"], sd["model.mm_projector.0.bias"] = _w(rng, h, projector_in), _w(rng, h, 1)[:, 0]
        sd["model.mm_projector.2.weight"], sd["model.mm_projector.2.bias"] = _w(rng, h, h), _w(rng, h, 1)[:, 0]
    return sd


def write_directory(path, shards, tied=True):
    """config.json + one safetensors file per ``(name, dict, dtype)``."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(dict(TINY_FIELDS, model_type="llava_qwen2",
                                                      mm_vision_tower="mobileclip_l_64", tie_word_embeddings=tied)))
    for name, sd, dtype in shards:
        save_safetensors({k: torch.from_numpy(v).to(dtype) for k, v in sd.items()}, path / name)
    return str(path)


def _fast_jax_init(self):
    """JAX's backbone init from ``jax.eval_shape``, seeded (no compile)."""
    return random_params(self._init_shapes(), seed=self.config.seed)


def tensors(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def assert_same_state(got, expect, rel=1e-6, copied=()):
    assert sorted(got) == sorted(expect)
    for k in expect:
        a, b = got[k].float(), expect[k].float()
        assert a.shape == b.shape, k
        if any(c in k for c in copied):
            assert torch.equal(a, b), k
        else:
            torch.testing.assert_close(a, b, rtol=rel, atol=rel * float(b.abs().max()), msg=k)


# ---------------------------------------------------------------------------
# folds

def _rand_bn(rng, c):
    sd = {}
    _bn(sd, rng, "b", c)
    return {k[2:]: v for k, v in sd.items()}


def _fold_cases():
    rng = np.random.default_rng(0)
    c = 6
    bn = _rand_bn(rng, c)
    lk = (_w(rng, c, 2, 7, 7), _rand_bn(rng, c), _w(rng, c, 2, 3, 3), _rand_bn(rng, c), 7)
    return {
        "pad_kernel_to": ((_w(rng, c, 3, 3, 3), 7), {}),
        "identity_kernel": ((c, 3, 5), {}),
        "fold_conv_bn": ((_w(rng, c, 3, 3, 3), _w(rng, c, 1)[:, 0], *bn.values()), {}),
        "fold_bn_only": ((c, c, 3, *bn.values()), {}),
        "fuse_mobileone_block": (([(_w(rng, c, 1, 3, 3), _rand_bn(rng, c)), (_w(rng, c, 1, 3, 3), _rand_bn(rng, c))],
                                  (_w(rng, c, 1, 1, 1), _rand_bn(rng, c)), _rand_bn(rng, c), 3, c, c), {}),
        "fuse_repmixer": ((_w(rng, c, 1, 3, 3), _w(rng, c, 1)[:, 0], _w(rng, c, 1, 3, 3), _w(rng, c, 1)[:, 0],
                           _layer_scale(rng, c).reshape(-1), c, 3), {}),
        "fuse_repcpe": ((_w(rng, c, 1, 7, 7), _w(rng, c, 1)[:, 0], c, 7), {}),
        "fuse_large_kernel_conv": (lk, {}),
        "bn_to_affine": ((_rand_bn(rng, c),), {}),
    }


def _to_torch(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_torch(v) for v in x)
    return x


@pytest.mark.parametrize("name", sorted(_fold_cases()))
def test_fold_matches_jax(name):
    args, kw = _fold_cases()[name]
    module = weights if name == "fold_conv_bn" else reparam
    jmodule = j_weights if name == "fold_conv_bn" else j_reparam
    ref = getattr(jmodule, name)(*args, **kw)
    out = getattr(module, name)(*_to_torch(args), **kw)
    ref, out = (ref, out) if isinstance(ref, tuple) else ((ref,), (out,))
    for r, o in zip(ref, out):
        assert o.dtype == torch.float32 and tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-6)


def _conv(x, w, b=None, groups=1):
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2, groups=groups)


def _bn_eval(x, bn):
    return F.batch_norm(x, bn["running_mean"], bn["running_var"], bn["weight"], bn["bias"], False, 0.0, 1e-5)


def _branch_cases():
    """(kind) -> (train-time output, fused conv output), torch, fp32."""
    rng = np.random.default_rng(1)
    c = 8
    x = torch.from_numpy(rng.standard_normal((2, c, 12, 12)).astype(np.float32))
    tb = lambda: _to_torch(_rand_bn(rng, c))
    tw = lambda *s: torch.from_numpy(_w(rng, *s))
    cases = {}

    convs = [(tw(c, 1, 3, 3), tb()), (tw(c, 1, 3, 3), tb())]
    scale, skip = (tw(c, 1, 1, 1), tb()), tb()
    branches = sum(_bn_eval(_conv(x, w, groups=c), bn) for w, bn in convs)
    branches = branches + _bn_eval(_conv(x, scale[0], groups=c), scale[1]) + _bn_eval(x, skip)
    w, b = reparam.fuse_mobileone_block(convs, scale, skip, 3, c, c)
    cases["mobileone"] = (branches, _conv(x, w, b, groups=c))

    mixer = ([(tw(c, 1, 3, 3), tb())], (tw(c, 1, 1, 1), tb()), tb())
    norm_bn, ls = tb(), torch.from_numpy(_layer_scale(rng, c).reshape(-1))
    mixed = sum(_bn_eval(_conv(x, w, groups=c), bn) for w, bn in mixer[0]) \
        + _bn_eval(_conv(x, mixer[1][0], groups=c), mixer[1][1]) + _bn_eval(x, mixer[2])
    ref = x + ls.reshape(1, -1, 1, 1) * (mixed - _bn_eval(x, norm_bn))
    mw, mb = reparam.fuse_mobileone_block(*mixer, 3, c, c)
    nw, nb = reparam.fuse_mobileone_block([], None, norm_bn, 3, c, c)
    w, b = reparam.fuse_repmixer(nw, nb, mw, mb, ls, c, 3)
    cases["repmixer"] = (ref, _conv(x, w, b, groups=c))

    pe_w, pe_b = tw(c, 1, 7, 7), torch.from_numpy(_w(rng, c, 1)[:, 0])
    w, b = reparam.fuse_repcpe(pe_w, pe_b, c, 7)
    cases["repcpe"] = (x + _conv(x, pe_w, pe_b, groups=c), _conv(x, w, b, groups=c))

    lkw, lkbn, sw, sbn = tw(c, 2, 7, 7), tb(), tw(c, 2, 3, 3), tb()
    w, b = reparam.fuse_large_kernel_conv(lkw, lkbn, sw, sbn, 7)
    cases["large kernel"] = (_bn_eval(_conv(x, lkw, groups=4), lkbn) + _bn_eval(_conv(x, sw, groups=4), sbn),
                             _conv(x, w, b, groups=4))

    cw, cbn = tw(c, 1, 7, 7), tb()
    w, b = weights.fold_conv_bn(cw, None, *cbn.values())
    cases["conv+bn"] = (_bn_eval(_conv(x, cw, groups=c), cbn), _conv(x, w, b, groups=c))
    return cases


@pytest.mark.parametrize("kind", ["mobileone", "repmixer", "repcpe", "large kernel", "conv+bn"])
def test_branch_sum_equals_fused_conv(kind):
    ref, fused = _branch_cases()[kind]
    torch.testing.assert_close(fused, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the tower converter

def _jax_tower(sd):
    return jax_params_to_torch(j_vc.convert_vision_tower(sd, j_tower_cfg()))


def test_train_mode_tower_matches_jax():
    sd = train_mode_tower(fastvithd_tiny(), seed=2)
    out = vision_convert.convert_vision_tower(tensors(sd), fastvithd_tiny())
    assert_same_state(out, _jax_tower(sd), copied=COPIED)
    tower = FastViTHD(fastvithd_tiny())
    assert sorted(out) == sorted(tower.state_dict())
    tower.load_state_dict(out, strict=True)


def test_inference_mode_tower_matches_jax():
    from test_vision_convert import make_inference_mode_dict

    sd = make_inference_mode_dict(j_tower_cfg(), np.random.default_rng(3))
    out = vision_convert.convert_vision_tower(tensors(sd), fastvithd_tiny())
    # Everything is a copy but the attention norm's BN -> affine fold.
    assert_same_state(out, _jax_tower(sd), copied=[k for k in out if ".norm." not in k])


def _unmatched_cases():
    sd = train_mode_tower(fastvithd_tiny(), seed=4)
    missing = dict(sd)
    del missing[P + "network.1.proj.0.lkb_origin.bn.running_var"]
    biased = dict(sd, **{P + "network.7.0.token_mixer.qkv.bias": np.ones(96, np.float32)})
    no_branches = {k: v for k, v in sd.items() if not k.startswith(P + "patch_embed.1.")}
    return {"bogus name": {"model.vision_tower.bogus": np.zeros(1, np.float32)},
            "other prefix": {"unrelated": np.zeros(1, np.float32)},
            "missing BN statistic": missing, "nonzero qkv bias": biased, "no branches": no_branches}


@pytest.mark.parametrize("case", sorted(_unmatched_cases()))
def test_unmatched_names_raise_like_jax(case):
    sd = _unmatched_cases()[case]
    with pytest.raises(KeyError) as jerr:
        j_vc.convert_vision_tower(sd, j_tower_cfg())
    with pytest.raises(KeyError) as terr:
        vision_convert.convert_vision_tower(tensors(sd), fastvithd_tiny())
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the decoder converter

@pytest.mark.parametrize("tied", [True, False])
def test_qwen2_conversion_matches_jax(tied):
    sd = hf_decoder(qwen2_tiny(), seed=5, tied=tied)
    jcfg = j_qwen2_tiny(tie_word_embeddings=tied)
    jparams = j_weights.convert_qwen2_state_dict(sd, jcfg)
    out = weights.convert_qwen2_state_dict(tensors(sd), qwen2_tiny(tie_word_embeddings=tied))
    assert_same_state(out, jax_params_to_torch(jparams), copied=("",))
    model = Qwen2ForCausalLM(qwen2_tiny(tie_word_embeddings=tied))
    model.load_state_dict(out, strict=True)
    ids = np.random.default_rng(6).integers(0, 512, (2, 12)).astype(np.int32)
    ref = JQwen2(jcfg).apply({"params": jparams}, input_ids=jnp.asarray(ids))[0]
    logits = model(input_ids=torch.from_numpy(ids))[0]
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # Each leaf cast on its own: bf16 out of fp32 input.
    bf16 = weights.convert_qwen2_state_dict(tensors(sd), qwen2_tiny(tie_word_embeddings=tied), dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in bf16.values())


# ---------------------------------------------------------------------------
# directories: the loader, the backbone, the policy, the CLI

@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A llava_qwen2 directory in two shards: the decoder in bf16; the
    projector and the train-mode tower in fp32."""
    tower = train_mode_tower(fastvithd_tiny(), seed=7)
    decoder = hf_decoder(qwen2_tiny(), seed=8, projector_in=fastvithd_tiny().out_channels)
    projector = {k: decoder.pop(k) for k in list(decoder) if "mm_projector" in k}
    path = write_directory(tmp_path_factory.mktemp("hf") / "fastvlm", [
        ("model-00001-of-00002.safetensors", decoder, torch.bfloat16),
        ("model-00002-of-00002.safetensors", {**projector, **tower}, torch.float32),
    ])
    return path, {**decoder, **projector, **tower}


@pytest.fixture(scope="module")
def jax_policy(hf_dir):
    from vla_fastvlm_tpu.fastvla import FastVLAConfig as JConfig
    from vla_fastvlm_tpu.fastvla import FastVLAPolicy as JPolicy

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_adapter.FastVLMBackbone, "_init_params", _fast_jax_init)
        return JPolicy(JConfig(vlm_model_name=hf_dir[0], **POLICY))


def _policy(path, **kw):
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy

    return FastVLAPolicy(FastVLAConfig(vlm_model_name=path, **POLICY, **kw), device="cpu")


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    images = rng.random((b, 3, 48, 64), dtype=np.float32)
    ids = rng.integers(3, 259, (b, 16)).astype(np.int32)
    mask = np.ones((b, 16), np.int32)
    mask[0, 11:] = 0
    states = rng.standard_normal((b, 6)).astype(np.float32)
    return images, ids, mask, states


def test_directory_policy_matches_jax(hf_dir, jax_policy):
    """The whole directory through FastVLAPolicy: weights (the bf16 decoder
    bit-equal to its source), features and actions with the head bridged."""
    path, source = hf_dir
    policy = _policy(path)
    backbone = policy.model.backbone
    state = backbone.model.state_dict()
    jparams = jax_policy.model.params
    assert_same_state(state, jax_params_to_torch(jparams["backbone"]), copied=("language_model", "mm_projector"))
    emb = torch.from_numpy(source["model.embed_tokens.weight"]).bfloat16().float()
    assert torch.equal(state["language_model.embed_tokens.weight"], emb)
    assert set(backbone.load_seconds) == {"read", "decoder", "fold", "copy"}

    policy.model.head.load_state_dict(jax_params_to_torch(jparams["head"]), strict=True)
    images, ids, mask, states = _inputs(seed=9)
    jmodel = jax_policy.model
    both = jax.jit(lambda p, i, d, m, s: (jmodel.apply_fn(p, i, d, m, s), jmodel.backbone.features_fn(p["backbone"], i, d, m)))
    ref, feats_ref = both(jparams, *(jnp.asarray(x) for x in (images, ids, mask, states)))
    args = [torch.from_numpy(x) for x in (images, ids, mask, states)]
    np.testing.assert_allclose(backbone.features_fn(*args[:3]).numpy(), np.asarray(feats_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(policy.model.apply_fn(*args).numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_after_loading_matches_jax(mode, hf_dir, jax_policy):
    """Quantized after the load, as JAX's backbone quantizes its loaded tree."""
    from vla_fastvlm_tpu.io.quantize import quantize_params as j_quantize

    ref = jax_params_to_torch(j_quantize(jax_policy.model.params["backbone"], mode=mode))
    state = _policy(hf_dir[0], quantization=mode).model.backbone.model.state_dict()
    assert sorted(state) == sorted(ref)
    quantized = [k for k in ref if k.endswith(".qweight")]
    assert len(quantized) == 2 * 4
    for k in quantized:
        assert state[k].dtype == ref[k].dtype and torch.equal(state[k], ref[k]), k
        scale = k.replace(".qweight", ".scale")
        torch.testing.assert_close(state[scale], ref[scale], rtol=1e-7, atol=0)


def test_unconverted_tower_warns_like_jax(tmp_path, caplog):
    from vla_fastvlm_tpu.io.model_loader import load_fastvlm_params as j_load
    from vla_fastvlm_tpu.io.model_loader import resolve_fastvlm_config as j_resolve
    from vla_fastvlm_tpu_torch.io.model_loader import load_fastvlm_params
    from vla_fastvlm_tpu_torch.io.presets import resolve_fastvlm_config

    decoder = hf_decoder(qwen2_tiny(), seed=10, projector_in=fastvithd_tiny().out_channels)
    sd = dict(decoder, **{P + "patch_embed.0.bogus": np.zeros(3, np.float32)})
    path = write_directory(tmp_path, [("model.safetensors", sd, torch.float32)])
    with caplog.at_level(logging.WARNING):
        jparams = j_load(path, j_resolve(path, "fastvlm-tiny")[0])
        params = load_fastvlm_params(path, resolve_fastvlm_config(path, "fastvlm-tiny")[0])
    warned = [r.getMessage() for r in caplog.records if "could not be converted" in r.getMessage()]
    assert len(warned) == 2 and warned[0] == warned[1], warned
    assert "vision_tower" not in jparams and not any(k.startswith("vision_tower.") for k in params)

    # The backbone keeps its seeded tower: the one it makes with no shards.
    policy = _policy(path, seed=3).model.backbone.model.state_dict()
    (tmp_path / "model.safetensors").unlink()
    init = _policy(path, seed=3).model.backbone.model.state_dict()
    for k, v in init.items():
        if k.startswith("vision_tower."):
            assert torch.equal(policy[k], v), k
        elif k.startswith("language_model.layers.0.self_attn.o_proj"):
            assert torch.equal(policy[k], torch.from_numpy(decoder["model.layers.0.self_attn.o_proj.weight"]))


def test_decoder_only_checkpoint_overlays_init(tmp_path):
    decoder = hf_decoder(qwen2_tiny(), seed=11)
    path = write_directory(tmp_path, [("model.safetensors", decoder, torch.bfloat16)])
    loaded = _policy(path, seed=4).model.backbone.model.state_dict()
    (tmp_path / "model.safetensors").unlink()
    init = _policy(path, seed=4).model.backbone.model.state_dict()
    expect = {"language_model." + k[len("model."):]: v for k, v in
              weights.convert_qwen2_state_dict(tensors(decoder), qwen2_tiny(), dtype=torch.bfloat16).items()}
    for k, v in init.items():
        if k in expect:
            assert torch.equal(loaded[k], expect[k].float()), k
        else:  # the tower and the projector: the seeded init
            assert torch.equal(loaded[k], v), k
    assert {k.split(".")[0] for k in init if k not in expect} == {"vision_tower", "mm_projector"}


def test_text_only_directory_loads_like_jax(tmp_path):
    """A ``qwen2`` directory: the decoder alone (``image_token_mode``
    "none"); the projector names in its shard are not the model's."""
    from vla_fastvlm_tpu.io.model_loader import load_fastvlm_params as j_load
    from vla_fastvlm_tpu.io.model_loader import resolve_fastvlm_config as j_resolve
    from vla_fastvlm_tpu_torch.model import FastVLMBackbone, FastVLMBackboneConfig

    sd = hf_decoder(qwen2_tiny(), seed=13, tied=False, projector_in=fastvithd_tiny().out_channels)
    path = str(tmp_path)
    write_directory(tmp_path, [("model.safetensors", sd, torch.float32)], tied=False)
    config = json.loads((tmp_path / "config.json").read_text())
    (tmp_path / "config.json").write_text(json.dumps(dict(config, model_type="qwen2")))
    state = FastVLMBackbone(FastVLMBackboneConfig(model_id=path, bootstrap_model_id="fastvlm-tiny",
                                                  tokenizer_max_length=8), device="cpu").model.state_dict()
    ref = jax_params_to_torch(j_load(path, j_resolve(path, "fastvlm-tiny")[0]))
    assert not any(k.startswith(("vision_tower.", "mm_projector.")) for k in state)
    assert_same_state(state, {k: v for k, v in ref.items() if not k.startswith("mm_projector.")}, copied=("",))


def _jax_script(name):
    scripts = Path(__file__).resolve().parent.parent / "scripts"
    if str(scripts) not in sys.path:
        sys.path.insert(0, str(scripts))
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", scripts / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def test_convert_checkpoint_matches_jax_script(hf_dir, tmp_path, monkeypatch):
    """The port's CLI writes what JAX's loader reads; its backbone is
    bit-equal to JAX's own script's output (heads: shapes only)."""
    from vla_fastvlm_tpu.io.checkpoint import load_policy_from_checkpoint as j_load_policy
    from vla_fastvlm_tpu.io.checkpoint import load_policy_state as j_load_state
    from vla_fastvlm_tpu.utils.cli import parse_cli as j_parse_cli
    from vla_fastvlm_tpu_torch.io.bridge import flatten_params
    from vla_fastvlm_tpu_torch.scripts import convert_checkpoint
    from vla_fastvlm_tpu_torch.utils import load_policy_from_checkpoint, parse_cli

    monkeypatch.setattr(j_adapter.FastVLMBackbone, "_init_params", _fast_jax_init)
    flags = ["--checkpoint-dir", hf_dir[0], "--state-dim", "6", "--action-dim", "5", "--hidden-dim", "16",
             "--fusion-dim", "16"]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    convert_checkpoint.main(parse_cli(convert_checkpoint.ConvertArgs, flags + ["--output-dir", str(ours),
                                                                                "--device", "cpu"]))
    script = _jax_script("convert_checkpoint")
    script.main(j_parse_cli(script.ConvertArgs, flags + ["--output-dir", str(theirs)]))

    (cfg, params), (jcfg, jparams) = j_load_state(ours), j_load_state(theirs)
    assert {k: v for k, v in cfg.items() if k != "device"} == {k: v for k, v in jcfg.items() if k != "device"}
    flat, jflat = flatten_params(params), flatten_params(jparams)
    assert sorted(flat) == sorted(jflat)
    for k, v in jflat.items():
        if k.startswith("backbone."):
            assert np.array_equal(np.asarray(flat[k]), np.asarray(v)), k
        assert np.shape(flat[k]) == np.shape(v), k

    jpolicy, _ = j_load_policy(ours, device_preference="cpu")
    assert np.array_equal(np.asarray(jpolicy.params["head"]["fusion_fc1"]["kernel"]),
                          np.asarray(params["head"]["fusion_fc1"]["kernel"]))
    policy, device = load_policy_from_checkpoint(ours, device="cpu")
    images, _, _, states = _inputs(seed=12)
    ref = jpolicy.forward(images, states, ["pick", "place"])
    np.testing.assert_allclose(policy.forward(images, states, ["pick", "place"]).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def _entry_backbone(entry, path, monkeypatch):
    """The backbone an entry point builds from ``path`` on the CPU."""
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLMTokenPolicy
    from vla_fastvlm_tpu_torch.model import FastVLMBackbone, FastVLMBackboneConfig, FastVLMPolicy, FastVLMPolicyConfig
    from vla_fastvlm_tpu_torch.scripts import generate, serve

    tiny = dict(tokenizer_max_length=8)
    if entry == "FastVLMBackbone":
        return FastVLMBackbone(FastVLMBackboneConfig(model_id=path, bootstrap_model_id="fastvlm-tiny", **tiny),
                               device="cpu")
    if entry == "FastVLMTokenPolicy":
        return FastVLMTokenPolicy(FastVLAConfig(vlm_model_name=path, bootstrap_model_name="fastvlm-tiny",
                                                action_head="token", action_bins=64, **tiny), device="cpu").backbone
    if entry == "FastVLMPolicy":
        return FastVLMPolicy(FastVLMPolicyConfig(backbone=FastVLMBackboneConfig(
            model_id=path, bootstrap_model_id="fastvlm-tiny", **tiny), hidden_dim=8, fusion_dim=8),
            device="cpu").backbone
    if entry == "lerobot plugin":
        from _torch_parity import lerobot_stub

        with lerobot_stub("vla_fastvlm_tpu_torch.lerobot_fastvla"):
            from lerobot.configs.types import FeatureType, PolicyFeature

            from vla_fastvlm_tpu_torch.lerobot_fastvla import FastVLAConfig as PluginConfig
            from vla_fastvlm_tpu_torch.lerobot_fastvla import FastVLAPolicy as PluginPolicy

            config = PluginConfig(
                input_features={"observation.state": PolicyFeature(FeatureType.STATE, (4,)),
                                "observation.images.top": PolicyFeature(FeatureType.VISUAL, (3, 64, 64))},
                output_features={"action": PolicyFeature(FeatureType.ACTION, (4,))},
                vlm_model_name=path, bootstrap_model_name="fastvlm-tiny", hidden_dim=8, fusion_dim=8,
                device="cpu", **tiny)
            return PluginPolicy(config).model.backbone
    built = []
    for module in (serve, generate):
        cls = module.FastVLMBackbone
        monkeypatch.setattr(module, "FastVLMBackbone", lambda *a, _cls=cls, **k: built.append(_cls(*a, **k)) or built[-1])
    if entry == "scripts.serve":
        serve.main(serve.ServeArgs(model_id=path, num_slots=1, prefill_batch=1, prompt_len=4, max_new_tokens=2,
                                   num_requests=1, dtype="float32", paged=True, page_size=4, device="cpu"))
    else:
        generate.main(generate.GenerateArgs(model_id=path, bootstrap_model_id="fastvlm-tiny", max_new_tokens=2,
                                            dtype="float32", device="cpu", **tiny))
    return built[0]


@pytest.mark.parametrize("entry", ["FastVLMBackbone", "FastVLMTokenPolicy", "FastVLMPolicy", "lerobot plugin",
                                   "scripts.serve", "scripts.generate"])
def test_every_entry_point_loads_the_directory(entry, hf_dir, monkeypatch):
    """Each entry point inherits the backbone's load: the directory's
    decoder (bf16 in its shard) and folded tower, not the seeded init."""
    path, source = hf_dir
    state = _entry_backbone(entry, path, monkeypatch).model.state_dict()
    emb = torch.from_numpy(source["model.embed_tokens.weight"]).bfloat16().float()
    assert torch.equal(state["language_model.embed_tokens.weight"].float(), emb)
    fused = vision_convert.convert_vision_tower(tensors({k: v for k, v in source.items() if k.startswith(P)}),
                                                fastvithd_tiny())
    assert torch.equal(state["vision_tower.conv_exp.conv.weight"].float(), fused["conv_exp.conv.weight"])
