"""The port's weight quantization against the JAX package on the CPU.

``ops/quant.py``, ``io/quantize.py``, the weight bridge's quantized trees,
the quantized Qwen2 and FastVLM, both policies over a quantized base,
QLoRA and SmoothQuant (``io/smooth.py``), in fp32 at tiny sizes, the inputs
made by numpy from seeds. Each JAX reference is built once a class.

Tolerances:

- int8 and int4 codes bit-equal (both divide in fp32 and round half to
  even), scales within 1e-7 relative; pack and unpack exact.
- Products within 1e-5 of JAX's (outputs of order 1; fp32 sums in another
  order), w8a8 below and above its gate lowered in both packages.
- Qwen2 and FastVLM logits within 1e-4 for int8 and int4, and for w8a8
  (its gate lowered in both packages) too. w8a8 quantizes each
  projection's input per token, so an fp32 difference of 1e-7 in a hidden
  state that sits on a rounding boundary moves one activation code by one
  step, 1/127 of that token's largest input, which would reach the logits
  at about 1e-3 of their scale; on these seeded inputs no code sits that
  close, and the 1e-4 bound holds. Inputs that flip a code need 1e-2
  relative.
- QLoRA logits within 1e-5; the policy's loss, adapter gradients and three
  AdamW updates as ``test_torch_lora.py`` holds them (1e-5 / 1e-4 / 1e-5).
- SmoothQuant: calibration within 1e-5, the smoothed tree within 1e-6,
  float outputs unchanged within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.fastvla import FastVLAConfig as JConfig
from vla_fastvlm_tpu.fastvla import FastVLAPolicy as JPolicy
from vla_fastvlm_tpu.io import checkpoint as jckpt
from vla_fastvlm_tpu.io import quantize as jquantize
from vla_fastvlm_tpu.io import smooth as jsmooth
from vla_fastvlm_tpu.models import fastvlm as j_vlm
from vla_fastvlm_tpu.models import qwen2 as j_qwen
from vla_fastvlm_tpu.ops import quant as jq
from vla_fastvlm_tpu.training import Trainer as JTrainer
from vla_fastvlm_tpu.training import TrainingConfig as JTrainingConfig
from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy
from vla_fastvlm_tpu_torch.io import checkpoint as tckpt
from vla_fastvlm_tpu_torch.io import quantize as tquantize
from vla_fastvlm_tpu_torch.io import smooth as tsmooth
from vla_fastvlm_tpu_torch.io.bridge import (
    flatten_params,
    jax_lora_to_torch,
    jax_params_to_torch,
    torch_params_to_jax,
)
from vla_fastvlm_tpu_torch.io.lora import merge_lora
from vla_fastvlm_tpu_torch.model.fastvlm_adapter import FastVLMBackbone, FastVLMBackboneConfig
from vla_fastvlm_tpu_torch.models import fastvlm as t_vlm
from vla_fastvlm_tpu_torch.models import qwen2 as t_qwen
from vla_fastvlm_tpu_torch.models.layers import QuantDense
from vla_fastvlm_tpu_torch.ops import quant as tq
from vla_fastvlm_tpu_torch.training import Trainer, TrainingConfig

from _torch_parity import jax_adapter, jax_param_shapes, random_params, random_quantized_params, t

PRODUCT_ATOL = 1e-5
LOGIT_ATOL = 1e-4
LORA_ATOL = 1e-5
LOSS_RTOL, GRAD_RTOL, UPDATE_ATOL = 1e-5, 1e-4, 1e-5
CALIB_ATOL, SMOOTH_ATOL, FLOAT_ATOL = 1e-5, 1e-6, 1e-5
MODES = ("int8", "int4", "w8a8")
POLICY = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", state_dim=6, action_dim=5,
              hidden_dim=16, fusion_dim=16, tokenizer_max_length=16, dropout=0.0)


@pytest.fixture
def no_w8a8_gate(monkeypatch):
    """w8a8 engages at any token count in both packages (the JAX tests' gate)."""
    monkeypatch.setattr(jq, "W8A8_MIN_TOKENS", 0)
    monkeypatch.setattr(tq, "W8A8_MIN_TOKENS", 0)


def _weight(rng, k, n):
    """A JAX kernel (K, N) at unit output scale and the port's (N, K) weight."""
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return w, torch.from_numpy(np.ascontiguousarray(w.T))


def _port_leaf(jleaf):
    """A JAX quantized leaf -> the port's, through the weight bridge."""
    sd = jax_params_to_torch({"p": jax.device_get(jleaf)})
    return {k.split(".")[1]: v for k, v in sd.items()}


def _rel_err(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


class TestOps:
    @pytest.mark.parametrize("zero_column", [False, True])
    def test_int8_codes_bit_equal(self, zero_column):
        w, tw = _weight(np.random.default_rng(0), 48, 40)
        if zero_column:
            w[:, 7] = 0
            tw[7] = 0
        ref = jq.quantize_kernel(jnp.asarray(w))
        got = tq.quantize_kernel(tw)
        assert got["qweight"].dtype == torch.int8 and tuple(got["scale"].shape) == (40,)
        np.testing.assert_array_equal(got["qweight"].numpy(), np.asarray(ref["kernel"]).T)
        np.testing.assert_allclose(got["scale"].numpy(), np.asarray(ref["scale"])[0], rtol=1e-7)
        if zero_column:
            assert not got["qweight"][7].any() and float(got["scale"][7]) == 1.0

    @pytest.mark.parametrize("k,group", [(256, 128), (48, 128), (40, 16)])
    def test_int4_codes_bit_equal(self, k, group):
        """The group shrinks to gcd(K, group) where it does not divide K."""
        w, tw = _weight(np.random.default_rng(1), k, 24)
        w[: k // 4, 3] = 0  # an all-zero group
        tw[3, : k // 4] = 0
        ref = jq.quantize_kernel_int4(jnp.asarray(w), group)
        got = tq.quantize_kernel_int4(tw, group)
        assert got["qweight"].dtype == torch.uint8 and tuple(got["qweight"].shape) == (24, k // 2)
        assert tuple(got["scale"].shape) == tuple(ref["scale"].shape) == (k // np.gcd(k, group), 24)
        np.testing.assert_array_equal(tq.unpack_int4(got["qweight"]).numpy(),
                                      np.asarray(ref["kernel"]).astype(np.int8).T)
        np.testing.assert_allclose(got["scale"].numpy(), np.asarray(ref["scale"]), rtol=1e-7)

    def test_int4_pack_unpack_exact(self):
        codes = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 2)  # every nibble at even and odd k
        packed = tq.pack_int4(codes)
        assert packed.dtype == torch.uint8 and tuple(packed.shape) == (3, 16)
        assert torch.equal(tq.unpack_int4(packed), codes)
        assert int(packed[0, 0]) == (0x8 | (0x9 << 4))  # -8 low nibble, -7 high
        with pytest.raises(ValueError, match="even"):
            tq.pack_int4(codes[:, :3])

    def test_activation_codes_equal(self):
        x = np.random.default_rng(2).standard_normal((3, 5, 48)).astype(np.float32)
        x[1, 2] = 0
        jcodes, jscale = jq.quantize_activations(jnp.asarray(x))
        codes, scale = tq.quantize_activations(t(x))
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-7)

    @pytest.mark.parametrize("mode,tokens", [("int8", 16), ("int4", 16), ("int4", 256), ("w8a8", 4), ("w8a8", 16)])
    def test_products_match_jax(self, mode, tokens, monkeypatch):
        """int4 at 16 tokens takes the grouped formulation, at 256 the scaled
        weights; w8a8, its gate at 8 in both packages, the weight-only int8
        product at 4 tokens and the int8 x int8 one at 16."""
        monkeypatch.setattr(jq, "W8A8_MIN_TOKENS", 8)
        monkeypatch.setattr(tq, "W8A8_MIN_TOKENS", 8)
        rng = np.random.default_rng(3)
        w, tw = _weight(rng, 64, 40)
        bias = (0.1 * rng.standard_normal(40)).astype(np.float32)
        x = rng.standard_normal((2, tokens // 2, 64)).astype(np.float32)
        jleaf = dict(jq.quantize_kernel_int4(jnp.asarray(w), 16) if mode == "int4" else
                     jq.quantize_kernel(jnp.asarray(w)), bias=jnp.asarray(bias))
        ref = jq.dense_apply(jnp.asarray(x), jleaf, jnp.float32, act_quant=mode == "w8a8")
        leaf = _port_leaf(jleaf)
        got = tq.dense_apply(t(x), leaf, torch.float32, act_quant=mode == "w8a8")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=PRODUCT_ATOL)
        # The port's quantizer gives the bridge's leaf.
        own = tq.quantize_kernel_int4(tw, 16) if mode == "int4" else tq.quantize_kernel(tw)
        assert torch.equal(own["qweight"], leaf["qweight"]) and torch.equal(own["scale"], leaf["scale"])

    @pytest.mark.parametrize("mode", MODES)
    def test_fused_matches_separate_and_jax(self, mode, no_w8a8_gate):
        rng = np.random.default_rng(4)
        quant = (lambda k: jq.quantize_kernel_int4(k, 16)) if mode == "int4" else jq.quantize_kernel
        jleaves = [dict(quant(jnp.asarray(_weight(rng, 64, n)[0])), bias=jnp.asarray(rng.standard_normal(n),
                                                                                    jnp.float32)) for n in (32, 16)]
        x = rng.standard_normal((5, 64)).astype(np.float32)
        aq = mode == "w8a8"
        ref = jq.fused_dense_apply(jnp.asarray(x), jleaves, jnp.float32, act_quant=aq)
        leaves = [_port_leaf(leaf) for leaf in jleaves]
        fused = tq.fused_dense_apply(t(x), leaves, torch.float32, act_quant=aq)
        separate = torch.cat([tq.dense_apply(t(x), leaf, torch.float32, act_quant=aq) for leaf in leaves], -1)
        np.testing.assert_allclose(fused.numpy(), np.asarray(ref), atol=PRODUCT_ATOL)
        np.testing.assert_allclose(fused.numpy(), separate.numpy(), atol=PRODUCT_ATOL)

    def test_fused_rejects_mixed_groups(self):
        w, tw = _weight(np.random.default_rng(5), 16, 8)
        with pytest.raises(ValueError, match="mixes"):
            tq.fused_dense_apply(torch.zeros(2, 16), [tq.quantize_kernel(tw), {"weight": tw}], torch.float32)
        with pytest.raises(ValueError, match="mixes"):
            jq.fused_dense_apply(jnp.zeros((2, 16)), [jq.quantize_kernel(jnp.asarray(w)),
                                                      {"kernel": jnp.asarray(w)}], jnp.float32)


@pytest.fixture(scope="module")
def lms():
    """JAX tiny Qwen2ForCausalLM float params, tied and untied."""
    out = {}
    for tied in (True, False):
        cfg = j_qwen.qwen2_tiny(tie_word_embeddings=tied)
        shapes = jax_param_shapes(j_qwen.Qwen2ForCausalLM(cfg), jnp.ones((1, 8), jnp.int32))
        out[tied] = random_params(shapes, seed=int(tied))
    return out


def _port_lm(params, tied, mode="none", quantize=True):
    model = t_qwen.Qwen2ForCausalLM(t_qwen.qwen2_tiny(tie_word_embeddings=tied, quantization=mode))
    model.load_state_dict(jax_params_to_torch(params), strict=True)
    if quantize and mode != "none":
        tquantize.quantize_params(model, mode=mode)
    return model.eval().requires_grad_(False)


class TestTree:
    @pytest.mark.parametrize("tied", [True, False])
    @pytest.mark.parametrize("mode", MODES)
    def test_counts_and_state_match_jax(self, lms, tied, mode):
        """``quantize_params`` counts as JAX's ``count_quantized`` and holds
        the bridge of JAX's quantized tree, bit for bit."""
        jtree = jquantize.quantize_params(lms[tied], mode=mode)
        model = _port_lm(lms[tied], tied, mode)
        assert tquantize.count_quantized(model) == jquantize.count_quantized(jtree) == (7 if tied else 8)
        ref = jax_params_to_torch(jtree)
        state = model.state_dict()
        assert sorted(state) == sorted(ref)
        assert all(torch.equal(state[k], ref[k]) for k in ref)
        assert not hasattr(model.model.layers[0].self_attn.qkv_proj, "weight")
        assert model.model.embed_tokens.weight.is_floating_point()

    def test_partial_fused_group_and_unknown_mode_raise(self, lms):
        model = _port_lm(lms[True], True)
        with pytest.raises(ValueError, match="fuses"):
            tquantize.quantize_params(model, names={"q_proj", "o_proj"})
        with pytest.raises(ValueError, match="unknown quantization mode"):
            tquantize.quantize_params(model, mode="int3")
        with pytest.raises(ValueError, match="unknown quantization mode"):
            jquantize.quantize_params(lms[True], mode="int3")
        with pytest.raises(ValueError, match="unknown quantization"):
            t_qwen.Qwen2Model(t_qwen.qwen2_tiny(quantization="int3"))
        tquantize.quantize_params(model, names={"gate_proj", "up_proj"})
        assert tquantize.count_quantized(model) == 2 == jquantize.count_quantized(
            jquantize.quantize_params(lms[True], names={"gate_proj", "up_proj"}))

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    def test_bf16_tree_quantizes(self, lms, mode):
        jtree = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), lms[True])  # numpy bf16 leaves
        ref = jax_params_to_torch(jquantize.quantize_params(jtree, mode=mode))
        model = t_qwen.Qwen2ForCausalLM(t_qwen.qwen2_tiny(param_dtype=torch.bfloat16, dtype=torch.bfloat16))
        model.load_state_dict({k: v.to(torch.bfloat16) for k, v in jax_params_to_torch(jtree).items()})
        tquantize.quantize_params(model, mode=mode)
        qkv = model.model.layers[1].self_attn.qkv_proj
        assert isinstance(qkv, QuantDense) and qkv.scale.dtype == torch.float32
        assert qkv.bias.dtype == torch.bfloat16
        state = model.state_dict()
        for k in ref:
            if "qweight" in k or k.endswith("proj.scale"):
                assert torch.equal(state[k], ref[k]), k

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    @pytest.mark.parametrize("tied", [True, False])
    def test_bridge_roundtrip_bit_equal(self, lms, mode, tied):
        jtree = jax.device_get(jquantize.quantize_params(lms[tied], mode=mode))
        model = _port_lm(lms[tied], tied, mode)
        model.load_state_dict(jax_params_to_torch(jtree), strict=True)
        back = torch_params_to_jax(model)
        flat, ref = flatten_params(back), flatten_params(jtree)
        assert sorted(flat) == sorted(ref)
        for k, v in ref.items():
            assert np.asarray(flat[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(np.asarray(flat[k]).astype(np.float32),
                                          np.asarray(v).astype(np.float32), err_msg=k)
        # The scales survive a cast of the module, and the codes too.
        model.to(torch.bfloat16)
        qkv = model.model.layers[0].self_attn.qkv_proj
        assert qkv.scale.dtype == torch.float32 and qkv.qweight.dtype in (torch.int8, torch.uint8)
        assert torch.equal(qkv.scale, jax_params_to_torch(jtree)["model.layers.0.self_attn.qkv_proj.scale"])


class TestModels:
    @pytest.mark.parametrize("tied", [True, False])
    @pytest.mark.parametrize("mode", MODES)
    def test_qwen2_logits_match_jax(self, lms, mode, tied, no_w8a8_gate):
        ids = np.random.default_rng(6).integers(0, 512, (2, 9)).astype(np.int32)
        jtree = jquantize.quantize_params(lms[tied], mode=mode)
        jm = j_qwen.Qwen2ForCausalLM(j_qwen.qwen2_tiny(tie_word_embeddings=tied, quantization=mode))
        ref, jhidden, _ = jax.jit(jm.apply)({"params": jtree}, jnp.asarray(ids))
        model = _port_lm(lms[tied], tied, mode)
        assert all(m.act_quant == (mode == "w8a8") for m in model.modules() if isinstance(m, QuantDense))
        with torch.no_grad():
            logits, hidden, _ = model(t(ids))
        np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), atol=LOGIT_ATOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=LOGIT_ATOL)
        float_logits, _, _ = _port_lm(lms[tied], tied)(t(ids))
        assert float((logits - float_logits).abs().max()) > 100 * LOGIT_ATOL  # the codes are in use

    def test_w8a8_gate_takes_the_weight_only_product(self, lms):
        """Below ``W8A8_MIN_TOKENS`` a w8a8 model computes what int8 does, bit for bit."""
        ids = np.random.default_rng(7).integers(0, 512, (1, 6)).astype(np.int32)
        with torch.no_grad():
            w8a8 = _port_lm(lms[True], True, "w8a8")(t(ids))[0]
            int8 = _port_lm(lms[True], True, "int8")(t(ids))[0]
        assert torch.equal(w8a8, int8)

    @pytest.mark.parametrize("mode", ["int8"])
    def test_fastvlm_prefill_and_decode_match_jax(self, mode):
        """Quantized FastVLM (untied head, int8 KV cache beside): prefill and
        two dense decode steps against JAX."""
        text = dict(tie_word_embeddings=False, quantization=mode, kv_cache_quantization="int8")
        jm = j_vlm.FastVLM(j_vlm.fastvlm_tiny().replace(text=j_qwen.qwen2_tiny(**text)))
        params = random_params(jax_param_shapes(jm, jnp.zeros((1, 3, 64, 64)), jnp.ones((1, 8), jnp.int32),
                                                method=j_vlm.FastVLM.forward_logits), 8)  # lm_head too
        params["language_model"]["embed_tokens"]["embedding"] *= 0.1
        jtree = jquantize.quantize_params(params, mode=mode)
        tm = t_vlm.FastVLM(t_vlm.fastvlm_tiny().replace(text=t_qwen.qwen2_tiny(**text)))
        tquantize.quantize_params(tm, mode=mode)
        tm.load_state_dict(jax_params_to_torch(jax.device_get(jtree)), strict=True)
        assert isinstance(tm.lm_head, QuantDense)
        rng = np.random.default_rng(9)
        images = rng.random((2, 3, 64, 64), dtype=np.float32)
        ids = rng.integers(3, 500, (2, 8)).astype(np.int32)
        mask = np.ones((2, 8), np.int32)
        mask[1, 6:] = 0
        max_len = jm.cfg.num_image_tokens + 8 + 2
        jcache = j_qwen.init_kv_cache(jm.cfg.text, 2, max_len)
        apply = lambda method: jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=method))
        jlast, _, jcache, _, _ = apply(j_vlm.FastVLM.prefill)(jtree, jnp.asarray(images), jnp.asarray(ids),
                                                               jnp.asarray(mask), jcache)
        tcache = t_qwen.init_kv_cache(tm.cfg.text, 2, max_len)
        with torch.no_grad():
            tlast, _, tcache, _, _ = tm.prefill(t(images), t(ids), t(mask), tcache)
            np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=LOGIT_ATOL)
            tok = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)[:, None]
            for _ in range(2):
                jlogits, jcache = apply(j_vlm.FastVLM.decode_step)(jtree, jnp.asarray(tok), jcache)
                tlogits, tcache = tm.decode_step(t(tok), tcache)
                np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL)
                tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)[:, None]


def _jax_policy(mode, seed, **kw):
    """A JAX FastVLA policy quantized with ``mode``, its float leaves seeded
    and its quantized ones quantized from seeded float kernels."""
    jpolicy = JPolicy(JConfig(**POLICY, quantization=mode, fabricate_params=True, **kw))
    params = random_quantized_params(jax.device_get(jpolicy.params), seed)
    params["backbone"]["language_model"]["embed_tokens"]["embedding"] *= 0.1
    jpolicy.load_params(params)
    return jpolicy, params


def _policy_pair(mode, seed, **kw):
    jpolicy, params = _jax_policy(mode, seed, **kw)
    tpolicy = FastVLAPolicy(FastVLAConfig(**POLICY, quantization=mode, **kw), device="cpu")
    tpolicy.load_jax_params(params)
    return jpolicy, tpolicy, params


def _batch(b=3, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.random((b, 3, 48, 80), np.float32),
            "states": (rng.standard_normal((b, 6)) * 0.5).astype(np.float32),
            "tasks": ["pick", "insert the peg carefully", "push"][:b],
            "actions": np.clip(rng.standard_normal((b, 5)) * 0.5, -1, 1).astype(np.float32)}


class TestPolicies:
    @pytest.mark.parametrize("mode", ["int8", "int4"])
    def test_select_action_matches_jax(self, mode):
        jpolicy, tpolicy, _ = _policy_pair(mode, seed=10)
        assert tquantize.count_quantized(tpolicy.model.backbone.model) == 7
        batch = _batch(b=1, seed=11)
        image, state = batch["images"], batch["states"]
        ref = np.asarray(jpolicy.select_action(image, state, "pick up the cube"))
        got = tpolicy.select_action(image, state, "pick up the cube").numpy()
        assert got.shape == ref.shape == (5,)
        np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL)

    def test_train_backbone_raises(self):
        with pytest.raises(ValueError, match="inference-only"):
            FastVLMBackbone(FastVLMBackboneConfig(model_id="fastvlm-tiny", bootstrap_model_id="fastvlm-tiny",
                                                  quantization="int8", train_backbone=True), device="cpu")
        with pytest.raises(ValueError, match="unknown quantization"):
            FastVLMBackbone(FastVLMBackboneConfig(model_id="fastvlm-tiny", bootstrap_model_id="fastvlm-tiny",
                                                  quantization="fp8"), device="cpu")


class TestQLoRA:
    def test_adapted_logits_match_jax(self):
        jm = j_vlm.FastVLM(j_vlm.fastvlm_tiny().replace(text=j_qwen.qwen2_tiny(quantization="int8")))
        params = random_params(jax_param_shapes(jm, jnp.zeros((1, 3, 64, 64)), jnp.ones((1, 8), jnp.int32)), 12)
        params["language_model"]["embed_tokens"]["embedding"] *= 0.1  # logits of order 1 (tiny_vlm_pair)
        lora = jax_adapter(params, 4, 13)
        jtree = jquantize.quantize_params(params, mode="int8")
        tm = t_vlm.FastVLM(t_vlm.fastvlm_tiny().replace(text=t_qwen.qwen2_tiny(quantization="int8")))
        tquantize.quantize_params(tm, mode="int8")
        tm.load_state_dict(jax_params_to_torch(jax.device_get(jtree)), strict=True)
        rng = np.random.default_rng(14)
        images, ids = rng.random((2, 3, 64, 64), dtype=np.float32), rng.integers(3, 500, (2, 8)).astype(np.int32)
        mask = np.ones((2, 8), np.int32)
        ref, _, _ = jax.jit(lambda v, *a: jm.apply(v, *a, method=j_vlm.FastVLM.forward_logits))(
            {"params": jtree, "lora": lora}, jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask))
        with torch.no_grad():
            got, _, _ = tm.forward_logits(t(images), t(ids), t(mask), lora=jax_lora_to_torch(lora))
            base, _, _ = tm.forward_logits(t(images), t(ids), t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LORA_ATOL)
        assert float((got - base).abs().max()) > 100 * LORA_ATOL

    def test_loss_gradients_and_updates_match_jax(self):
        """The MLP head with rank-4 adapters over an int8 base: loss and
        adapter gradients of one step, then three AdamW updates of both
        trainers (eps 1e-4, as ``test_torch_lora.py`` sets it); the base's
        codes and scales unmoved."""
        jpolicy, tpolicy, _ = _policy_pair("int8", seed=15, lora_rank=4)
        batch = _batch(seed=16)
        arrays = jpolicy.prepare_batch(batch)
        loss_fn = lambda tr, fr, a: jpolicy.loss_fn(tr, fr, a, train=True)[0]
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jpolicy.trainable_params(), jpolicy.frozen_params(),
                                                              arrays)
        tloss, _ = tpolicy.loss_fn(tpolicy.to_device(tpolicy.prepare_batch(batch)), train=True)
        np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=LOSS_RTOL)
        tloss.backward()
        ref = flatten_params(jax_lora_to_torch(jax.device_get(jgrads["lora"])))
        got = tpolicy.trainable_params()["lora"]
        assert sorted(got) == sorted(ref)
        for name, value in ref.items():
            assert _rel_err(got[name].grad.numpy(), value.numpy()) <= GRAD_RTOL, name
        for p in got.values():
            p.grad = None

        batches = [_batch(b=2, seed=20 + i) for i in range(3)]
        settings = dict(max_steps=10, warmup_ratio=0.0, learning_rate=1e-2, max_grad_norm=1.0, eps=1e-4,
                        report_to=[], mixed_precision=None)
        jtrainer = JTrainer(jpolicy, batches, None, JTrainingConfig(**settings))
        trainable, opt_state, rng = jtrainer.trainable, jtrainer.opt_state, jax.random.PRNGKey(0)
        ttrainer = Trainer(tpolicy, batches, None, TrainingConfig(**settings))
        base = {k: v.clone() for k, v in tpolicy.model.backbone.model.state_dict().items()}
        for b in batches:
            trainable, opt_state, jm = jtrainer._train_step(trainable, opt_state, jtrainer.frozen,
                                                             jpolicy.prepare_batch(b), rng)
            tm = ttrainer._train_step(ttrainer._place_batch(b))
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        expect = flatten_params(jax_lora_to_torch(jax.device_get(trainable["lora"])))
        for name, value in tpolicy.trainable_params()["lora"].items():
            np.testing.assert_allclose(value.detach().numpy(), expect[name].numpy(), atol=UPDATE_ATOL, err_msg=name)
        state = tpolicy.model.backbone.model.state_dict()
        assert all(torch.equal(v, base[k]) for k, v in state.items())

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    def test_checkpoints_cross_both_ways(self, mode, tmp_path):
        """A quantized QLoRA policy's checkpoint carries the int8 codes and
        scales under JAX's names, both ways; int4 has no safetensors dtype,
        and both packages refuse to write it. ``merge_lora`` refuses the
        quantized base."""
        jpolicy, params = _jax_policy(mode, 17, lora_rank=2)
        tpolicy = FastVLAPolicy(FastVLAConfig(**POLICY, quantization=mode, lora_rank=2), device="cpu")
        tpolicy.load_jax_params(params)
        with pytest.raises(TypeError, match="quantized"):
            merge_lora(tpolicy.jax_params(as_numpy=False)["backbone"], jax_lora_to_torch(params["lora"]))
        if mode == "int4":
            with pytest.raises(Exception, match="int4"):
                jckpt.save_policy_checkpoint(tmp_path / "jax", jpolicy.config, jax.device_get(jpolicy.params))
            with pytest.raises(TypeError, match="int4"):
                tckpt.save_policy_checkpoint(tmp_path / "port", tpolicy.config, tpolicy.jax_params(as_numpy=False))
            return
        jckpt.save_policy_checkpoint(tmp_path / "jax", jpolicy.config, jax.device_get(jpolicy.params))
        loaded, _ = tckpt.load_policy_from_checkpoint(tmp_path / "jax", device="cpu")
        ref = tpolicy.model.backbone.model.state_dict()
        got = loaded.model.backbone.model.state_dict()
        assert all(torch.equal(got[k], ref[k]) for k in ref)
        assert got["language_model.layers.0.mlp.down_proj.qweight"].dtype == torch.int8
        obs = _batch(b=2, seed=18)
        with torch.no_grad():
            a = loaded.forward(obs["images"], obs["states"], obs["tasks"])
            b = tpolicy.forward(obs["images"], obs["states"], obs["tasks"])
        assert torch.equal(a, b)
        tckpt.save_policy_checkpoint(tmp_path / "port", loaded.config, loaded.jax_params(as_numpy=False))
        _, written = jckpt.load_policy_state(tmp_path / "port")
        kernel = written["backbone"]["language_model"]["layers"]["self_attn"]["q_proj"]
        assert kernel["kernel"].dtype == np.int8 and kernel["scale"].shape == (2, 1, 64)
        jback, _ = jckpt.load_policy_from_checkpoint(tmp_path / "port")
        flat, expect = flatten_params(jax.device_get(jback.params)), flatten_params(params)
        assert sorted(flat) == sorted(expect)
        for k, v in expect.items():
            np.testing.assert_array_equal(np.asarray(flat[k]), np.asarray(v), err_msg=k)


@pytest.fixture(scope="module")
def smooth_lm():
    """A tiny untied JAX LM with outlier input channels (SmoothQuant's case),
    its calibration batch, JAX's calibration and the port's twin."""
    cfg = j_qwen.qwen2_tiny(tie_word_embeddings=False)
    jm = j_qwen.Qwen2ForCausalLM(cfg)
    params = random_params(jax_param_shapes(jm, jnp.ones((1, 8), jnp.int32)), 19)
    params["model"]["layers"]["input_layernorm"]["weight"][:, 5] *= 30.0  # outlier channels
    params["model"]["layers"]["post_attention_layernorm"]["weight"][:, 9] *= 20.0
    ids = np.random.default_rng(20).integers(0, 512, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[2, 7:] = 0  # padded positions count, as in JAX
    calib = jsmooth.collect_norm_absmax(jm, params, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    return jm, params, ids, mask, calib


class TestSmoothQuant:
    def test_calibration_matches_jax(self, smooth_lm):
        _, params, ids, mask, calib = smooth_lm
        model = _port_lm(params, False)
        got = tsmooth.collect_norm_absmax(model, t(ids), attention_mask=t(mask))
        assert sorted(got) == ["attn", "final", "mlp"]
        for key in calib:
            assert tuple(got[key].shape) == calib[key].shape
            np.testing.assert_allclose(got[key].numpy(), calib[key], atol=CALIB_ATOL, err_msg=key)

    @pytest.mark.parametrize("lm_head", [False, True])
    def test_smoothed_tree_and_outputs(self, smooth_lm, lm_head):
        """The smoothed weights against JAX's after the bridge; the float
        model's logits unchanged (and its hidden states, without the
        ``lm_head`` site)."""
        jm, params, ids, mask, calib = smooth_lm
        ref = jax_params_to_torch(jax.device_get(jsmooth.smooth_params_w8a8(params, calib, alpha=0.5,
                                                                              include_lm_head=lm_head)))
        model = _port_lm(params, False)
        with torch.no_grad():
            before = model(t(ids), attention_mask=t(mask))
        tsmooth.smooth_params_w8a8(model, {k: t(v) for k, v in calib.items()}, alpha=0.5, include_lm_head=lm_head)
        state = model.state_dict()
        assert sorted(state) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=SMOOTH_ATOL, rtol=SMOOTH_ATOL, err_msg=k)
        assert not torch.equal(state["model.layers.0.input_layernorm.weight"],
                               jax_params_to_torch(params)["model.layers.0.input_layernorm.weight"])
        with torch.no_grad():
            after = model(t(ids), attention_mask=t(mask))
        np.testing.assert_allclose(after[0].numpy(), before[0].numpy(), atol=FLOAT_ATOL)
        if not lm_head:
            np.testing.assert_allclose(after[1].numpy(), before[1].numpy(), atol=FLOAT_ATOL)

    def test_lm_head_site_refused_when_tied(self, lms):
        model = _port_lm(lms[True], True)
        calib = tsmooth.collect_norm_absmax(model, torch.ones((1, 4), dtype=torch.int64))
        with pytest.raises(ValueError, match="lm_head"):
            tsmooth.smooth_params_w8a8(model, calib, include_lm_head=True)
