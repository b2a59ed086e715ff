"""Parity of the PyTorch port's modules with the JAX package on the CPU.

Each JAX module gets seeded random parameters at realistic scales
(``_torch_parity.random_params``), moved across by the weight bridge (``io/bridge.py``) and loaded strictly into
the port's module. Both run on the same numpy inputs in fp32; tolerances
are fp32 with the reason beside each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from pathlib import Path

from vla_fastvlm_tpu.models import action_head as j_head
from vla_fastvlm_tpu.models import fastvit as j_vit
from vla_fastvlm_tpu.models import fastvlm as j_vlm
from vla_fastvlm_tpu.models import qwen2 as j_qwen
from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch
from vla_fastvlm_tpu_torch.models import action_head as t_head
from vla_fastvlm_tpu_torch.models import fastvit as t_vit
from vla_fastvlm_tpu_torch.models import fastvlm as t_vlm
from vla_fastvlm_tpu_torch.models import qwen2 as t_qwen
from vla_fastvlm_tpu_torch.models.layers import same_padding

from _torch_parity import jax_param_shapes, random_params, t

GOLDEN = Path(__file__).parent / "golden"


def bridged(jmod, tmod, *inputs, seed=0, **kw):
    """Random JAX params for ``jmod`` on ``inputs``, loaded strictly into ``tmod``."""
    params = random_params(jax_param_shapes(jmod, *[jnp.asarray(x) for x in inputs], **kw), seed)
    tmod.load_state_dict(jax_params_to_torch(params), strict=True)
    tmod.eval()
    return params


def run_both(jmod, tmod, inputs, seed=0):
    params = bridged(jmod, tmod, *inputs, seed=seed)
    apply = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))
    ref = apply(params, *[jnp.asarray(x) for x in inputs])
    with torch.no_grad():
        out = tmod(*[t(x) for x in inputs])
    return out, ref


class TestSamePadding:
    """XLA pads stride-2 SAME convs asymmetrically on even inputs."""

    @pytest.mark.parametrize(
        "size,kernel,stride,expect",
        [(256, 3, 2, (0, 1)), (256, 7, 2, (2, 3)), (255, 3, 2, (1, 1)), (64, 7, 1, (3, 3))],
    )
    def test_pads(self, size, kernel, stride, expect):
        assert same_padding(size, kernel, stride) == expect


VIT = j_vit.FastViTHDConfig(embed_dims=(8, 16, 24, 32, 48), depths=(1, 1, 1, 1, 1),
                            attn_head_dim=16, block_impl="xla")
TVIT = t_vit.FastViTHDConfig(embed_dims=(8, 16, 24, 32, 48), depths=(1, 1, 1, 1, 1),
                             attn_head_dim=16)
# fp32 convs / dense layers of a few dozen terms each, a few layers deep.
VIT_ATOL = 2e-5


class TestVisionModules:
    @pytest.mark.parametrize(
        "cin,feat,kernel,stride,groups,hw",
        [
            (3, 8, 3, 2, 1, 16),  # stem_0: stride-2 SAME on an even input
            (8, 8, 3, 2, 8, 16),  # stem_1: depthwise stride 2
            (3, 8, 3, 2, 1, 15),  # odd input: symmetric padding
            (8, 16, 1, 1, 1, 8),  # 1x1 ConvAct stored as a Dense
            (16, 48, 3, 1, 16, 4),  # conv_exp: grouped expansion
        ],
    )
    def test_conv_act(self, cin, feat, kernel, stride, groups, hw):
        x = np.random.default_rng(1).standard_normal((2, hw, hw, cin)).astype(np.float32)
        jm = j_vit.ConvAct(feat, kernel, stride, groups)
        tm = t_vit.ConvAct(cin, feat, kernel, stride, groups)
        out, ref = run_both(jm, tm, [x])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=VIT_ATOL)

    @pytest.mark.parametrize("cin,feat,hw", [(8, 16, 16), (16, 24, 8), (6, 9, 10)])
    def test_patch_embed_grouped_stride2(self, cin, feat, hw):
        x = np.random.default_rng(2).standard_normal((2, hw, hw, cin)).astype(np.float32)
        out, ref = run_both(j_vit.PatchEmbed(feat, VIT), t_vit.PatchEmbed(cin, feat, TVIT), [x])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=VIT_ATOL)

    @pytest.mark.parametrize("kernel", [3, 7])
    def test_rep_dw_conv(self, kernel):
        x = np.random.default_rng(3).standard_normal((2, 8, 8, 16)).astype(np.float32)
        out, ref = run_both(j_vit.RepDWConv(kernel), t_vit.RepDWConv(16, kernel), [x])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=VIT_ATOL)

    def test_conv_ffn(self):
        x = np.random.default_rng(4).standard_normal((2, 8, 8, 16)).astype(np.float32)
        out, ref = run_both(j_vit.ConvFFN(64, VIT), t_vit.ConvFFN(16, 64, TVIT), [x])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=VIT_ATOL)

    @pytest.mark.parametrize("impl", ["auto", "fused", "xla"])
    def test_repmixer_block(self, impl):
        """Every block_impl on the CPU: the unfused modules or the kernel's plain version."""
        x = np.random.default_rng(5).standard_normal((2, 8, 8, 32)).astype(np.float32)
        tm = t_vit.RepMixerBlock(32, TVIT.replace(block_impl=impl), 4.0)
        out, ref = run_both(j_vit.RepMixerBlock(VIT, 4.0), tm, [x])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=VIT_ATOL)

    def test_attention_block(self):
        x = np.random.default_rng(6).standard_normal((2, 4, 4, 32)).astype(np.float32)
        out, ref = run_both(j_vit.AttentionBlock(VIT, 4.0), t_vit.AttentionBlock(32, TVIT, 4.0), [x])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=VIT_ATOL)

    def test_fastvithd_tiny_token_order(self):
        """Whole tower at 64 px; tokens are row-major over NHWC in both."""
        x = np.random.default_rng(7).random((2, 3, 64, 64), dtype=np.float32)
        tm = t_vit.FastViTHD(TVIT)
        out, ref = run_both(j_vit.FastViTHD(VIT), tm, [x])
        assert out.shape == (2, 1, 96)
        # ~20 conv/dense layers deep in fp32
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
        with torch.no_grad():  # NHWC input is detected and gives the same tokens
            nhwc = tm(t(x).permute(0, 2, 3, 1).contiguous())
        np.testing.assert_allclose(nhwc.numpy(), out.numpy(), atol=1e-6)


QWEN_ATOL = 5e-5  # two fp32 decoder layers, softmax and RMSNorm in fp32


class TestQwen2:
    @pytest.mark.parametrize("tied", [True, False])
    def test_causal_lm_logits_and_hidden(self, tied):
        rng = np.random.default_rng(8)
        ids = rng.integers(0, 512, (2, 12)).astype(np.int32)
        mask = np.ones((2, 12), np.int32)
        mask[1, 9:] = 0  # right padding
        jcfg = j_qwen.qwen2_tiny(tie_word_embeddings=tied)
        tcfg = t_qwen.qwen2_tiny(tie_word_embeddings=tied)
        jm, tm = j_qwen.Qwen2ForCausalLM(jcfg), t_qwen.Qwen2ForCausalLM(tcfg)
        params = bridged(jm, tm, ids, attention_mask=jnp.asarray(mask))
        apply = jax.jit(lambda p, i, m: jm.apply({"params": p}, i, attention_mask=m))
        jlogits, jhidden, _ = apply(params, jnp.asarray(ids), jnp.asarray(mask))
        with torch.no_grad():
            tlogits, thidden, _ = tm(t(ids), attention_mask=t(mask))
        np.testing.assert_allclose(thidden.numpy(), np.asarray(jhidden), atol=QWEN_ATOL)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=QWEN_ATOL)

    def test_unscanned_layers_bridge(self):
        """A JAX decoder built with scan_layers=False names layers layers_<i>."""
        ids = np.random.default_rng(9).integers(0, 512, (1, 6)).astype(np.int32)
        jm = j_qwen.Qwen2ForCausalLM(j_qwen.qwen2_tiny(scan_layers=False))
        tm = t_qwen.Qwen2ForCausalLM(t_qwen.qwen2_tiny())
        out, ref = run_both(jm, tm, [ids])
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=QWEN_ATOL)

    def test_xla_impl_matches_auto(self):
        ids = np.random.default_rng(10).integers(0, 512, (2, 5)).astype(np.int32)
        a = t_qwen.Qwen2ForCausalLM(t_qwen.qwen2_tiny())
        b = t_qwen.Qwen2ForCausalLM(t_qwen.qwen2_tiny(attention_impl="xla"))
        from vla_fastvlm_tpu_torch.models import init_weights

        init_weights(a, torch.Generator().manual_seed(0))
        b.load_state_dict(a.state_dict())
        with torch.no_grad():
            np.testing.assert_allclose(a(t(ids))[0].numpy(), b(t(ids))[0].numpy(), atol=1e-6)

    def test_rejects_unported_quantization(self):
        """An unknown mode raises; an int8 model builds, quantizes and runs."""
        with pytest.raises(ValueError, match="unknown quantization"):
            t_qwen.Qwen2Model(t_qwen.qwen2_tiny(quantization="int5"))
        from vla_fastvlm_tpu_torch.io.quantize import count_quantized, quantize_params
        from vla_fastvlm_tpu_torch.models import init_weights

        model = t_qwen.Qwen2ForCausalLM(t_qwen.qwen2_tiny(quantization="int8"))
        init_weights(model, torch.Generator().manual_seed(0))
        quantize_params(model, mode="int8")
        assert count_quantized(model) == 7
        with torch.no_grad():
            logits = model(t(np.arange(5, dtype=np.int32)[None]))[0]
        assert logits.shape == (1, 5, 512) and bool(torch.isfinite(logits).all())


class TestHeads:
    def test_mm_projector(self):
        x = np.random.default_rng(11).standard_normal((2, 4, 48)).astype(np.float32)
        out, ref = run_both(j_vlm.MMProjector(64), t_vlm.MMProjector(48, 64), [x])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)

    def test_action_expert_head(self):
        rng = np.random.default_rng(12)
        f = rng.standard_normal((3, 24)).astype(np.float32)
        s = rng.standard_normal((3, 6)).astype(np.float32)
        jm = j_head.ActionExpertHead(state_dim=6, action_dim=5, hidden_dim=16, fusion_dim=20)
        tm = t_head.ActionExpertHead(24, 6, 5, 16, 20)
        out, ref = run_both(jm, tm, [f, s])
        # LayerNorm epsilon 1e-6 on both sides
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)

    def test_action_chunk_head(self):
        rng = np.random.default_rng(13)
        f = rng.standard_normal((2, 24)).astype(np.float32)
        s = rng.standard_normal((2, 6)).astype(np.float32)
        jm = j_head.ActionChunkHead(state_dim=6, action_dim=5, chunk_size=4, hidden_dim=16, fusion_dim=20)
        tm = t_head.ActionChunkHead(24, 6, 5, 4, 16, 20)
        out, ref = run_both(jm, tm, [f, s])
        assert out.shape == (2, 4, 5)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)

    def test_head_golden(self):
        """Recorded reference torch head (state_projection/fusion/action_head)."""
        data = np.load(GOLDEN / "head.npz")
        w = lambda k: data["w__" + k.replace(".", "__")]
        lin = lambda k: {"kernel": w(f"{k}.weight").T, "bias": w(f"{k}.bias")}
        ln = lambda k: {"scale": w(f"{k}.weight"), "bias": w(f"{k}.bias")}
        params = {
            "state_norm": ln("state_projection.0"), "state_proj": lin("state_projection.1"),
            "fusion_fc1": lin("fusion.0"), "fusion_norm": ln("fusion.1"),
            "fusion_fc2": lin("fusion.4"), "action_head": lin("action_head"),
        }
        feat_dim = data["features"].shape[-1]
        head = t_head.ActionExpertHead(feat_dim, 6, 5, 32, 48).eval()
        head.load_state_dict(jax_params_to_torch(params), strict=True)
        with torch.no_grad():
            pred = head(t(data["features"]), t(data["states"]))
        np.testing.assert_allclose(pred.numpy(), data["pred"], atol=1e-5)
        mse = ((pred - t(data["actions_gt"])) ** 2).mean()
        np.testing.assert_allclose(float(mse), float(data["mse"]), atol=1e-6)


class TestPooling:
    @pytest.mark.parametrize("mode", ["last_token", "mean_pool"])
    def test_pool_hidden_golden(self, mode):
        data = np.load(GOLDEN / "pool_hidden.npz")
        hidden, mask = t(data["hidden"]), t(data["mask"])
        np.testing.assert_allclose(t_vlm.pool_hidden(hidden, mask, mode).numpy(),
                                   data[f"{mode}_masked"], atol=1e-6)
        np.testing.assert_allclose(t_vlm.pool_hidden(hidden, None, mode).numpy(),
                                   data[f"{mode}_nomask"], atol=1e-6)

    def test_pool_last_text_token(self):
        rng = np.random.default_rng(14)
        hidden = rng.standard_normal((3, 10, 4)).astype(np.float32)
        text_mask = np.zeros((3, 10), np.int32)
        text_mask[0, 4:9] = 1
        text_mask[1, 4:] = 1
        ref = j_vlm.pool_last_text_token(jnp.asarray(hidden), jnp.asarray(text_mask))
        out = t_vlm.pool_last_text_token(t(hidden), t(text_mask))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
