"""The port's LoRA adapters against the JAX package on the CPU.

``io/lora.py``, the seven delta sites of ``models/qwen2.py`` and LoRA
training of both policy heads at ``fastvlm-tiny`` in fp32 (64 px tower,
2-layer decoder): JAX adapter trees (non-zero B) cross ``io/bridge.py``
into the port, and both packages take the same numpy-seeded inputs.

Tolerances: logits within 1e-5 (fp32 sums in another order; the tiny
model's logits are of order 1); losses within 1e-5 and adapter-gradient
leaves within 1e-4 of the leaf's largest entry, as ``test_torch_training.py``
holds the head; the adapters after three AdamW updates within 1e-5; a merged
checkpoint within 1e-6 of JAX's ``merge_lora`` (one fp32 rounding of W + A B).
The port draws its own A at init (another generator), so the parity tests
load JAX's adapters; ``init_lora`` is held to JAX's structure and scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.fastvla import FastVLAConfig as JConfig
from vla_fastvlm_tpu.fastvla import FastVLAPolicy as JPolicy
from vla_fastvlm_tpu.fastvla import FastVLMTokenPolicy as JTokenPolicy
from vla_fastvlm_tpu.io import checkpoint as jckpt
from vla_fastvlm_tpu.io import lora as jlora
from vla_fastvlm_tpu.models import fastvlm as j_vlm
from vla_fastvlm_tpu.models import qwen2 as j_qwen
from vla_fastvlm_tpu.training import Trainer as JTrainer
from vla_fastvlm_tpu.training import TrainingConfig as JTrainingConfig
from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy, FastVLMTokenPolicy
from vla_fastvlm_tpu_torch.io import checkpoint as tckpt
from vla_fastvlm_tpu_torch.io.bridge import (
    flatten_params,
    jax_lora_to_torch,
    jax_params_to_torch,
    torch_lora_to_jax,
    torch_params_to_jax,
)
from vla_fastvlm_tpu_torch.io.lora import (
    DEFAULT_LORA_TARGETS,
    init_lora,
    load_lora,
    lora_num_params,
    merge_lora,
)
from vla_fastvlm_tpu_torch.models import fastvlm as t_vlm
from vla_fastvlm_tpu_torch.models import qwen2 as t_qwen
from vla_fastvlm_tpu_torch.training import Trainer, TrainingConfig

from _torch_parity import jax_adapter, random_params, t, tiny_vlm_pair

LOGIT_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
UPDATE_ATOL = 1e-5
MERGE_ATOL = 1e-6
MLP = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", state_dim=6, action_dim=5,
           hidden_dim=16, fusion_dim=16, tokenizer_max_length=16, dropout=0.0, lora_rank=4)
TOKEN = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", state_dim=3, action_dim=4,
             action_head="token", action_bins=64, dropout=0.0, tokenizer_max_length=16, lora_rank=4)
HEADS = {"mlp": (MLP, JPolicy, FastVLAPolicy), "token": (TOKEN, JTokenPolicy, FastVLMTokenPolicy)}


@pytest.fixture(scope="module")
def vlm():
    """The tiny JAX FastVLM, its params, the port's twin and a JAX adapter with non-zero B."""
    jm, params, tm = tiny_vlm_pair(0)
    return jm, params, tm, jax_adapter(params, 4, 7)


def _inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, (b, 8)).astype(np.int32)
    mask = np.ones((b, 8), np.int32)
    mask[1, 5:] = 0
    return rng.random((b, 3, 64, 64), dtype=np.float32), ids, mask


def _jax_policy(head, seed):
    """The JAX policy with seeded random parameters (the adapters' A and B
    too, both non-zero)."""
    kw, jcls, _ = HEADS[head]
    jpolicy = jcls(JConfig(**kw, fabricate_params=True))
    params = random_params(jpolicy.params, seed)
    jpolicy.load_params(params)
    return jpolicy, params


def _policies(head, seed=0):
    jpolicy, params = _jax_policy(head, seed)
    kw, _, tcls = HEADS[head]
    tpolicy = tcls(FastVLAConfig(**kw), device="cpu")
    tpolicy.load_jax_params(params)
    return jpolicy, tpolicy


def _batch(head, b=3, seed=0):
    rng = np.random.default_rng(seed)
    s, a = (6, 5) if head == "mlp" else (3, 4)
    return {"images": rng.random((b, 3, 48, 80), np.float32),
            "states": (rng.standard_normal((b, s)) * 0.5).astype(np.float32),
            "tasks": ["pick", "insert the peg carefully", "push"][:b],
            "actions": np.clip(rng.standard_normal((b, a)) * 0.5, -1, 1).astype(np.float32)}


def _rel_err(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


class TestInitLora:
    def test_structure_shapes_and_scale(self, vlm):
        jm, params, tm, _ = vlm
        ref = jax.tree_util.tree_map(lambda x: x.shape, jax.eval_shape(lambda: jlora.init_lora(
            {"language_model": params["language_model"]}, 16, jax.random.PRNGKey(0))))
        tree = init_lora(tm, 16, seed=0, alpha=32.0)
        assert {k: tuple(v.shape) for k, v in flatten_params(tree).items()} == {
            k: tuple(v) for k, v in flatten_params(ref).items()}
        flat = flatten_params(tree)
        assert all(v.dtype == torch.float32 for v in flat.values())
        assert all(not flat[k].any() for k in flat if k.endswith(".b"))
        for name in DEFAULT_LORA_TARGETS:
            parent = "self_attn" if name in ("q_proj", "k_proj", "v_proj", "o_proj") else "mlp"
            a = flat[f"language_model.layers.{parent}.{name}.a"]
            expect = (32.0 / 16) / np.sqrt(a.shape[1])  # (alpha / rank) / sqrt(fan_in)
            assert abs(float(a.std()) / expect - 1) < 0.1, name
        again = flatten_params(init_lora(tm, 16, seed=0, alpha=32.0))
        assert all(torch.equal(again[k], flat[k]) for k in flat)
        other = flatten_params(init_lora(tm, 16, seed=1))
        assert not torch.equal(other["language_model.layers.self_attn.q_proj.a"],
                               flat["language_model.layers.self_attn.q_proj.a"])
        assert init_lora(tm, 2, dtype=torch.bfloat16)["language_model"]["layers"]["mlp"]["up_proj"]["a"].dtype \
            == torch.bfloat16
        assert lora_num_params(tree) == sum(int(np.prod(s)) for s in flatten_params(ref).values())

    @pytest.mark.parametrize("kw", [dict(rank=4, targets=("embed_tokens",)), dict(rank=0)])
    def test_no_targets_or_rank_raises(self, vlm, kw):
        with pytest.raises(ValueError, match="no LoRA targets|rank must be positive"):
            init_lora(vlm[2], **kw)

    def test_zero_b_is_bit_identical_to_the_base(self, vlm):
        _, _, tm, _ = vlm
        images, ids, mask = (t(x) for x in _inputs())
        lora = init_lora(tm, 4, seed=3)
        with torch.no_grad():
            base, _, _ = tm.forward_logits(images, ids, mask)
            adapted, _, _ = tm.forward_logits(images, ids, mask, lora=lora)
        assert torch.equal(base, adapted)


class TestDecoderSites:
    @pytest.mark.parametrize("path", ["prefill", "dense_decode", "paged_tick"])
    def test_single_adapter_logits_match_jax(self, vlm, path):
        jm, params, tm, lora = vlm
        tlora = jax_lora_to_torch(lora)
        variables = {"params": params, "lora": lora}
        images, ids, mask = _inputs()
        if path == "paged_tick":
            cfg = jm.cfg.text
            rng = np.random.default_rng(3)
            shape = (cfg.num_hidden_layers, 9, cfg.num_key_value_heads, 4, cfg.resolved_head_dim)
            pool_mask = np.zeros((2, 16), bool)
            pool_mask[0, :6] = True
            pool_mask[1, :3] = True
            cache = dict(pool_k=rng.standard_normal(shape).astype(np.float32),
                         pool_v=rng.standard_normal(shape).astype(np.float32),
                         tables=np.array([[1, 4, 0, 0], [2, 0, 0, 0]], np.int32), mask=pool_mask,
                         index=np.array([6, 3], np.int32))
            tokens = np.array([[5], [17]], np.int32)
            jout, _ = jax.jit(lambda v, x, c: jm.apply(v, x, c, method=j_vlm.FastVLM.decode_step_paged))(
                variables, jnp.asarray(tokens), {k: jnp.asarray(v) for k, v in cache.items()})
            with torch.no_grad():
                tout, _ = tm.decode_step_paged(t(tokens), {k: t(v) for k, v in cache.items()}, lora=tlora)
            np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=LOGIT_ATOL)
            return
        max_len = jm.cfg.num_image_tokens + ids.shape[1] + 2
        jcache = j_qwen.init_kv_cache(jm.cfg.text, 2, max_len)
        jlast, _, jcache, _, _ = jax.jit(lambda v, *a: jm.apply(v, *a, method=j_vlm.FastVLM.prefill))(
            variables, jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask), jcache)
        tcache = t_qwen.init_kv_cache(tm.cfg.text, 2, max_len)
        with torch.no_grad():
            tlast, _, tcache, _, _ = tm.prefill(t(images), t(ids), t(mask), tcache, lora=tlora)
        if path == "prefill":
            np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=LOGIT_ATOL)
            return
        tok = np.asarray(jnp.argmax(jlast, axis=-1)).astype(np.int32)[:, None]
        jlogits, _ = jax.jit(lambda v, x, c: jm.apply(v, x, c, method=j_vlm.FastVLM.decode_step))(
            variables, jnp.asarray(tok), jcache)
        with torch.no_grad():
            tlogits, _ = tm.decode_step(t(tok), tcache, lora=tlora)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL)

    def test_runtime_matches_merge_lora(self, vlm):
        """Adapters mounted at run time against the same adapters folded into
        the weights (``merge_lora`` on the JAX-layout tree, loaded back)."""
        _, _, tm, lora = vlm
        tlora = jax_lora_to_torch(lora)
        merged = merge_lora(torch_params_to_jax(tm, as_numpy=False), tlora)
        folded = t_vlm.FastVLM(tm.cfg)
        folded.load_state_dict(jax_params_to_torch(merged), strict=True)
        images, ids, mask = (t(x) for x in _inputs(seed=4))
        with torch.no_grad():
            runtime, _, _ = tm.forward_logits(images, ids, mask, lora=tlora)
            base, _, _ = tm.forward_logits(images, ids, mask)
            offline, _, _ = folded.forward_logits(images, ids, mask)
        np.testing.assert_allclose(runtime.numpy(), offline.numpy(), atol=LOGIT_ATOL)
        assert float((runtime - base).abs().max()) > 100 * LOGIT_ATOL  # the adapter moves the logits

    def test_merge_refuses_a_quantized_kernel(self):
        params = {"layers": {"mlp": {"up_proj": {"kernel": torch.zeros((1, 4, 6), dtype=torch.int8)}}}}
        lora = {"layers": {"mlp": {"up_proj": {"a": torch.zeros(1, 4, 2), "b": torch.zeros(1, 2, 6)}}}}
        with pytest.raises(TypeError, match="quantized"):
            merge_lora(params, lora)

    def test_bridge_roundtrip_scanned_and_unscanned(self, vlm):
        lora = vlm[3]
        tlora = jax_lora_to_torch(lora)
        back = torch_lora_to_jax(tlora)
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, jax.device_get(lora), back))
        unscanned = torch_lora_to_jax(tlora, scanned=False)
        assert sorted(unscanned["language_model"]) == ["layers_0", "layers_1"]
        again = flatten_params(jax_lora_to_torch(unscanned))
        assert all(torch.equal(again[k], v) for k, v in flatten_params(tlora).items())


class TestPolicies:
    @pytest.mark.parametrize("head", ["mlp", "token"])
    def test_at_init_b_takes_a_gradient_and_a_none(self, head):
        kw, _, tcls = HEADS[head]
        policy = tcls(FastVLAConfig(**kw), device="cpu")
        assert set(policy.trainable_params()) == ({"head", "lora"} if head == "mlp" else {"lora"})
        assert not any(p.requires_grad for p in policy.backbone.model.parameters()) if head == "token" else \
            not any(p.requires_grad for p in policy.model.backbone.model.parameters())
        loss, _ = policy.loss_fn(policy.to_device(policy.prepare_batch(_batch(head))), train=True)
        loss.backward()
        grads = {n: p.grad for n, p in policy.trainable_params()["lora"].items()}
        assert all(grads[n] is not None and grads[n].abs().max() > 0 for n in grads if n.endswith(".b"))
        assert all(grads[n] is None or not grads[n].any() for n in grads if n.endswith(".a"))

    @pytest.mark.parametrize("head", ["mlp", "token"])
    def test_lora_with_full_backbone_training_raises(self, head):
        kw, _, tcls = HEADS[head]
        with pytest.raises(ValueError, match="contradictory"):
            tcls(FastVLAConfig(**kw, train_backbone=True, freeze_backbone=False), device="cpu")

    @pytest.mark.parametrize("head", ["mlp", "token"])
    def test_loss_and_adapter_gradients_match_jax(self, head):
        jpolicy, tpolicy = _policies(head, seed=2)
        batch = _batch(head, seed=5)
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
            err = _rel_err(got[name].grad.numpy(), value.numpy())
            assert err <= GRAD_RTOL, f"{name}: rel err {err:.2e}"

    @pytest.mark.parametrize("head", ["mlp", "token"])
    def test_three_updates_match_jax(self, head):
        """Three AdamW updates of the port's trainer against the JAX
        trainer's optax chain: the adapters (and the MLP head) after them,
        the base unmoved. Adam's eps is 1e-4 on both sides: at the default
        1e-8 an entry whose gradient is near 1e-8 takes a step of
        ``lr * g / (|g| + eps)``, which turns the fp32 noise of its gradient
        (the 1e-4 gradient tolerance) into steps apart by up to ``lr``."""
        jpolicy, tpolicy = _policies(head, seed=4)
        batches = [_batch(head, b=2, seed=10 + i) for i in range(3)]
        settings = dict(max_steps=10, warmup_ratio=0.0, learning_rate=1e-2, max_grad_norm=1.0, eps=1e-4,
                        report_to=[], mixed_precision=None)
        jtrainer = JTrainer(jpolicy, batches, None, JTrainingConfig(**settings))
        trainable, opt_state, rng = jtrainer.trainable, jtrainer.opt_state, jax.random.PRNGKey(0)
        ttrainer = Trainer(tpolicy, batches, None, TrainingConfig(**settings))
        base = {k: v.clone() for k, v in tpolicy.params["backbone"].items()}
        for batch in batches:
            trainable, opt_state, jm = jtrainer._train_step(trainable, opt_state, jtrainer.frozen,
                                                             jpolicy.prepare_batch(batch), rng)
            tm = ttrainer._train_step(ttrainer._place_batch(batch))
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        expect = flatten_params(jax_lora_to_torch(jax.device_get(trainable["lora"])))
        for name, value in tpolicy.trainable_params()["lora"].items():
            np.testing.assert_allclose(value.detach().numpy(), expect[name].numpy(), atol=UPDATE_ATOL, err_msg=name)
        if head == "mlp":
            head_ref = jax_params_to_torch(jax.device_get(trainable["head"]))
            for name, value in tpolicy.model.head.state_dict().items():
                np.testing.assert_allclose(value.numpy(), head_ref[name].numpy(), atol=UPDATE_ATOL, err_msg=name)
        assert all(torch.equal(v, base[k]) for k, v in tpolicy.params["backbone"].items())


class TestCheckpoints:
    @pytest.mark.parametrize("head", ["mlp", "token"])
    def test_lora_checkpoints_cross_both_ways(self, head, tmp_path):
        jpolicy, params = _jax_policy(head, seed=6)
        jckpt.save_policy_checkpoint(tmp_path / "jax", jpolicy.config, jax.device_get(jpolicy.params))
        tpolicy, _ = tckpt.load_policy_from_checkpoint(tmp_path / "jax", device="cpu")
        ref = flatten_params(jax_lora_to_torch(params["lora"]))
        got = tpolicy.trainable_params()["lora"]
        assert all(torch.equal(got[k].detach(), ref[k]) for k in ref)
        assert all(torch.equal(v, ref[k]) for k, v in flatten_params(load_lora(tmp_path / "jax")).items())
        with torch.no_grad():  # the port's trained adapters, back into the JAX package
            for p in got.values():
                p.mul_(1.5)
        tckpt.save_policy_checkpoint(tmp_path / "port", tpolicy.config, tpolicy.jax_params(as_numpy=False))
        jback, _ = jckpt.load_policy_from_checkpoint(tmp_path / "port")
        assert jback.config.lora_rank == 4
        jflat = flatten_params(jax_lora_to_torch(jax.device_get(jback.params["lora"])))
        assert all(torch.equal(jflat[k], got[k].detach()) for k in got)
        np.testing.assert_allclose(np.asarray(jlora.load_lora(tmp_path / "port")["language_model"]["layers"]["mlp"][
            "up_proj"]["a"]), got["language_model.layers.mlp.up_proj.a"].detach().numpy())

    def test_merge_lora_cli_matches_jax(self, tmp_path, monkeypatch, capsys):
        from vla_fastvlm_tpu_torch.scripts import merge_lora as cli

        jpolicy, params = _jax_policy("mlp", seed=8)
        jckpt.save_policy_checkpoint(tmp_path / "ckpt", jpolicy.config, jax.device_get(jpolicy.params))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(cli.MergeArgs(checkpoint=str(tmp_path / "ckpt"), output=str(tmp_path / "out")))
        summary = cli.main(cli.MergeArgs(checkpoint=str(tmp_path / "ckpt"), output=str(tmp_path / "out"),
                                         device="cpu"))
        assert summary["adapter_params"] == jlora.lora_num_params(params["lora"])
        config, merged = jckpt.load_policy_state(tmp_path / "out")
        assert config["lora_rank"] == 0 and "lora" not in merged
        ref = jax.device_get(jlora.merge_lora(params["backbone"], params["lora"]))
        flat_ref, flat_got = jckpt.flatten_params(ref), jckpt.flatten_params(merged["backbone"])
        assert sorted(flat_ref) == sorted(flat_got)
        for name, value in flat_ref.items():
            np.testing.assert_allclose(np.asarray(flat_got[name]), np.asarray(value), atol=MERGE_ATOL, err_msg=name)
        policy, _ = tckpt.load_policy_from_checkpoint(tmp_path / "out", device="cpu")
        assert policy.model.lora is None
