"""The port's action-token policy against the JAX package on the CPU.

``models/action_tokens.py`` and ``fastvla/token_policy.py`` at
``fastvlm-tiny`` in fp32 (64 px tower, 2-layer decoder, vocab 512, 64 bins):
seeded random JAX parameters cross the weight bridge into the port, and both
packages take the same numpy-seeded observations (frames of 48 x 80, which
the letterbox resizes to 64).

Tolerances: the codec, ``prepare_batch``'s arrays and the greedy tokens are
equal; the loss, mse and token accuracy agree to 1e-5 and the first
prefill's logits to relative 1e-5 (fp32 sums in another order through the
tower and 2 decoder layers, far from the argmax's ties); gradient leaves to
1e-4 of the leaf's largest entry, as ``test_torch_training.py`` holds them.
Checkpoints cross both ways with equal actions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.fastvla import FastVLAConfig as JConfig
from vla_fastvlm_tpu.fastvla import FastVLMTokenPolicy as JTokenPolicy
from vla_fastvlm_tpu.io import checkpoint as jckpt
from vla_fastvlm_tpu.model.fastvlm_adapter import prepare_policy_images as j_prepare_images
from vla_fastvlm_tpu.models.action_tokens import ActionTokenizer as JTokenizer
from vla_fastvlm_tpu.models.fastvlm import FastVLM as JFastVLM
from vla_fastvlm_tpu.serving.generate import build_cache as j_build_cache
from vla_fastvlm_tpu.serving.generate import generate as j_generate
from vla_fastvlm_tpu_torch.data import AlohaDataset, SyntheticAlohaSource, create_aloha_dataloader
from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLMTokenPolicy, FastVLMWithExpert
from vla_fastvlm_tpu_torch.io import checkpoint as tckpt
from vla_fastvlm_tpu_torch.io.bridge import flatten_params, jax_params_to_torch
from vla_fastvlm_tpu_torch.model.fastvlm_adapter import prepare_policy_images
from vla_fastvlm_tpu_torch.models.action_tokens import ActionTokenizer
from vla_fastvlm_tpu_torch.models.qwen2 import init_kv_cache
from vla_fastvlm_tpu_torch.training import Trainer, TrainingConfig

from _torch_parity import random_params

TINY = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", state_dim=3, action_dim=4,
            action_head="token", action_bins=64, dropout=0.0, tokenizer_max_length=16)
# Multi-camera and chunked variants of the token head, as the JAX tests run them.
VARIANTS = {"base": {}, "chunk3": dict(chunk_size=3), "multicam": dict(num_cameras=2)}
METRIC_ATOL = 1e-5
LOGITS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _policies(seed=0, **kw):
    """The JAX token policy with seeded random parameters and the port's with the same."""
    jpolicy = JTokenPolicy(JConfig(**TINY, fabricate_params=True, **kw))
    params = random_params(jpolicy.params, seed)
    jpolicy.load_params(params)
    tpolicy = FastVLMTokenPolicy(FastVLAConfig(**TINY, **kw), device="cpu")
    tpolicy.load_jax_params(params)
    return jpolicy, tpolicy


def _batch(b=3, seed=0, chunk=1, ncam=1, horizon=None):
    rng = np.random.default_rng(seed)
    cams = (ncam,) if ncam > 1 else ()
    steps = (horizon,) if horizon else ((chunk,) if chunk > 1 else ())
    return {
        "images": rng.random((b,) + cams + (3, 48, 80), np.float32),
        "states": (rng.standard_normal((b, 3)) * 0.5).astype(np.float32),
        # ragged prompts: different true lengths exercise the packing
        "tasks": ["pick", "insert the peg carefully", "push"][:b],
        "actions": np.clip(rng.standard_normal((b,) + steps + (4,)) * 0.5, -1, 1).astype(np.float32),
    }


def _variant_batch(name, b=3, seed=0):
    kw = VARIANTS[name]
    return _batch(b, seed, chunk=kw.get("chunk_size", 1), ncam=kw.get("num_cameras", 1))


class TestActionTokenizer:
    def test_codec_equals_jax(self):
        rng = np.random.default_rng(0)
        values = np.concatenate([rng.uniform(-1.5, 1.5, 398), np.linspace(-1, 1, 33), [-1.0, 1.0, 0.0]])
        values = values.astype(np.float32).reshape(-1, 7)
        ids = rng.integers(-20, 600, (9, 5))
        for kw in (dict(vocab_size=512, num_bins=64), dict(vocab_size=151936, num_bins=256, low=-2.0, high=0.5)):
            tok, jtok = ActionTokenizer(**kw), JTokenizer(**kw)
            assert (tok.base_id, tok.bin_width) == (jtok.base_id, jtok.bin_width)
            np.testing.assert_array_equal(tok.encode(values), jtok.encode(values))
            np.testing.assert_array_equal(tok.decode(ids), jtok.decode(ids))
            np.testing.assert_array_equal(tok.decode(tok.encode(values)), jtok.decode(jtok.encode(values)))
            out = tok.decode_torch(torch.from_numpy(ids))
            assert out.dtype == torch.float32
            np.testing.assert_array_equal(out.numpy(), np.asarray(jtok.decode_jnp(jnp.asarray(ids))))

    def test_roundtrip_within_half_bin_and_strays_clip(self):
        tok = ActionTokenizer(vocab_size=512, num_bins=128)
        vals = np.linspace(-1.0, 1.0, 37, dtype=np.float32).reshape(1, 37)
        assert np.all(np.abs(tok.decode(tok.encode(vals)) - vals) <= tok.bin_width / 2 + 1e-6)
        assert tok.decode(np.array([0]))[0] == tok.decode(np.array([tok.base_id]))[0]
        assert tok.decode(np.array([10_000]))[0] == tok.decode(np.array([511]))[0]

    @pytest.mark.parametrize("kw", [dict(vocab_size=512, num_bins=1), dict(vocab_size=128, num_bins=256),
                                    dict(vocab_size=512, num_bins=8, low=1.0, high=-1.0)])
    def test_validation(self, kw):
        with pytest.raises(ValueError):
            JTokenizer(**kw)
        with pytest.raises(ValueError):
            ActionTokenizer(**kw)


class TestPrepareBatch:
    @pytest.mark.parametrize("variant", ["base", "chunk3", "multicam", "time-major"])
    def test_arrays_equal_jax(self, variant):
        kw = VARIANTS.get(variant, {})
        jpolicy, tpolicy = _policies(**kw)
        batch = _batch(horizon=5) if variant == "time-major" else _variant_batch(variant)
        ref, out = jpolicy.prepare_batch(batch), tpolicy.prepare_batch(batch)
        assert sorted(out) == sorted(ref) == ["action_tokens", "actions", "attention_mask", "images", "input_ids"]
        for key in ref:
            np.testing.assert_array_equal(out[key], np.asarray(ref[key]), err_msg=key)
        # right-packed: each row's state and action tokens sit at its true prompt end
        assert (out["attention_mask"].sum(1) < out["attention_mask"].shape[1]).any()

    def test_chunk_needs_time_major_targets(self):
        _, policy = _policies(chunk_size=2)
        batch = _batch()  # (B, D) actions: no time axis
        with pytest.raises(ValueError, match="time-major"):
            policy.prepare_batch(batch)


class TestLoss:
    @pytest.mark.parametrize("variant", list(VARIANTS))
    @pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
    def test_loss_matches_jax(self, variant, train):
        jpolicy, tpolicy = _policies(seed=1, **VARIANTS[variant])
        batch = _variant_batch(variant, seed=2)
        jloss, jm = jax.jit(lambda p, a: jpolicy.loss_fn({}, p, a))(jpolicy.params, jpolicy.prepare_batch(batch))
        tpolicy.backbone.model.requires_grad_(train)  # as the Trainer does
        loss, metrics = tpolicy.loss_fn(tpolicy.to_device(tpolicy.prepare_batch(batch)), train=train)
        assert set(metrics) == set(jm) == {"loss", "mse", "token_accuracy"}
        assert loss.requires_grad == train
        for key in jm:
            np.testing.assert_allclose(float(metrics[key].detach()), float(jm[key]), atol=METRIC_ATOL, err_msg=key)
        np.testing.assert_allclose(float(tpolicy.compute_loss(batch)["loss"]), float(jloss), atol=METRIC_ATOL)

    def test_gradients_match_jax_grad(self):
        """With ``train_backbone`` every backbone leaf's gradient of the CE."""
        jpolicy, tpolicy = _policies(seed=3, train_backbone=True)
        batch = _batch(seed=4)
        grad_fn = jax.jit(jax.grad(lambda tr, a: jpolicy.loss_fn(tr, {}, a, train=True)[0]))
        jgrads = jax.device_get(grad_fn(jpolicy.trainable_params(), jpolicy.prepare_batch(batch)))
        params = tpolicy.trainable_params()["backbone"]
        for p in params.values():  # as the Trainer does
            p.requires_grad_(True)
        loss, _ = tpolicy.loss_fn(tpolicy.to_device(tpolicy.prepare_batch(batch)), train=True)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                                     materialize_grads=True)))
        expect = jax_params_to_torch(jgrads["backbone"])
        assert sorted(expect) == sorted(grads)
        for name, ref in expect.items():
            err = float(np.abs(grads[name].numpy() - ref.numpy()).max() / max(np.abs(ref.numpy()).max(), 1e-12))
            assert err <= GRAD_RTOL, f"{name}: rel err {err:.2e}"


class TestForward:
    @pytest.mark.parametrize("variant", list(VARIANTS))
    def test_tokens_and_actions_equal_jax(self, variant):
        jpolicy, tpolicy = _policies(seed=5, **VARIANTS[variant])
        batch = _variant_batch(variant, seed=6)
        obs = (batch["images"], batch["states"], batch["tasks"])
        ref_actions = np.asarray(jpolicy.forward(*obs))
        actions = tpolicy.forward(*obs)
        assert tuple(actions.shape) == ref_actions.shape
        np.testing.assert_array_equal(actions.numpy(), ref_actions)

        # The tokens behind them (JAX's _predict_fn before the decode), and
        # the first prefill's logits, so that a tie cannot hide a fault.
        tasks = tpolicy.processor.prepare_tasks(batch["tasks"], 3)
        ids, mask = tpolicy.prompt_arrays(tasks, batch["states"])
        jm, jb, jmodel = jpolicy.backbone.model_config, jpolicy.backbone.config, jpolicy.backbone.model

        @jax.jit
        def reference(params, images, ids, mask):
            images = j_prepare_images(images, jm, jb)
            tokens = j_generate(jmodel, params, images, ids, mask, max_new_tokens=tpolicy.num_action_tokens,
                                eos_token_id=-1)
            cache = j_build_cache(jm, ids.shape[0], ids.shape[1], 1)
            return tokens, jmodel.apply({"params": params}, images, ids, mask, cache, method=JFastVLM.prefill)[0]

        ref_tokens, ref_logits = jax.device_get(reference(jpolicy.params["backbone"], batch["images"], ids, mask))
        tokens = tpolicy.tokens(*obs)
        assert tokens.shape == (3, tpolicy.num_action_tokens)
        np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
        model = tpolicy.backbone.model
        with torch.no_grad():
            images = prepare_policy_images(torch.from_numpy(batch["images"]), model.cfg, tpolicy.backbone.config)
            cache = init_kv_cache(model.cfg.text, 3, model.cfg.num_image_tokens + ids.shape[1] + 1)
            logits = model.prefill(images, torch.from_numpy(ids), torch.from_numpy(mask), cache)[0]
        rel = float(np.linalg.norm(logits.numpy() - ref_logits) / np.linalg.norm(ref_logits))
        assert rel <= LOGITS_RTOL, rel

    def test_select_action_and_reset(self):
        jpolicy, tpolicy = _policies(seed=7)
        batch = _batch(seed=8)
        ref = np.asarray(jpolicy.select_action(batch["images"][1], batch["states"][1], batch["tasks"][1]))
        out = tpolicy.select_action(torch.from_numpy(batch["images"][1]), batch["states"][1], batch["tasks"][1])
        np.testing.assert_array_equal(out.numpy(), ref)
        tpolicy.reset()


class TestSurface:
    def test_parameter_split(self):
        policy = FastVLMTokenPolicy(FastVLAConfig(**TINY), device="cpu")
        with pytest.raises(ValueError, match="no head parameters"):
            policy.trainable_params()
        full = FastVLMTokenPolicy(FastVLAConfig(**TINY, train_backbone=True), device="cpu")
        assert set(full.trainable_params()) == {"backbone"} and full.frozen_params() == {}
        assert full.merge_trainable(full.trainable_params()).keys() == {"backbone"}
        assert set(full.jax_params()) == {"backbone"}

    def test_refusals(self):
        with pytest.raises(ValueError, match="contradictory"):  # LoRA over a base that trains too
            FastVLMTokenPolicy(FastVLAConfig(**TINY, lora_rank=4, train_backbone=True, freeze_backbone=False),
                               device="cpu")
        with pytest.raises(ValueError, match="action_head='token'"):
            FastVLMTokenPolicy(FastVLAConfig(**dict(TINY, action_head="mlp")), device="cpu")
        with pytest.raises(ValueError, match="FastVLMTokenPolicy"):
            FastVLMWithExpert(FastVLAConfig(**TINY), device="cpu")


class TestCheckpoints:
    def test_jax_checkpoint_loads_into_the_port(self, tmp_path):
        jpolicy, _ = _policies(seed=9)
        jckpt.save_policy_checkpoint(tmp_path, jpolicy.config, jpolicy.params)
        policy, device = tckpt.load_policy_from_checkpoint(tmp_path, device="cpu")
        assert isinstance(policy, FastVLMTokenPolicy) and device == torch.device("cpu")
        batch = _batch(seed=10)
        obs = (batch["images"], batch["states"], batch["tasks"])
        np.testing.assert_array_equal(policy.forward(*obs).numpy(), np.asarray(jpolicy.forward(*obs)))
        loose, _ = tckpt.load_policy_from_checkpoint(tmp_path, device="cpu", strict=False)
        np.testing.assert_array_equal(loose.forward(*obs).numpy(), policy.forward(*obs).numpy())

    def test_trainer_checkpoint_round_trip(self, tmp_path):
        """Two ``Trainer`` steps of the token head with ``train_backbone``
        write a checkpoint that the port rebuilds with bit-equal actions and
        that the JAX package's loader reads with the same actions."""
        # fabricate_params is written to the checkpoint: the JAX loader skips its init.
        config = FastVLAConfig(**dict(TINY, state_dim=4), train_backbone=True, fabricate_params=True)
        policy = FastVLMTokenPolicy(config, device="cpu")
        ds = AlohaDataset(source=SyntheticAlohaSource(num_samples=8, image_hw=(40, 56), state_dim=4, action_dim=4))
        loader = create_aloha_dataloader(ds, batch_size=4, shuffle=False, num_workers=0)
        before = policy.backbone.model.language_model.embed_tokens.weight.detach().clone()
        cfg = TrainingConfig(output_dir=str(tmp_path), max_steps=2, save_steps=2, logging_steps=1,
                             learning_rate=1e-3, report_to=[], mixed_precision=None)
        trainer = Trainer(policy, loader, None, cfg)
        trainer.fit()
        assert trainer.updates == 2
        assert not torch.equal(before, policy.backbone.model.language_model.embed_tokens.weight)
        step = tmp_path / "checkpoints" / "step-2"
        loaded, _ = tckpt.load_policy_from_checkpoint(step, device="cpu")
        assert isinstance(loaded, FastVLMTokenPolicy) and loaded.config.action_head == "token"
        rng = np.random.default_rng(11)
        obs = (rng.random((2, 3, 40, 56), np.float32), rng.standard_normal((2, 4)).astype(np.float32), "go")
        actions = policy.forward(*obs).numpy()
        np.testing.assert_array_equal(loaded.forward(*obs).numpy(), actions)
        jpolicy, _ = jckpt.load_policy_from_checkpoint(step)  # the JAX loader's strict key check
        assert isinstance(jpolicy, JTokenPolicy)
        expect = flatten_params(policy.jax_params())
        got = flatten_params(jax.device_get(jpolicy.params))
        assert sorted(got) == sorted(expect)
        for key, value in expect.items():
            np.testing.assert_array_equal(np.asarray(got[key]), value, err_msg=key)


class TestTrainScript:
    FLAGS = ["--synthetic-data", "--synthetic-samples", "8", "--synthetic-image-size", "32", "--model-id",
             "fastvlm-tiny", "--bootstrap-model-id", "fastvlm-tiny", "--tokenizer-max-length", "16",
             "--state-dim", "4", "--action-dim", "4", "--action-bins", "64", "--batch-size", "4",
             "--num-workers", "0", "--max-steps", "2", "--save-steps", "2", "--logging-steps", "1",
             "--eval-split", "none", "--action-head", "token", "--device", "cpu"]

    def test_token_head_trains_only_the_backbone(self, tmp_path):
        import json

        from vla_fastvlm_tpu_torch.scripts.train import TrainArgs, main
        from vla_fastvlm_tpu_torch.utils import parse_cli

        with pytest.raises(ValueError, match="no head parameters"):
            main(parse_cli(TrainArgs, self.FLAGS + ["--output-dir", str(tmp_path / "a")]))
        # --lora-rank trains the adapters alone over the frozen base.
        main(parse_cli(TrainArgs, self.FLAGS + ["--output-dir", str(tmp_path / "b"), "--lora-rank", "4"]))
        adapted, _ = tckpt.load_policy_from_checkpoint(tmp_path / "b" / "checkpoints" / "step-2", device="cpu")
        assert adapted.config.lora_rank == 4 and set(adapted.trainable_params()) == {"lora"}
        assert any(p.any() for n, p in adapted.params["lora"].items() if n.endswith(".b"))
        main(parse_cli(TrainArgs, self.FLAGS + ["--output-dir", str(tmp_path / "c"), "--train-backbone"]))
        lines = [json.loads(ln) for ln in (tmp_path / "c" / "logs" / "metrics.jsonl").read_text().splitlines()]
        assert [ln["step"] for ln in lines if "train/loss" in ln] == [1, 2]
        policy, _ = tckpt.load_policy_from_checkpoint(tmp_path / "c" / "checkpoints" / "step-2", device="cpu")
        assert isinstance(policy, FastVLMTokenPolicy) and policy.config.train_backbone
