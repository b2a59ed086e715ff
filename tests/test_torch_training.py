"""The port's training step against the JAX package on the CPU.

``fastvlm-tiny`` in fp32 (64 px tower, 2-layer decoder, head widths 16):
seeded random JAX parameters cross the weight bridge into the port, and
both packages take the same numpy-seeded batches (ALOHA-schema records
letterboxed from 40x56). Dropout is 0, since the two packages draw their
masks from different generators; the port's dropout is checked on its own.

Tolerances: losses, gradients and head updates agree to fp32 accumulation
order (the same ops in another order, through 2 decoder layers and the
tower). The goldens hold at 1e-6, as the JAX package holds optax to them.
"""

import jax
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.data import AlohaDataset as JDataset
from vla_fastvlm_tpu.data import SyntheticAlohaSource as JSource
from vla_fastvlm_tpu.data import aloha_collate_fn as jcollate
from vla_fastvlm_tpu.fastvla import FastVLAConfig as JConfig
from vla_fastvlm_tpu.fastvla import FastVLAPolicy as JPolicy
from vla_fastvlm_tpu.training import Trainer as JTrainer
from vla_fastvlm_tpu.training import TrainingConfig as JTrainingConfig
from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy
from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch
from vla_fastvlm_tpu_torch.models.action_head import dropout
from vla_fastvlm_tpu_torch.training import Trainer, TrainingConfig, linear_warmup_decay

from _torch_parity import random_params

TINY = dict(
    vlm_model_name="fastvlm-tiny",
    bootstrap_model_name="fastvlm-tiny",
    state_dim=6,
    action_dim=5,
    hidden_dim=16,
    fusion_dim=16,
    tokenizer_max_length=16,
    dropout=0.0,
)
FULL = dict(train_backbone=True, freeze_backbone=False)
# Loss and head: fp32 sums in another order.
LOSS_RTOL = 1e-5
# Gradient leaves, relative to the leaf's largest entry: the backbone's pass
# through 2 decoder layers, the tower's 5 stages and back.
GRAD_RTOL = 1e-4
# Head parameters after three AdamW updates at lr 1e-2.
UPDATE_ATOL = 1e-5


def _policies(seed=0, **kw):
    """A JAX policy with seeded random parameters and the port's with the same."""
    jpolicy = JPolicy(JConfig(**TINY, fabricate_params=True, **kw))
    params = random_params(jpolicy.params, seed)
    jpolicy.load_params(params)
    tpolicy = FastVLAPolicy(FastVLAConfig(**TINY, **kw), device="cpu")
    tpolicy.load_jax_params(params)
    return jpolicy, tpolicy


def _batches(n, size, seed=3):
    ds = JDataset(source=JSource(num_samples=n * size, image_hw=(40, 56), state_dim=6, action_dim=5, seed=seed))
    return [jcollate([ds[i] for i in range(j * size, (j + 1) * size)]) for j in range(n)]


def _torch_arrays(tpolicy, batch):
    return tpolicy.to_device(tpolicy.prepare_batch(batch))


def _rel_err(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


class TestGoldens:
    def test_schedule_matches_lambdalr(self):
        data = _golden("lr_schedule.npz")
        for i in range(int(data["n_cases"])):
            total, ratio = data[f"meta_{i}"]
            schedule = linear_warmup_decay(1.0, int(total), int(int(total) * float(ratio)))
            ours = np.array([schedule(int(s)) for s in data[f"steps_{i}"]])
            np.testing.assert_allclose(ours, data[f"factors_{i}"], atol=1e-6, err_msg=f"case {i}")

    def test_trainer_update_matches_clip_and_torch_adamw(self):
        """Three updates of the trainer's clip + AdamW on fixed gradients, one
        of which exceeds the clip norm, follow the golden trajectory."""
        data = _golden("optimizer.npz")
        params = {k: torch.nn.Parameter(torch.from_numpy(data[f"p0__{k}"].copy())) for k in ("w", "b")}

        class Stub:
            device = torch.device("cpu")

            def trainable_params(self):
                return {"opt": params}

        cfg = TrainingConfig(max_steps=10**9, warmup_ratio=0.0, learning_rate=1e-3, weight_decay=0.01,
                             max_grad_norm=1.0, report_to=[])
        trainer = Trainer(Stub(), [], None, cfg)
        for i in range(int(data["n_steps"])):
            trainer._apply_update([torch.from_numpy(data[f"g{i}__{k}"].copy()) for k in ("w", "b")])
            for k in ("w", "b"):
                np.testing.assert_allclose(params[k].detach().numpy(), data[f"s{i}__{k}"], atol=1e-6,
                                           err_msg=f"step {i} param {k}")


def _golden(name):
    from pathlib import Path

    return np.load(Path(__file__).parent / "golden" / name)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train-dropout0"])
def test_loss_matches_jax(train):
    jpolicy, tpolicy = _policies(seed=1)
    batch = _batches(1, 3)[0]
    jloss, jmetrics = jax.jit(lambda tr, fr, a: jpolicy.loss_fn(tr, fr, a, train=train))(
        jpolicy.trainable_params(), jpolicy.frozen_params(), jpolicy.prepare_batch(batch))
    tloss, tmetrics = tpolicy.loss_fn(_torch_arrays(tpolicy, batch), train=train)
    assert tloss.requires_grad == train and set(tmetrics) == set(jmetrics) == {"loss", "mse"}
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tpolicy.compute_loss(batch)["mse"]), float(jloss), rtol=LOSS_RTOL)


@pytest.mark.parametrize("mode", ["frozen", "train_backbone"])
def test_gradients_match_jax_grad(mode):
    """Frozen: the head's gradients (the backbone takes none). Full
    backbone: every leaf of the policy."""
    kw = FULL if mode == "train_backbone" else {}
    jpolicy, tpolicy = _policies(seed=2, **kw)
    batch = _batches(1, 3, seed=5)[0]
    grad_fn = jax.jit(jax.grad(lambda tr, fr, a: jpolicy.loss_fn(tr, fr, a, train=True)[0]))
    jgrads = jax.device_get(grad_fn(jpolicy.trainable_params(), jpolicy.frozen_params(), jpolicy.prepare_batch(batch)))
    assert set(jgrads) == ({"backbone", "head"} if kw else {"head"})
    assert set(tpolicy.trainable_params()) == set(jgrads)

    loss, _ = tpolicy.loss_fn(_torch_arrays(tpolicy, batch), train=True)
    loss.backward()
    modules = {"backbone": tpolicy.model.backbone.model, "head": tpolicy.model.head}
    if not kw:
        assert all(p.grad is None for p in modules["backbone"].parameters())
    for part, jtree in jgrads.items():
        expect = jax_params_to_torch(jtree)
        got = dict(modules[part].named_parameters())
        assert sorted(expect) == sorted(got)
        for name, ref in expect.items():
            grad = got[name].grad
            assert grad is not None, f"{part}.{name} took no gradient"
            err = _rel_err(grad.numpy(), ref.numpy())
            assert err <= GRAD_RTOL, f"{part}.{name}: rel err {err:.2e}"


@pytest.mark.parametrize("k", [1, 2], ids=["k1", "accumulate-k2"])
def test_three_updates_match_optax(k):
    """Three optimizer updates of the port's trainer against the JAX
    trainer's optax chain: warmup (the first update at lr 0), the clip hit
    at the second update only, and with k = 2 MultiSteps' mean of two
    batches' gradients before each update."""
    jpolicy, tpolicy = _policies(seed=4)
    batches = _batches(3 * k, 4)
    settings = dict(max_steps=10, warmup_ratio=0.2, learning_rate=1e-2, max_grad_norm=2.0,
                    gradient_accumulation_steps=k, report_to=[], mixed_precision=None)
    jtrainer = JTrainer(jpolicy, batches, None, JTrainingConfig(**settings))
    trainable, opt_state, rng = jtrainer.trainable, jtrainer.opt_state, jax.random.PRNGKey(0)
    ttrainer = Trainer(tpolicy, batches, None, TrainingConfig(**settings))
    norms = []
    for batch in batches:
        trainable, opt_state, jm = jtrainer._train_step(trainable, opt_state, jtrainer.frozen,
                                                         jpolicy.prepare_batch(batch), rng)
        tm = ttrainer._train_step(ttrainer._place_batch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=LOSS_RTOL)
        norms.append(float(tm["grad_norm"]))
    assert ttrainer.updates == 3
    if k == 1:  # the clip is hit at the second update only
        assert [n >= settings["max_grad_norm"] for n in norms] == [False, True, False], norms
    expect = jax_params_to_torch(jax.device_get(trainable["head"]))
    for name, value in tpolicy.model.head.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expect[name].numpy(), atol=UPDATE_ATOL, err_msg=name)


def test_accumulation_equals_double_batch():
    """k = 2 over two batches of 4 makes the update one batch of 8 makes."""
    _, one = _policies(seed=6)
    _, two = _policies(seed=6)
    batches = _batches(2, 4, seed=8)
    double = {key: (np.concatenate([b[key] for b in batches]) if hasattr(batches[0][key], "shape")
                    else batches[0][key] + batches[1][key]) for key in batches[0]}
    settings = dict(max_steps=10, warmup_ratio=0.0, learning_rate=1e-2, report_to=[], mixed_precision=None)
    t1 = Trainer(one, [double], None, TrainingConfig(**settings))
    t1._train_step(t1._place_batch(double))
    t2 = Trainer(two, batches, None, TrainingConfig(**settings, gradient_accumulation_steps=2))
    before = {k: v.clone() for k, v in two.model.head.state_dict().items()}
    t2._train_step(t2._place_batch(batches[0]))
    assert all(torch.equal(v, before[k]) for k, v in two.model.head.state_dict().items())
    t2._train_step(t2._place_batch(batches[1]))
    assert t1.updates == t2.updates == 1
    for (name, a), b in zip(one.model.head.state_dict().items(), two.model.head.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=UPDATE_ATOL, err_msg=name)


def test_train_backbone_rematerializes_decoder_blocks(monkeypatch):
    """train_backbone alone turns remat on (as in JAX), and each decoder
    block's forward then runs again in the backward pass."""
    from vla_fastvlm_tpu_torch.models.qwen2 import Qwen2Block

    _, tpolicy = _policies(seed=7, train_backbone=True)
    text = tpolicy.model.backbone.model_config.text
    assert text.remat and tpolicy.config.freeze_backbone
    assert not any(p.requires_grad for p in tpolicy.model.backbone.model.parameters())
    _, full = _policies(seed=7, **FULL)
    assert all(p.requires_grad for p in full.model.backbone.model.parameters())
    calls = []
    original = Qwen2Block.forward
    monkeypatch.setattr(Qwen2Block, "forward", lambda self, *a, **kw: calls.append(1) or original(self, *a, **kw))
    loss, _ = full.loss_fn(_torch_arrays(full, _batches(1, 2)[0]), train=True)
    assert len(calls) == text.num_hidden_layers
    loss.backward()
    assert len(calls) == 2 * text.num_hidden_layers


class TestDropout:
    def test_same_generator_same_mask_and_scale(self):
        x = torch.ones(64, 256)
        a = dropout(x, 0.25, torch.Generator().manual_seed(3))
        b = dropout(x, 0.25, torch.Generator().manual_seed(3))
        c = dropout(x, 0.25, torch.Generator().manual_seed(4))
        assert torch.equal(a, b) and not torch.equal(a, c)
        kept = a[a != 0]
        assert torch.allclose(kept, torch.full_like(kept, 1 / 0.75))
        assert abs(float((a == 0).float().mean()) - 0.25) < 0.02

    def test_head_dropout_only_in_train_mode(self):
        from vla_fastvlm_tpu_torch.models.action_head import ActionExpertHead
        from vla_fastvlm_tpu_torch.models.layers import init_weights

        head = ActionExpertHead(8, 4, 3, 16, 16, dropout=0.5)
        init_weights(head, torch.Generator().manual_seed(0))
        head.eval()
        feats, states = torch.randn(5, 8), torch.randn(5, 4)
        assert torch.equal(head(feats, states), head(feats, states, train=False))
        a = head(feats, states, train=True, generator=torch.Generator().manual_seed(0))
        b = head(feats, states, train=True, generator=torch.Generator().manual_seed(0))
        assert torch.equal(a, b) and not torch.equal(a, head(feats, states))
