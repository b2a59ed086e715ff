"""The port's FLOP accounting (``vla_fastvlm_tpu_torch/utils/flops.py``)
against the JAX package's ``utils/flops.py`` on the CPU.

At the ``fastvlm-tiny`` policy of JAX's ``tests/test_flops.py`` (batch 2,
8 prompt tokens):

- the serve, frozen-head train and LoRA train counts within ``COUNT_RTOL``
  of JAX's XLA-counted ones. ``FlopCounterMode`` counts the products alone
  (matmuls, convolutions, attention at 2 FLOPs a multiply-add); XLA's cost
  model adds the elementwise work (norms, activations, softmax, the loss)
  and counts a padded depthwise convolution's valid taps only. Measured:
  the port's counts are 1.57% (serve), 1.23% (train) and 1.62% (LoRA) below
  JAX's.
- Full-backbone training is held to JAX's orderings, not to its count:
  both torch's own formula and XLA's cost model count a grouped
  convolution's weight gradient as if it were dense (C times over for a
  depthwise one: 8.69e6 FLOPs against a forward of 2.71e5 in XLA at C =
  32), and the port counts each gradient of a convolution at its forward's
  products. The port's full-backbone count is 17.9% below JAX's there.
- a matmul counts exactly 2 M K N; a depthwise convolution's two gradients
  count twice its forward;
- JAX's orderings: train > serve; train - serve between 1.5x and 2.5x the
  head's forward; head-only < LoRA < full backbone; the "contradictory"
  guard;
- ``mfu`` against a card named like the H100 SXM (989.4e12 FLOP in 1 s is
  1, half at two chips) and its ``None`` paths;
- the counts are shape-only: a policy built on the ``meta`` device gives the
  same counts, and counting materializes no parameter of the policy.
"""

import numpy as np
import pytest
import torch

from vla_fastvlm_tpu_torch.utils import flops

COUNT_RTOL = 2.5e-2
TINY = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", state_dim=4, action_dim=4,
            dropout=0.0)
BATCH, PROMPT = 2, 8


@pytest.fixture(scope="module")
def jax_counts():
    """JAX's serve, frozen train and LoRA train counts of the tiny policy."""
    from vla_fastvlm_tpu.fastvla import FastVLAConfig, FastVLMWithExpert
    from vla_fastvlm_tpu.utils import flops as jflops

    model = FastVLMWithExpert(FastVLAConfig(**TINY, fabricate_params=True))
    return {"serve": jflops.fastvlm_serve_flops(model, batch=BATCH, prompt_len=PROMPT),
            "train": jflops.fastvlm_train_flops(model, batch=BATCH, prompt_len=PROMPT),
            "lora": jflops.fastvlm_train_flops(model, batch=BATCH, prompt_len=PROMPT, lora_rank=8)}


@pytest.fixture(scope="module")
def policy():
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLMWithExpert

    return FastVLMWithExpert(FastVLAConfig(**TINY), device="cpu")


@pytest.fixture(scope="module")
def counts(policy):
    return {"serve": flops.fastvlm_serve_flops(policy, BATCH, PROMPT),
            "train": flops.fastvlm_train_flops(policy, BATCH, PROMPT),
            "lora": flops.fastvlm_train_flops(policy, BATCH, PROMPT, lora_rank=8),
            "full": flops.fastvlm_train_flops(policy, BATCH, PROMPT, train_backbone=True)}


@pytest.mark.parametrize("kind", ["serve", "train", "lora"])
def test_counts_match_jax(counts, jax_counts, kind):
    assert jax_counts[kind] is not None
    np.testing.assert_allclose(counts[kind], jax_counts[kind], rtol=COUNT_RTOL, err_msg=kind)


def test_matmul_count_is_exact():
    m, k, n = 256, 128, 512
    a, b = torch.empty((m, k), device="meta"), torch.empty((k, n), device="meta")
    assert flops.counted_flops(torch.matmul, a, b) == 2 * m * k * n


def test_depthwise_convolution_gradients_count_its_forward_twice():
    c = 32
    x = torch.empty((2, c, 16, 16), device="meta", requires_grad=True)
    w = torch.empty((c, 1, 3, 3), device="meta", requires_grad=True)

    def conv():
        return torch.nn.functional.conv2d(x, w, padding=1, groups=c)

    forward = flops.counted_flops(conv)
    assert forward == 2 * 2 * 16 * 16 * c * 9
    assert flops.counted_flops(lambda: torch.autograd.grad(conv().sum(), (x, w))) == 3 * forward
    assert flops.counted_flops(lambda: torch.autograd.grad(conv().sum(), (w,))) == 2 * forward


def test_train_is_serve_plus_the_head_backward(policy, counts):
    from vla_fastvlm_tpu_torch.fastvla.fastvlm_with_expert import build_head

    assert counts["train"] > counts["serve"]
    head = build_head(policy.config, policy.backbone.output_dim, "meta")
    feats = torch.empty((BATCH, policy.backbone.output_dim), device="meta")
    states = torch.empty((BATCH, policy.config.state_dim), device="meta")
    head_forward = flops.counted_flops(lambda: head(feats, states, train=False))
    delta = counts["train"] - counts["serve"]
    assert 1.5 * head_forward < delta < 2.5 * head_forward, (delta, head_forward)


def test_lora_between_head_only_and_full_backbone(counts):
    assert counts["train"] < counts["lora"] < counts["full"]


def test_lora_with_train_backbone_rejected(policy):
    with pytest.raises(ValueError, match="contradictory"):
        flops.fastvlm_train_flops(policy, BATCH, PROMPT, train_backbone=True, lora_rank=4)


def test_counts_are_shape_only(policy, counts, monkeypatch):
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLMWithExpert

    meta = FastVLMWithExpert(FastVLAConfig(**TINY), device="meta")
    assert next(meta.backbone.model.parameters()).is_meta
    assert flops.fastvlm_serve_flops(meta, BATCH, PROMPT) == counts["serve"]
    assert flops.fastvlm_train_flops(meta, BATCH, PROMPT, lora_rank=8) == counts["lora"]

    # Counting allocates no parameter storage off the meta device.
    made = []
    init = torch.nn.Parameter.__new__

    def record(cls, data=None, requires_grad=True):
        made.append(None if data is None else data.device.type)
        return init(cls, data, requires_grad)

    monkeypatch.setattr(torch.nn.Parameter, "__new__", record)
    flops.fastvlm_train_flops(policy, BATCH, PROMPT, train_backbone=True)
    assert made and set(made) == {"meta"}, set(made)


def test_device_peak_flops(monkeypatch):
    assert flops.device_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert flops.device_peak_flops("cuda") == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA A10G")
    assert flops.device_peak_flops("cuda:0") is None


def test_mfu_math(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert flops.mfu(989.4e12, 1.0, n_chips=1, device="cuda") == pytest.approx(1.0)
    assert flops.mfu(989.4e12, 1.0, n_chips=2, device="cuda") == pytest.approx(0.5)


def test_mfu_none_paths(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert flops.mfu(None, 0.01, device="cuda") is None
    assert flops.mfu(1e12, 0.0, device="cuda") is None
    assert flops.mfu(1e12, 0.01, device="cpu") is None  # the CPU has no peak
