"""The port's GPipe pipeline (``vla_fastvlm_tpu_torch/parallel/pipeline.py``)
against the JAX package's unpipelined decoder on the CPU.

Four gloo ranks (``_torch_dist.RankPool``, one pool for the file, with its
own short timeout: a pipeline that deadlocks fails in a minute) run the
port's pipeline over a ``qwen2_tiny`` decoder of 4 layers with JAX-layout
weights from a numpy seed, as JAX's ``tests/test_pipeline.py`` does:

- the forward at (stages, microbatches) (1, 2), (2, 2), (2, 4) and (4, 2),
  with a ragged mask row, within JAX's atol 2e-5 of JAX's unpipelined
  ``Qwen2Model.apply``; each stage holds L/P blocks;
- the gradients of the MSE loss through ``pipeline_forward``, with and
  without remat, against ``jax.value_and_grad`` of the unpipelined loss
  (JAX's atol 5e-5, rtol 1e-3, every leaf), the replicated leaves' equal on
  every rank;
- five ``make_pipeline_train_step`` steps with ``torch.optim.Adam(lr=1e-2)``
  against five unpipelined ``optax.adam(1e-2)`` steps in JAX: each step's
  loss within ``TRAIN_LOSS_RTOL``, the loss falling, the replicated leaves
  bit-equal across ranks after every update;
- the guards, with JAX's messages.

The references are JAX's unpipelined decoder, each computed once for the
module: JAX's own test already holds JAX's ``shard_map`` pipeline to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from vla_fastvlm_tpu.models.qwen2 import Qwen2Model, qwen2_tiny

from _torch_dist import RankPool
from _torch_parity import jax_param_shapes, random_params

CFG = dict(vocab_size=512, hidden_size=64, num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
           intermediate_size=128)
# Adam's steps from the same gradients up to fp32 rounding: the losses of
# five steps agree to a few ulps of the loss's size.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_STEPS, LR = 5, 1e-2


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("ranks"), timeout=60.0)
    yield p
    p.close()


@pytest.fixture(scope="module")
def ref():
    """JAX's unpipelined decoder, its numpy weights, the inputs of each
    check and JAX's answers: forward, loss and gradients, five Adam steps."""
    model = Qwen2Model(qwen2_tiny().replace(num_hidden_layers=4))
    params = random_params(jax_param_shapes(model, input_ids=jnp.ones((1, 8), jnp.int32)), seed=0)
    out = {"params": jax.device_get(params)}

    rng = np.random.default_rng(0)
    ids = rng.integers(3, 500, (4, 10)).astype(np.int32)
    mask = np.ones((4, 10), np.int32)
    mask[2, 6:] = 0  # ragged row
    hidden, _, _ = model.apply({"params": params}, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    out["forward"] = (ids, mask, np.asarray(hidden))

    h = model.cfg.hidden_size
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 500, (4, 8)).astype(np.int32)
    mask = np.ones((4, 8), np.int32)
    targets = rng.standard_normal((4, 8, h)).astype(np.float32)

    def loss_fn(p, ids, targets):
        hidden, _, _ = model.apply({"params": p}, input_ids=ids, attention_mask=jnp.asarray(mask))
        return jnp.mean(jnp.square(hidden - targets))

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    loss, grads = value_and_grad(params, jnp.asarray(ids), jnp.asarray(targets))
    out["grads"] = (ids, mask, targets, float(loss), jax.device_get(grads))

    rng = np.random.default_rng(2)
    ids = rng.integers(3, 500, (4, 8)).astype(np.int32)
    targets = (rng.standard_normal((4, 8, h)) * 0.1).astype(np.float32)
    tx = optax.adam(LR)
    p, opt_state, losses = params, tx.init(params), []
    for _ in range(TRAIN_STEPS):
        loss, g = value_and_grad(p, jnp.asarray(ids), jnp.asarray(targets))
        updates, opt_state = tx.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)
        losses.append(float(loss))
    out["train"] = (ids, mask, targets, losses)
    return out


def _torch_grads(grads):
    """JAX's gradient tree in the port's layout (the bridge's mapping)."""
    from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch

    return {k: v.numpy() for k, v in jax_params_to_torch(grads).items()}


@pytest.mark.parametrize("stages,n_micro", [(1, 2), (2, 2), (2, 4), (4, 2)])
def test_forward_matches_unpipelined_jax(pool, ref, stages, n_micro):
    ids, mask, want = ref["forward"]
    outs = pool.run("t_pipeline", CFG, ref["params"], stages, n_micro, ids, mask)
    for rank, out in enumerate(outs):
        if rank >= stages:
            assert out is None
            continue
        np.testing.assert_allclose(out["hidden"], want, atol=2e-5, err_msg=f"rank {rank}")
        # Each stage holds L/P of the blocks' leaves; embed_tokens and norm are the other two.
        assert out["blocks"] * stages == len(outs[0]["state"]) - 2
    # The stages' blocks gather back to the weights that were loaded, bit for bit.
    from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch

    loaded = {k: v.numpy() for k, v in jax_params_to_torch(ref["params"]).items()}
    assert sorted(outs[0]["state"]) == sorted(loaded)
    for name, value in loaded.items():
        np.testing.assert_array_equal(outs[0]["state"][name], value, err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_unpipelined_jax(pool, ref, remat):
    ids, mask, targets, loss, grads = ref["grads"]
    outs = pool.run("t_pipeline", CFG, ref["params"], 2, 2, ids, mask, targets=targets, remat=remat)
    np.testing.assert_allclose(outs[0]["loss"], loss, rtol=1e-5)
    want = _torch_grads(grads)
    got = outs[0]["grads"]
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, atol=5e-5, rtol=1e-3, err_msg=name)
    for name, value in outs[1]["shared"].items():
        np.testing.assert_array_equal(value, outs[0]["shared"][name], err_msg=name)
        np.testing.assert_allclose(value, want[name], atol=5e-5, rtol=1e-3, err_msg=name)


def test_train_steps_match_optax_adam(pool, ref):
    ids, mask, targets, losses = ref["train"]
    outs = pool.run("t_pipeline_train", CFG, ref["params"], 2, 2, ids, mask, targets, TRAIN_STEPS, LR)
    got = outs[0]["loss"]
    np.testing.assert_allclose(got, losses, rtol=TRAIN_LOSS_RTOL)
    assert got[-1] < got[0], got
    assert np.isfinite(got).all()
    assert outs[1]["loss"] == got
    for step, (a, b) in enumerate(zip(outs[0]["shared"], outs[1]["shared"])):
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"{name} after step {step + 1}")


def test_guards(pool, ref):
    out = pool.run("t_pipeline_guards", CFG, ref["params"])
    assert out[0] == {
        "layers": "4 layers not divisible by 3 stages",
        "micro": "batch 4 not divisible by 3 microbatches",
        "scan": "pipeline_forward requires scan_layers=True",
        "devices": "need 5 devices for 5 pipeline stages",
    }
