"""Backward plumbing of the port's kernel wrappers, on the CPU.

On the card ``flash_attention`` and ``repmixer_block`` run as
``torch.autograd.Function``s (``_FlashAttention``, ``_RepMixerBlock``) whose
forward launches the CUDA kernel and whose backward recomputes through the
plain version, as the JAX VJPs do. The kernels do not run here, so the
forward's ``_launch`` is replaced by the plain version and the Functions are
called as the card's ``train_backbone`` path calls them: small shapes,
right- and left-padded masks and fully padded rows. Their gradients are held
against plain autograd (equal: the backward is the plain version's own) and
against ``jax.grad`` of the JAX ``flash_attention`` / ``repmixer_block``,
their Pallas kernels run in interpret mode as the JAX package's tests run
them (fp32 sums in another order: 1e-5 relative).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

fa = importlib.import_module("vla_fastvlm_tpu_torch.ops.kernels.flash_attention")
rm = importlib.import_module("vla_fastvlm_tpu_torch.ops.kernels.repmixer")
jflash = importlib.import_module("vla_fastvlm_tpu.ops.pallas.flash_attention")
jrep = importlib.import_module("vla_fastvlm_tpu.ops.pallas.repmixer")

RTOL = 1e-5


@pytest.fixture
def plain_launch(monkeypatch):
    """The wrappers' forward launch replaced by the plain version; counts calls."""
    calls = []
    monkeypatch.setattr(fa, "_launch", lambda q, k, v, m, c, s, **kw: calls.append("flash")
                        or fa.flash_attention_reference(q, k, v, m, c, s))
    monkeypatch.setattr(rm, "_launch", lambda *a: calls.append("repmixer") or rm.repmixer_block_reference(*a))
    return calls


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1e-12)
    assert np.abs(a - b).max() <= RTOL * scale, f"{what}: max err {np.abs(a - b).max():.2e} of {scale:.2e}"


# (b, t, n, kh, d, causal, padding): row 0 right-padded, row 1 left-padded
# (under causal masking its first positions see no allowed key), the last
# row fully padded.
FLASH_CASES = [(3, 16, 4, 2, 16, True), (3, 12, 6, 2, 32, False), (3, 9, 7, 1, 16, True)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_function_gradients(plain_launch, case):
    b, t, n, kh, d, causal = case
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((b, t, n, d), (b, t, kh, d), (b, t, kh, d)))
    mask = np.ones((b, t), np.int32)
    mask[0, t - 4:] = 0
    mask[1, :3] = 0
    mask[-1] = 0
    w = rng.standard_normal((b, t, n, d)).astype(np.float32)
    scale = d ** -0.5

    def torch_grads(fn):
        qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = fn(*qkv, torch.from_numpy(mask), causal, scale)
        return torch.autograd.grad((out * torch.from_numpy(w)).sum(), qkv)

    grads = torch_grads(fa._FlashAttention.apply)
    assert plain_launch == ["flash"]  # the backward launches nothing
    for g, ref in zip(grads, torch_grads(fa.flash_attention_reference)):
        assert torch.equal(g, ref)

    def jloss(q_, k_, v_):
        with pltpu.force_tpu_interpret_mode():
            out = jflash.flash_attention(q_, k_, v_, jnp.asarray(mask), causal, scale, 8)
        return jnp.sum(out * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, g, ref in zip("qkv", grads, jgrads):
        _close(g.numpy(), ref, f"d{name}")


def _rep_args(b, h, w, c, f, seed):
    rng = np.random.default_rng(seed)
    arr = lambda *s, scale=0.5: (rng.standard_normal(s) * scale).astype(np.float32)
    w3 = np.zeros((3, 3, 1, c), np.float32)
    w3[1, 1, 0] = 1.0
    w7 = np.zeros((7, 7, 1, c), np.float32)
    w7[3, 3, 0] = 1.0
    return [arr(b, h, w, c, scale=1.0), w3 + arr(3, 3, 1, c, scale=0.1), arr(c), w7 + arr(7, 7, 1, c, scale=0.05),
            arr(c), arr(c, f, scale=c ** -0.5), arr(f), arr(f, c, scale=f ** -0.5), arr(c), arr(c, scale=0.5)]


@pytest.mark.parametrize("shape", [(2, 8, 16, 128, 512), (1, 8, 24, 128, 256)])
def test_repmixer_function_gradients(plain_launch, shape):
    args = _rep_args(*shape, seed=shape[2])
    upstream = np.random.default_rng(1).standard_normal(shape[:4]).astype(np.float32)

    def torch_grads(fn):
        inputs = [torch.from_numpy(a).requires_grad_() for a in args]
        out = fn(*inputs)
        return torch.autograd.grad((out * torch.from_numpy(upstream)).sum(), inputs)

    grads = torch_grads(rm._RepMixerBlock.apply)
    assert plain_launch == ["repmixer"]
    for g, ref in zip(grads, torch_grads(rm.repmixer_block_reference)):
        assert torch.equal(g, ref)

    def jloss(*a):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jrep.repmixer_block(*a) * upstream)

    jgrads = jax.grad(jloss, argnums=tuple(range(10)))(*(jnp.asarray(a) for a in args))
    names = ["x", "w3", "b3", "w7", "b7", "w1", "b1", "w2", "b2", "gamma"]
    for name, g, ref in zip(names, grads, jgrads):
        _close(g.numpy(), ref, f"d{name}")
