"""The flash kernel's own arithmetic, in plain torch, against the JAX package.

``flash_attention_tiled_reference`` is the CUDA kernel's design written out
on the CPU: packed (position, query head) rows cut into 16-row tiles, each
tile visiting only the keys ``tile_key_range`` gives in whole 16-key steps,
an online softmax over 32-key blocks, and all S keys for a tile holding a row
with no allowed key at or before its position. It is held against the XLA
reference the Pallas file uses (``_xla_reference``) and against the Pallas
kernel in interpret mode, as the JAX package's own tests run it. The planner
``flash_plan`` is held to its bounds on shapes alone. The kernel itself runs
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vla_fastvlm_tpu_torch.ops.kernels.flash_attention import (
    MAX_WARPS,
    TILE_ROWS,
    _launch,
    flash_attention_reference,
    flash_attention_tiled_reference,
    flash_plan,
    tile_key_range,
)

from _torch_parity import t

jflash = importlib.import_module("vla_fastvlm_tpu.ops.pallas.flash_attention")

TOL = 2e-5  # fp32: the twin and XLA sum in another order


def _flash_inputs(b, t_, s, n, kh, d, pad, seed=0):
    """q/k/v ~ N(0, 1) from numpy. ``pad``: "right" (row 0 loses its last 3
    keys), "left" (row 0 its first 5, row 1 its first half: under causal
    masking their first positions see no allowed key), "mixed" (row 0 right-
    and row 1 left-padded, the last row entirely padded)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t_, n, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    if pad == "right":
        mask[0, -3:] = 0
    elif pad == "left":
        mask[0, :min(5, s - 1)] = 0
        mask[1, :s // 2] = 0
    else:
        mask[0, -3:] = 0
        mask[1, :min(4, s - 1)] = 0
        mask[-1] = 0
    return q, k, v, mask


# (b, t, s, n, kh, d, causal, pad)
CASES = [
    (3, 80, 80, 14, 2, 64, True, "mixed"),  # the policy's heads and length
    (3, 80, 80, 14, 2, 64, False, "mixed"),
    (2, 80, 80, 14, 2, 128, True, "left"),  # D = 128 under left padding
    (3, 17, 17, 28, 4, 128, True, "mixed"),  # the 7B heads: 119 rows, not whole blocks
    (3, 1, 1, 14, 2, 64, True, "mixed"),  # T = 1
    (3, 7, 7, 14, 2, 128, False, "mixed"),  # T = 7
    (2, 20, 20, 2, 2, 64, True, "left"),  # rep 1
    (3, 33, 33, 4, 2, 64, True, "right"),  # rep 2
    (2, 24, 40, 14, 2, 64, True, "left"),  # S > T
]


def _ids(case):
    b, t_, s, n, kh, d, causal, pad = case
    return f"b{b}-t{t_}-s{s}-rep{n // kh}-d{d}-{'causal' if causal else 'full'}-{pad}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_twin_matches_xla_reference(case):
    b, t_, s, n, kh, d, causal, pad = case
    q, k, v, mask = _flash_inputs(b, t_, s, n, kh, d, pad)
    ref = jflash._xla_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), causal,
                                d ** -0.5)
    out = flash_attention_tiled_reference(t(q), t(k), t(v), t(mask), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[4], CASES[6]], ids=_ids)
def test_twin_matches_pallas_interpret(case):
    b, t_, s, n, kh, d, causal, pad = case
    q, k, v, mask = _flash_inputs(b, t_, s, n, kh, d, pad, seed=1)
    with pltpu.force_tpu_interpret_mode():
        ref = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), causal,
                                     None, 16)
    out = flash_attention_tiled_reference(t(q), t(k), t(v), t(mask), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


def test_rows_without_an_allowed_key_average_all_of_v():
    """-1e30 masking: a fully padded batch row, and under left padding the
    positions before the first allowed key, come out as the mean of V over
    all S keys, though the tiles around them skip keys."""
    q, k, v, mask = _flash_inputs(3, 24, 24, 14, 2, 64, "left")
    mask[2] = 0
    out = flash_attention_tiled_reference(t(q), t(k), t(v), t(mask), True)
    mean = t(v).mean(dim=1).repeat_interleave(7, dim=1)  # (B, N, D)
    np.testing.assert_allclose(out[2].numpy(), mean[2][None].expand(24, 14, 64).numpy(), atol=1e-5)
    np.testing.assert_allclose(out[1, :12].numpy(), mean[1][None].expand(12, 14, 64).numpy(), atol=1e-5)
    np.testing.assert_allclose(out[0, :5].numpy(), mean[0][None].expand(5, 14, 64).numpy(), atol=1e-5)
    # the first allowed position attends only itself
    np.testing.assert_allclose(out[1, 12].numpy(), t(v)[1, 12].repeat_interleave(7, dim=0).numpy(), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_key_range_skips_only_keys_every_row_masks(causal):
    """Keys outside a tile's range are masked for every row of the tile,
    unless the range is all S keys; ranges start on a 16-key step."""
    rng = np.random.default_rng(4)
    s, rep = 45, 7
    for _ in range(40):
        lo_pad, hi_pad = rng.integers(0, s, 2)
        allowed = np.zeros(s, bool)
        allowed[min(lo_pad, s - hi_pad):max(lo_pad, s - hi_pad)] = True
        allowed &= rng.random(s) < 0.9
        idx = np.flatnonzero(allowed)
        first, last = (int(idx[0]), int(idx[-1]) + 1) if idx.size else (s, 0)
        for r0 in range(0, s * rep, TILE_ROWS):
            rows = np.arange(r0, min(r0 + TILE_ROWS, s * rep))
            lo, hi = tile_key_range(first, last, rows[0] // rep, rows[-1] // rep, s, causal)
            assert lo % 16 == 0 and 0 <= lo < hi <= s
            see = allowed[None, :] & ((np.arange(s)[None, :] <= (rows // rep)[:, None]) if causal else True)
            if (lo, hi) == (0, s):
                continue
            assert see.any(axis=1).all()  # a trimmed range: every row has an allowed key
            outside = np.ones(s, bool)
            outside[lo:hi] = False
            assert not see[:, outside].any()


@pytest.mark.parametrize("shape", [(80, 14, 2, 64), (80, 28, 4, 128), (1, 14, 2, 64), (17, 14, 2, 64),
                                   (100, 28, 4, 128), (2048, 14, 2, 64), (1024, 28, 4, 128), (33, 16, 2, 128),
                                   (20, 2, 2, 64), (5, 64, 2, 64)])
def test_plan_bounds(shape):
    """Whole blocks of at most 8 tiles cover the rows with no empty block;
    1 to 8 warps, one a tile at D = 128, half the (even) tiles at D = 64."""
    t_, n, kh, d = shape
    tiles, warps = flash_plan(*shape)
    total = -(-t_ * (n // kh) // TILE_ROWS)
    blocks = -(-total // tiles)
    assert 1 <= tiles <= MAX_WARPS and 1 <= warps <= MAX_WARPS
    assert (blocks - 1) * tiles < total <= blocks * tiles
    assert blocks == -(-total // MAX_WARPS)  # the fewest blocks
    if d == 128 or tiles == 1:
        assert warps == tiles
    else:
        assert tiles % 2 == 0 and warps == tiles // 2


def test_plan_at_the_main_shapes():
    # The policy step's (0.5B heads: 35 tiles a (batch row, KV head)) and the 7B decoder's.
    assert flash_plan(80, 14, 2, 64) == (8, 4)
    assert flash_plan(80, 28, 4, 128) == (7, 7)
    assert flash_plan(1, 14, 2, 64) == (1, 1)
    assert list(inspect.signature(flash_plan).parameters) == ["t", "n", "kh", "d"]


def test_launch_refuses_block_shapes_before_the_card():
    q, k, v, mask = (t(x) for x in _flash_inputs(2, 8, 8, 14, 2, 64, "right"))
    with pytest.raises(ValueError, match="warps"):
        _launch(q, k, v, mask, True, 0.125, tiles=4, warps=9)
    with pytest.raises(ValueError, match="tiles"):
        _launch(q, k, v, mask, True, 0.125, tiles=0, warps=1)


def test_twin_rounds_p_to_the_value_dtype():
    """bf16 inputs: the twin rounds P relative to the running maximum, as the
    kernel does; it stays within bf16 rounding of the plain version."""
    q, k, v, mask = _flash_inputs(2, 40, 40, 14, 2, 64, "mixed")
    q, k, v = (t(x).to(torch.bfloat16) for x in (q, k, v))
    out = flash_attention_tiled_reference(q, k, v, t(mask), True)
    ref = flash_attention_reference(q, k, v, t(mask), True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
