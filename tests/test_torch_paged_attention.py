"""The port's paged-attention decode path against the JAX package on the CPU.

- ``ops/quant.py``: ``quantize_kv`` / ``dequantize_kv`` bit for bit.
- ``ops/attention.py::paged_attention`` (the plain gather path, which is the
  CUDA kernels' plain version) against JAX ``paged_attention(impl="xla")``
  and the Pallas kernel ``paged_attention_decode(..., interpret=True)``, on
  float and int8 pools, GQA 4/2 and 4/1, trash-page table entries, ragged
  lengths that are not page-aligned and an empty stored mask; at W > 1 (the
  speculative verify window) against JAX ``paged_attention(impl="xla")`` and
  ``paged_attention_window(..., interpret=True)``, GQA 4/2 and 6/2, head_dim
  64 and 128, float and int8 pools, W 2 and 5, within 1e-5.
- ``split_plan`` (the kernels' split of the stored window, from the shapes
  and the blocks the kernel instance runs at once) and ``paged_attention_split_reference`` (the plain twin of the
  kernels' split-and-merge arithmetic) against JAX
  ``paged_attention_window(..., interpret=True)`` at W = 1 and 5, with 1, 2
  and the most splits, a split whose positions are all masked, the empty
  stored mask, inactive slots and int8 pools.
- ``models``: ``prefill`` + ``decode_step`` and ``decode_step_paged`` logits
  of the tiny FastVLM, float and int8 caches, with the JAX weights carried
  over by the bridge.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Tolerances: fp32 attention over a few dozen positions
differs from JAX only in summation order (2e-5); the Pallas kernel also sums
its softmax in another order (2e-5).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.models import fastvlm as j_vlm
from vla_fastvlm_tpu.models import qwen2 as j_qwen
from vla_fastvlm_tpu.ops import quant as j_quant
from vla_fastvlm_tpu.ops.attention import paged_attention as j_paged_attention
from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch
from vla_fastvlm_tpu_torch.models import fastvlm as t_vlm
from vla_fastvlm_tpu_torch.models import qwen2 as t_qwen
from vla_fastvlm_tpu_torch.ops import quant as t_quant
from vla_fastvlm_tpu_torch.ops.attention import paged_attention
from vla_fastvlm_tpu_torch.ops.kernels import (
    launch_counts,
    paged_attention_decode,
    paged_attention_window,
    reset_launch_counts,
)
from vla_fastvlm_tpu_torch.ops.kernels.paged_attention import (
    MAX_SPLITS,
    TILE,
    check_kernel_shapes,
    paged_attention_split_reference,
    scale_window,
    split_plan,
    split_ranges,
)

from _torch_parity import jax_param_shapes, random_params, t

# The package re-exports names over the module: take the module.
jpaged = importlib.import_module("vla_fastvlm_tpu.ops.pallas.paged_attention")

ATOL = 2e-5


class TestQuantizeKV:
    @pytest.mark.parametrize("shape", [(3, 5, 2, 64), (4, 16, 128)])
    def test_matches_jax_exactly(self, shape):
        x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 3.0
        x[0, 0] = 0.0  # an all-zero row takes scale 1
        jq, js = j_quant.quantize_kv(jnp.asarray(x))
        tq, ts = t_quant.quantize_kv(t(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert float(ts.reshape(-1, ts.shape[-1])[0, 0]) == 1.0
        np.testing.assert_array_equal(
            t_quant.dequantize_kv(tq, ts, torch.float32).numpy(),
            np.asarray(j_quant.dequantize_kv(jq, js, jnp.float32)),
        )

    def test_rounds_half_to_even(self):
        # absmax 127 -> scale 1: x / scale lands exactly on .5 values
        x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32)
        tq, _ = t_quant.quantize_kv(t(x))
        jq, _ = j_quant.quantize_kv(jnp.asarray(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(tq.numpy()[0, 1:], [0, 2, 2, 0, -2])


def _setup(b=3, n=4, kv=2, d=64, page=16, p_slot=3, p_total=8, seed=0):
    """Slot 0: pages 3, 5 and a ragged tail (23 stored, cursor 23); slot 1:
    one full page with the rest of its table on trash; slot 2: inactive, all
    trash, empty stored mask (attends only its new row)."""
    rng = np.random.default_rng(seed)
    s_max = p_slot * page
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, pool_k, pool_v = f(b, 1, n, d), f(p_total, kv, page, d), f(p_total, kv, page, d)
    k_new, v_new = f(b, 1, kv, d), f(b, 1, kv, d)
    tables = np.zeros((b, p_slot), np.int32)
    tables[0, :2] = [3, 5]
    tables[1, :1] = [2]
    mask = np.zeros((b, s_max), bool)
    mask[0, : page + 7] = True
    mask[1, :page] = True
    lengths = np.array([page + 7, page, 1], np.int32)
    return q, pool_k, pool_v, tables, mask, lengths, k_new, v_new


def _both(args, scales=None, impl="auto"):
    q, pk, pv, tables, mask, lengths, kn, vn = args
    kw_j = {} if scales is None else dict(pool_k_scale=jnp.asarray(scales[0]), pool_v_scale=jnp.asarray(scales[1]))
    kw_t = {} if scales is None else dict(pool_k_scale=t(scales[0]), pool_v_scale=t(scales[1]))
    ref = j_paged_attention(*[jnp.asarray(a) for a in args], impl="xla", **kw_j)
    out = paged_attention(*[t(a) for a in args], impl=impl, **kw_t)
    interp = jpaged.paged_attention_decode(
        jnp.asarray(q[:, 0]), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables), jnp.asarray(mask),
        jnp.asarray(kn[:, 0]), jnp.asarray(vn[:, 0]), interpret=True, **kw_j,
    )
    return out.numpy(), np.asarray(ref), np.asarray(interp)


def _quantized(args):
    q, pk, pv, tables, mask, lengths, kn, vn = args
    pk_q, pk_s = j_quant.quantize_kv(jnp.asarray(pk))
    pv_q, pv_s = j_quant.quantize_kv(jnp.asarray(pv))
    # New rows arrive dequant-roundtripped, as the model hands them over.
    kn_dq = j_quant.dequantize_kv(*j_quant.quantize_kv(jnp.asarray(kn)), jnp.float32)
    vn_dq = j_quant.dequantize_kv(*j_quant.quantize_kv(jnp.asarray(vn)), jnp.float32)
    arr = lambda x: np.asarray(x)
    return (q, arr(pk_q), arr(pv_q), tables, mask, lengths, arr(kn_dq), arr(vn_dq)), (arr(pk_s), arr(pv_s))


class TestPagedAttentionPlainVersion:
    @pytest.mark.parametrize("n,kv,d", [(4, 2, 64), (4, 1, 64), (6, 2, 128)])
    @pytest.mark.parametrize("impl", ["auto", "xla"])
    def test_float_pools_match_jax(self, n, kv, d, impl):
        out, ref, interp = _both(_setup(n=n, kv=kv, d=d, seed=n + kv), impl=impl)
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(out[:, 0], interp, atol=ATOL, rtol=ATOL)

    @pytest.mark.parametrize("n,kv", [(4, 2), (4, 1)])
    def test_int8_pools_match_jax(self, n, kv):
        args, scales = _quantized(_setup(n=n, kv=kv, seed=3))
        out, ref, interp = _both(args, scales)
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(out[:, 0], interp, atol=ATOL, rtol=ATOL)

    def test_bf16_pools_match_jax(self):
        """bf16 values in the pool layout: both sides round P to bf16 before P.V."""
        args = list(_setup(seed=5))
        bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))
        jargs = [jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32 else jnp.asarray(a) for a in args]
        ref = np.asarray(j_paged_attention(*jargs, impl="xla").astype(jnp.float32))
        targs = [t(bf(a).astype(np.float32)).to(torch.bfloat16) if a.dtype == np.float32 else t(a) for a in args]
        out = paged_attention(*targs).float().numpy()
        # bf16 output (8 bits of mantissa) of values up to ~3
        np.testing.assert_allclose(out, ref, atol=2e-2, rtol=1e-2)

    def test_empty_mask_attends_only_its_new_row(self):
        args = _setup(seed=2)
        out, _, _ = _both(args)
        rep = args[0].shape[2] // args[6].shape[2]
        np.testing.assert_allclose(out[2, 0], np.repeat(args[7][2, 0], rep, axis=0), atol=1e-6)

    def test_trash_page_contents_do_not_matter(self):
        args = list(_setup(seed=7))
        base, _, _ = _both(tuple(args))
        args[1] = args[1].copy()
        args[2] = args[2].copy()
        args[1][0] = 1e4  # the trash page
        args[2][0] = -1e4
        changed, _, _ = _both(tuple(args))
        np.testing.assert_array_equal(changed, base)


class TestKernelWrapper:
    def test_cpu_tensor_runs_plain_version_without_launch(self):
        q, pk, pv, tables, mask, lengths, kn, vn = _setup(seed=8)
        reset_launch_counts()
        out = paged_attention_decode(t(q[:, 0]), t(pk), t(pv), t(tables), t(mask), t(lengths), t(kn[:, 0]), t(vn[:, 0]))
        assert launch_counts()["paged_attention"] == 0
        ref = paged_attention(*[t(a) for a in (q, pk, pv, tables, mask, lengths, kn, vn)], impl="xla")
        np.testing.assert_array_equal(out.numpy(), ref[:, 0].numpy())

    def test_other_devices_raise(self):
        args = [t(a).to("meta") for a in _setup(seed=9)]
        with pytest.raises(ValueError, match="CUDA or CPU"):
            paged_attention(*args)
        q, pk, pv, tables, mask, lengths, kn, vn = args
        with pytest.raises(ValueError, match="paged_attention_window runs on CUDA or CPU"):  # W > 1
            paged_attention(q.expand(3, 2, 4, 64), pk, pv, tables, mask, lengths, kn.expand(3, 2, 2, 64),
                            vn.expand(3, 2, 2, 64))

    def test_shape_rules(self):
        q, pk, pv, tables, mask, lengths, kn, vn = [t(a) for a in _setup(seed=10)]
        q, kn, vn = q[:, 0], kn[:, 0], vn[:, 0]
        check_kernel_shapes(q, pk, pv, tables, mask, kn, vn, None, None)
        with pytest.raises(ValueError, match="head_dim"):
            check_kernel_shapes(q[..., :32], pk[..., :32], pv[..., :32], tables, mask, kn[..., :32], vn[..., :32],
                                None, None)
        with pytest.raises(ValueError, match="scale pools"):
            check_kernel_shapes(q, pk.to(torch.int8), pv.to(torch.int8), tables, mask, kn, vn, None, None)
        with pytest.raises(ValueError, match="kv_mask"):
            check_kernel_shapes(q, pk, pv, tables, mask[:, :-1], kn, vn, None, None)
        with pytest.raises(ValueError, match="power of two"):
            check_kernel_shapes(q, pk[:, :, :12], pv[:, :, :12], tables, mask[:, :36], kn, vn, None, None)

    def test_scale_window_matches_gather(self):
        rng = np.random.default_rng(11)
        pool = rng.random((6, 2, 4), dtype=np.float32)
        tables = np.array([[3, 0, 5], [1, 2, 0]], np.int32)
        win = scale_window(t(pool), t(tables)).numpy()
        assert win.shape == (2, 2, 12)
        for b in range(2):
            for s in range(12):
                np.testing.assert_array_equal(win[b, :, s], pool[tables[b, s // 4], :, s % 4])


# ---------------------------------------------------------------------------
# W > 1: the speculative verify window

WINDOW_ATOL = 1e-5


def _setup_window(w, n=4, kv=2, d=64, seed=0):
    """``_setup``'s slots (ragged pages, a one-page slot, an inactive slot
    with an empty stored mask) with a W-token window at each cursor. The
    pool positions at and past each cursor hold random rows, as rejected
    rows of an earlier round would, and are masked."""
    q, pk, pv, tables, mask, lengths, _, _ = _setup(n=n, kv=kv, d=d, seed=seed)
    rng = np.random.default_rng(seed + 100)
    b = q.shape[0]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, w, n, d), pk, pv, tables, mask, lengths, f(b, w, kv, d), f(b, w, kv, d)


_JAX_WINDOW = {}


def _jax_window(key):
    """JAX's gathered path and interpret-mode kernel on one case, computed
    once per case for the port's two impls."""
    if key not in _JAX_WINDOW:
        w, n, kv, d, int8 = key
        args = _setup_window(w, n, kv, d, seed=w + n + d)
        scales = None
        if int8:
            args, scales = _quantized(args)
        kw = {} if scales is None else dict(pool_k_scale=jnp.asarray(scales[0]), pool_v_scale=jnp.asarray(scales[1]))
        q, pk, pv, tables, mask, lengths, kn, vn = (jnp.asarray(a) for a in args)
        ref = j_paged_attention(q, pk, pv, tables, mask, lengths, kn, vn, impl="xla", **kw)
        interp = jpaged.paged_attention_window(q, pk, pv, tables, mask, kn, vn, interpret=True, **kw)
        _JAX_WINDOW[key] = (args, scales, np.asarray(ref), np.asarray(interp))
    return _JAX_WINDOW[key]


class TestPagedWindowPlainVersion:
    @pytest.mark.parametrize("impl", ["auto", "xla"])
    @pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("n,kv", [(4, 2), (6, 2)])
    @pytest.mark.parametrize("w", [2, 5])
    def test_matches_jax_gathered_and_interpret_kernel(self, w, n, kv, d, int8, impl):
        args, scales, ref, interp = _jax_window((w, n, kv, d, int8))
        kw = {} if scales is None else dict(pool_k_scale=t(scales[0]), pool_v_scale=t(scales[1]))
        reset_launch_counts()
        out = paged_attention(*[t(a) for a in args], impl=impl, **kw).numpy()
        assert launch_counts()["paged_attention_window"] == 0  # a CPU tensor runs the plain version
        assert out.shape == (3, w, n, d)
        np.testing.assert_allclose(out, ref, atol=WINDOW_ATOL, rtol=WINDOW_ATOL)
        np.testing.assert_allclose(out, interp, atol=WINDOW_ATOL, rtol=WINDOW_ATOL)

    @pytest.mark.parametrize("w", [2, 5])
    def test_empty_mask_causal_self(self, w):
        """The inactive slot's window attends only its own causal columns:
        position 0 gives exactly v_new[0]; nothing is NaN."""
        args = _setup_window(w, seed=10)
        out = paged_attention(*[t(a) for a in args]).numpy()
        assert np.isfinite(out).all()
        rep = args[0].shape[2] // args[6].shape[2]
        np.testing.assert_allclose(out[2, 0], np.repeat(args[7][2, 0], rep, axis=0), atol=1e-6, rtol=1e-6)
        interp = jpaged.paged_attention_window(*[jnp.asarray(a) for i, a in enumerate(args) if i != 5],
                                               interpret=True)
        np.testing.assert_allclose(out, np.asarray(interp), atol=WINDOW_ATOL, rtol=WINDOW_ATOL)

    def test_rejected_rows_past_the_cursor_do_not_count(self):
        """Rows at and past each cursor (a rejected suffix) are masked: their
        values change nothing."""
        args = list(_setup_window(3, seed=12))
        base = paged_attention(*[t(a) for a in args]).numpy()
        pk, pv = args[1].copy(), args[2].copy()
        page = pk.shape[2]
        length = int(args[5][0])  # slot 0: pages 3, 5 with its cursor inside page 5
        pk[5, :, length % page:] = 1e4
        pv[5, :, length % page:] = -1e4
        args[1], args[2] = pk, pv
        np.testing.assert_array_equal(paged_attention(*[t(a) for a in args]).numpy(), base)

    def test_window_wrapper_on_cpu_runs_the_plain_version(self):
        args = [t(a) for a in _setup_window(4, seed=13)]
        reset_launch_counts()
        out = paged_attention_window(*args)
        assert launch_counts() == {name: 0 for name in launch_counts()}
        np.testing.assert_array_equal(out.numpy(), paged_attention(*args, impl="xla").numpy())

    def test_kernel_shape_rules(self):
        q, pk, pv, tables, mask, lengths, kn, vn = [t(a) for a in _setup_window(5, n=4, kv=2, d=64, seed=14)]
        check_kernel_shapes(q, pk, pv, tables, mask, kn, vn, None, None)
        with pytest.raises(ValueError, match="N / K <= 8"):  # rep 9
            check_kernel_shapes(q.repeat(1, 1, 9, 1)[:, :, :18], pk, pv, tables, mask, kn, vn, None, None)
        with pytest.raises(ValueError, match="W <= 9"):
            q10, k10, v10 = (x.repeat(1, 2, 1, 1) for x in (q, kn, vn))
            check_kernel_shapes(q10, pk, pv, tables, mask, k10, v10, None, None)
        with pytest.raises(ValueError, match="head_dim"):
            check_kernel_shapes(q[..., :32], pk[..., :32], pv[..., :32], tables, mask, kn[..., :32], vn[..., :32],
                                None, None)
        with pytest.raises(ValueError, match="head_dim"):
            check_kernel_shapes(q.repeat(1, 1, 1, 4), pk.repeat(1, 1, 1, 4), pv.repeat(1, 1, 1, 4), tables, mask,
                                kn.repeat(1, 1, 1, 4), vn.repeat(1, 1, 1, 4), None, None)  # 256
        with pytest.raises(ValueError, match=r"\(B, W, K, D\)"):
            check_kernel_shapes(q, pk, pv, tables, mask, kn[:, :4], vn, None, None)
        with pytest.raises(ValueError, match="W <= 9"):  # W = 1 takes the decode kernel's layout
            check_kernel_shapes(q[:, :1], pk, pv, tables, mask, kn[:, :1], vn[:, :1], None, None)


# ---------------------------------------------------------------------------
# the kernels' split of the stored window and its merge

# (B, K, P_slot, page, W): the serving shapes (0.5B and 7B decode ticks, the
# 7B verify round and the 0.5B heads' window) and this file's test shapes.
PLAN_SHAPES = [(64, 2, 24, 16, 1), (16, 4, 24, 16, 1), (17, 4, 23, 16, 5), (65, 2, 23, 16, 5),
               (3, 2, 3, 16, 1), (4, 2, 16, 16, 5), (1, 1, 512, 64, 1), (2, 2, 5, 4, 2)]
# Waves (blocks the card runs at once) of 2 to 5 blocks an SM on an H100
# SXM's 132 SMs, and a small card's.
WAVES = [132 * 2, 132 * 3, 132 * 4, 132 * 5, 16]
# (B, K, P_slot, page, W, wave, parts) at the serving shapes, with the waves
# the occupancy calculator reports on an H100 80GB HBM3 for the instance
# each shape launches (chip_smoke.py --only paged prints them), and the part
# counts that measured fastest there of 1, 2, 3 and 6.
SERVING_PLANS = [
    (64, 2, 24, 16, 1, 132 * 5, 3),  # 0.5B decode tick, bf16 pools: 96 registers, 5 blocks an SM
    (64, 2, 24, 16, 1, 132 * 4, 3),  # the same over int8 pools: 112 registers
    (16, 4, 24, 16, 1, 132 * 4, 6),  # 7B heads decode, bf16 and int8: one tile a part
    (17, 4, 23, 16, 5, 132 * 2, 3),  # 7B verify window, bf16: 181 registers, 2 blocks an SM
    (17, 4, 23, 16, 5, 132 * 4, 6),  # the same over int8 pools: 168 registers, 4 blocks an SM
    (65, 2, 23, 16, 5, 132 * 5, 3),  # 0.5B heads window, bf16 and int8
]


class TestSplitPlan:
    @pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
    def test_plan_bounds_and_one_wave(self, shape):
        b, kh, p_slot, page, w = shape
        tiles = -(-p_slot * page // TILE)
        for wave in WAVES:
            splits = split_plan(b, kh, p_slot, page, w, wave=wave)
            assert isinstance(splits, int) and 1 <= splits <= min(tiles, MAX_SPLITS)
            # the split blocks fit one wave, or nothing smaller than one split exists
            assert b * kh * splits <= wave or splits == 1
            # the most splits that do: the next whole-tile count would not fit
            more = [s for s in (-(-tiles // per) for per in range(1, tiles + 1)) if s > splits]
            if more and min(more) <= MAX_SPLITS:
                assert b * kh * min(more) > wave

    @pytest.mark.parametrize("plan", SERVING_PLANS, ids=str)
    def test_plan_at_the_serving_shapes(self, plan):
        *shape, wave, parts = plan
        assert split_plan(*shape, wave=wave) == parts

    @pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
    def test_every_tile_covered_once(self, shape):
        b, kh, p_slot, page, w = shape
        s_max = p_slot * page
        tiles = -(-s_max // TILE)
        planned = {split_plan(b, kh, p_slot, page, w, wave=wave) for wave in WAVES}
        for splits in sorted({1, 2, min(tiles, MAX_SPLITS)} | planned):
            ranges = split_ranges(s_max, splits)
            assert len(ranges) == splits
            covered = [t for s0, s1 in ranges for t in range(s0, s1, TILE)]
            assert covered == list(range(0, s_max, TILE))
            assert all((s0 % TILE == 0 or s0 == s_max) and s0 <= s1 for s0, s1 in ranges)
        # the plan leaves no split empty
        for splits in planned:
            assert all(s1 > s0 for s0, s1 in split_ranges(s_max, splits))

    def test_plan_reads_shapes_only(self):
        import inspect

        params = inspect.signature(split_plan).parameters
        assert list(params) == ["b", "kh", "p_slot", "page", "w", "wave"]
        assert params["wave"].kind is inspect.Parameter.KEYWORD_ONLY
        assert split_plan(64, 2, 24, 16, 1, wave=528) == split_plan(64, 2, 24, 16, wave=528)


def _setup_split(w, n=4, kv=2, d=64, page=16, p_slot=16, seed=0):
    """Four tiles of 64 a slot. Slot 0: ragged through tile 3 with a pad hole;
    slot 1: tiles 0 and 2 only (tile 1 masked whole: with one tile a split,
    that split is all masked); slot 2: inactive (one-hot mask on the trash
    page, as the servers run them); slot 3: 40 positions (every split past
    the first all masked, its pages trash); slot 4: an empty stored mask.
    Pool rows past each slot's valid positions hold random values."""
    rng = np.random.default_rng(seed)
    b, s_max, p_total = 5, p_slot * page, 5 * p_slot + 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kn, vn = f(b, w, n, d), f(b, w, kv, d), f(b, w, kv, d)
    pk, pv = f(p_total, kv, page, d), f(p_total, kv, page, d)
    tables = np.zeros((b, p_slot), np.int32)
    perm = rng.permutation(p_total - 1) + 1
    mask = np.zeros((b, s_max), bool)
    mask[0, :201] = True
    mask[0, 150:170] = False
    mask[1, :64] = True
    mask[1, 128:181] = True
    mask[2, 0] = True
    mask[3, :40] = True
    for i, used in ((0, 14), (1, 13), (3, 3), (4, 2)):
        tables[i, :used] = perm[i * p_slot: i * p_slot + used]
    lengths = np.array([201, 181, 1, 40, 0], np.int32)
    return q, pk, pv, tables, mask, lengths, kn, vn


_JAX_SPLIT = {}


def _jax_split(w, int8):
    """The case and JAX's interpret-mode kernel on it, once per (W, pools)."""
    key = (w, int8)
    if key not in _JAX_SPLIT:
        args = _setup_split(w, seed=20 + w)
        scales = None
        if int8:
            args, scales = _quantized(args)
        kw = {} if scales is None else dict(pool_k_scale=jnp.asarray(scales[0]), pool_v_scale=jnp.asarray(scales[1]))
        q, pk, pv, tables, mask, _, kn, vn = (jnp.asarray(a) for a in args)
        interp = jpaged.paged_attention_window(q, pk, pv, tables, mask, kn, vn, interpret=True, **kw)
        _JAX_SPLIT[key] = (args, scales, np.asarray(interp))
    return _JAX_SPLIT[key]


class TestSplitReference:
    @pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
    @pytest.mark.parametrize("splits", [1, 2, "max"])
    @pytest.mark.parametrize("w", [1, 5])
    def test_matches_jax_interpret_kernel(self, w, splits, int8):
        args, scales, interp = _jax_split(w, int8)
        kw = {} if scales is None else dict(pool_k_scale=t(scales[0]), pool_v_scale=t(scales[1]))
        q, pk, pv, tables, mask, lengths, kn, vn = [t(a) for a in args]
        if w == 1:  # the decode kernel's layout
            q, kn, vn = q[:, 0], kn[:, 0], vn[:, 0]
        n_splits = -(-mask.shape[1] // TILE) if splits == "max" else splits
        out = paged_attention_split_reference(q, pk, pv, tables, mask, lengths, kn, vn, splits=n_splits, **kw)
        out = out.numpy() if w > 1 else out[:, None].numpy()
        assert np.isfinite(out).all()
        tol = ATOL if w == 1 else WINDOW_ATOL
        np.testing.assert_allclose(out, interp, atol=tol, rtol=tol)

    @pytest.mark.parametrize("w", [1, 5])
    def test_empty_stored_mask_is_the_new_rows(self, w):
        """Slot 4 stores nothing: every split is the neutral part, with weight 0,
        so window position 0 is exactly its new V row."""
        args = [t(a) for a in _setup_split(w, seed=30)]
        q, pk, pv, tables, mask, lengths, kn, vn = args
        if w == 1:
            q, kn, vn = q[:, 0], kn[:, 0], vn[:, 0]
        for splits in (1, 2, 4):
            out = paged_attention_split_reference(q, pk, pv, tables, mask, lengths, kn, vn, splits=splits)
            first = out[4] if w == 1 else out[4, 0]
            v0 = vn[4] if w == 1 else vn[4, 0]
            np.testing.assert_allclose(first.numpy(), np.repeat(v0.numpy(), 2, axis=0), atol=1e-6, rtol=1e-6)

    def test_split_count_changes_only_rounding_order(self):
        """fp32: any split count gives the gathered plain version's result."""
        args = [t(a) for a in _setup_split(5, seed=31)]
        ref = paged_attention(*args, impl="xla").numpy()
        for splits in (1, 2, 3, 4, 7):
            out = paged_attention_split_reference(*args, splits=splits).numpy()
            np.testing.assert_allclose(out, ref, atol=WINDOW_ATOL, rtol=WINDOW_ATOL)


# ---------------------------------------------------------------------------
# the decoder's cached and paged steps


def _vlm(int8: bool):
    kvq = "int8" if int8 else "none"
    jcfg = j_vlm.fastvlm_tiny().replace(text=j_qwen.qwen2_tiny(kv_cache_quantization=kvq))
    jm = j_vlm.FastVLM(jcfg)
    params = random_params(jax_param_shapes(jm, jnp.zeros((1, 3, 64, 64)), jnp.ones((1, 8), jnp.int32)), seed=1)
    tm = t_vlm.FastVLM(t_vlm.fastvlm_tiny().replace(text=t_qwen.qwen2_tiny(kv_cache_quantization=kvq)))
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module", params=[False, True], ids=["float", "int8"])
def vlm(request):
    return _vlm(request.param)


def _prompts(b=3, t_=8, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, (b, t_)).astype(np.int32)
    mask = np.ones((b, t_), np.int32)
    mask[1, 5:] = 0  # ragged right padding
    mask[2, 3:] = 0
    images = rng.random((b, 3, 64, 64), dtype=np.float32)
    return images, ids, mask


# fp32 through two decoder layers, a 64-wide vocab projection and the tower
LOGIT_ATOL = 1e-4


class TestCachedSteps:
    def test_prefill_then_decode_steps(self, vlm):
        jm, params, tm = vlm
        images, ids, mask = _prompts()
        max_len = jm.cfg.num_image_tokens + ids.shape[1] + 3
        jcache = j_qwen.init_kv_cache(jm.cfg.text, 3, max_len)
        jlast, _, jcache, _, _ = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(ids),
                                          jnp.asarray(mask), jcache, method=j_vlm.FastVLM.prefill)
        tcache = t_qwen.init_kv_cache(tm.cfg.text, 3, max_len)
        with torch.no_grad():
            tlast, _, tcache, _, _ = tm.prefill(t(images), t(ids), t(mask), tcache)
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=LOGIT_ATOL)
        np.testing.assert_array_equal(tcache["mask"].numpy(), np.asarray(jcache["mask"]))
        np.testing.assert_array_equal(tcache["index"].numpy(), np.asarray(jcache["index"]))
        tok = np.asarray(jnp.argmax(jlast, axis=-1)).astype(np.int32)
        for _ in range(3):
            jlogits, jcache = jm.apply({"params": params}, jnp.asarray(tok[:, None]), jcache,
                                       method=j_vlm.FastVLM.decode_step)
            with torch.no_grad():
                tlogits, tcache = tm.decode_step(t(tok[:, None]), tcache)
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL)
            tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in jcache:
                np.testing.assert_allclose(tcache[name].float().numpy(), np.asarray(jcache[name], np.float32),
                                           atol=LOGIT_ATOL)

    def test_decode_step_paged(self, vlm):
        """One paged tick on pools holding random rows: logits and the returned rows."""
        jm, params, tm = vlm
        cfg = jm.cfg.text
        rng = np.random.default_rng(3)
        n_layers, kv, d = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.resolved_head_dim
        page, p_total, p_slot = 4, 9, 4
        pools = {
            "pool_k": rng.standard_normal((n_layers, p_total, kv, page, d)).astype(np.float32),
            "pool_v": rng.standard_normal((n_layers, p_total, kv, page, d)).astype(np.float32),
        }
        if cfg.kv_cache_quantization == "int8":
            for name in ("pool_k", "pool_v"):
                qv, sc = j_quant.quantize_kv(jnp.asarray(pools[name]))
                pools[name], pools[name + "_scale"] = np.asarray(qv), np.asarray(sc)
        tables = np.array([[1, 4, 0, 0], [2, 0, 0, 0], [0, 0, 0, 0]], np.int32)
        mask = np.zeros((3, p_slot * page), bool)
        mask[0, :6] = True
        mask[0, 2] = False  # a dead pad slot inside the window
        mask[1, :3] = True
        mask[2, 0] = True  # an inactive slot: one-hot on trash
        cache = dict(pools, tables=tables, mask=mask, index=np.array([6, 3, 1], np.int32))
        tokens = np.array([[5], [17], [2]], np.int32)
        jlogits, jrows = jm.apply({"params": params}, jnp.asarray(tokens), {k: jnp.asarray(v) for k, v in cache.items()},
                                  method=j_vlm.FastVLM.decode_step_paged)
        with torch.no_grad():
            tlogits, trows = tm.decode_step_paged(t(tokens), {k: t(v) for k, v in cache.items()})
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL)
        assert sorted(trows) == sorted(jrows)
        for name in jrows:
            np.testing.assert_allclose(trows[name].float().numpy(), np.asarray(jrows[name], np.float32),
                                       atol=LOGIT_ATOL)
