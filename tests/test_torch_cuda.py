"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import). Run them on a machine with an H100; that machine
has no JAX, so leave out ``tests/conftest.py``:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

``chip_smoke.py`` holds the same kernels against their plain versions at the
main path's full shapes.
"""

import importlib

import numpy as np
import pytest
import torch

from vla_fastvlm_tpu_torch.device import strict_fp32
from vla_fastvlm_tpu_torch.ops.kernels import (
    flash_attention,
    flash_attention_reference,
    flash_attention_streamed,
    launch_counts,
    paged_attention_decode,
    paged_attention_decode_reference,
    paged_attention_window,
    paged_attention_window_reference,
    repmixer_block,
    repmixer_block_reference,
    reset_launch_counts,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    strict_fp32()
    return torch.device("cuda")


def _flash_inputs(b, t, n, kh, d, dtype, device, seed=0, pad="right"):
    """Row 0 padded ("right": its last 5 keys; "left": its first 5, and row 1
    its first half, so under causal masking their first positions see no
    allowed key); the last row entirely padded."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, t, n, d, generator=g).to(device, dtype)
    k = torch.randn(b, t, kh, d, generator=g).to(device, dtype)
    v = torch.randn(b, t, kh, d, generator=g).to(device, dtype)
    mask = torch.ones(b, t, dtype=torch.int32)
    if pad == "right":
        mask[0, max(t - 5, 1):] = 0
    else:
        mask[0, :min(5, t - 1)] = 0
        mask[1, :t // 2] = 0
    mask[-1, :] = 0  # one sequence entirely padded
    return q, k, v, mask.to(device)


# (b, t, n, kh, d, mask padding, causal): the policy's heads, the 7B
# decoder's (D = 128), left padding, T = 1, T = 17 and 100 (7 x 17 = 119 and
# 7 x 100 = 700 packed rows: not whole blocks of 112), rep 1 and rep 8.
FLASH_CASES = [
    (3, 80, 14, 2, 64, "right", True),
    (3, 80, 14, 2, 128, "right", True),
    (3, 80, 14, 2, 64, "left", True),
    (3, 80, 28, 4, 128, "left", True),
    (3, 80, 14, 2, 64, "left", False),
    (3, 1, 14, 2, 64, "right", True),
    (3, 17, 14, 2, 64, "left", True),
    (2, 100, 14, 2, 64, "right", True),
    (3, 100, 28, 4, 128, "left", False),
    (3, 80, 8, 8, 64, "left", True),
    (3, 33, 16, 2, 128, "right", True),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(cuda, case, dtype, atol):
    b, t, n, kh, d, pad, causal = case
    q, k, v, mask = _flash_inputs(b, t, n, kh, d, dtype, cuda, pad=pad)
    reset_launch_counts()
    out = flash_attention(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    ref = flash_attention_reference(q, k, v, mask, causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)


@pytest.mark.parametrize("tiles,warps", [(1, 1), (4, 2), (7, 7), (8, 4), (35, 8)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_flash_block_shapes_match_plain(cuda, tiles, warps, dtype, atol):
    """Blocks of other sizes than the plan's, warps running several tiles in turn."""
    fa = importlib.import_module("vla_fastvlm_tpu_torch.ops.kernels.flash_attention")
    q, k, v, mask = _flash_inputs(3, 80, 14, 2, 64, dtype, cuda, pad="left")
    out = fa._launch(q, k, v, mask, True, 0.125, tiles=tiles, warps=warps)
    ref = flash_attention_reference(q, k, v, mask, True)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)


def test_flash_streamed_instance_runs_a_warp_a_tile(cuda):
    """The streamed instance holds a tile a warp across its key blocks: it
    takes the tiles at any warps and refuses more than 8."""
    fa = importlib.import_module("vla_fastvlm_tpu_torch.ops.kernels.flash_attention")
    q, k, v, mask = _flash_inputs(2, 80, 14, 2, 64, torch.bfloat16, cuda, pad="left")
    out = fa._launch(q, k, v, mask, True, 0.125, streamed=True, tiles=7, warps=2)
    torch.testing.assert_close(out.float(), flash_attention_reference(q, k, v, mask, True).float(), atol=2e-2, rtol=2e-2)
    with pytest.raises(RuntimeError, match="flash_attention_fwd"):
        fa._launch(q, k, v, mask, True, 0.125, streamed=True, tiles=9, warps=8)


@pytest.mark.parametrize("s", [1024, 80])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_flash_streamed_instance_matches_plain(cuda, s, dtype, atol):
    """Above what shared memory holds the wrapper takes the streamed instance
    by itself; at the policy's S = 80 it is asked for by name."""
    q, k, v, mask = _flash_inputs(2, s, 14, 2, 64, dtype, cuda)
    ref = flash_attention_reference(q, k, v, mask, True)
    out = flash_attention(q, k, v, mask, True) if s > 768 else flash_attention_streamed(q, k, v, mask, True)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)


def _rep_args(b, h, w, c, f, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    arr = lambda *s, scale=0.5: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
    w3 = torch.zeros(3, 3, 1, c)
    w3[1, 1, 0] = 1.0
    w7 = torch.zeros(7, 7, 1, c)
    w7[3, 3, 0] = 1.0
    args = [arr(b, h, w, c, scale=1.0), w3 + arr(3, 3, 1, c, scale=0.1), arr(c) + 5.0,
            w7 + arr(7, 7, 1, c, scale=0.05), arr(c), arr(c, f, scale=c ** -0.5), arr(f),
            arr(f, c, scale=f ** -0.5), arr(c), arr(c, scale=0.5)]
    return [a.to(device, dtype) for a in args]


@pytest.mark.parametrize("pad,causal", [("right", True), ("left", True), ("left", False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_gradients_are_the_plain_versions(cuda, pad, causal, dtype):
    """The train_backbone path: the forward launches the kernel once, the
    backward recomputes through the plain version and launches nothing, so
    the gradients are plain autograd's (fully padded rows and left padding
    included), up to the order of the library's sums between two runs."""
    q, k, v, mask = _flash_inputs(3, 80, 14, 2, 64, dtype, cuda, pad=pad)
    upstream = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(cuda)

    def grads(fn):
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fn(*qkv, mask, causal)
        return out, torch.autograd.grad((out.float() * upstream).sum(), qkv)

    reset_launch_counts()
    out, got = grads(flash_attention)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    ref_out, expect = grads(flash_attention_reference)
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol, rtol=atol)
    _same_grads(got, expect, dtype)


def _same_grads(got, expect, dtype):
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for g, e in zip(got, expect):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), e.float(), rtol=tol, atol=tol * float(e.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_repmixer_kernel_gradients_are_the_plain_versions(cuda, dtype):
    args = [a.detach().requires_grad_() for a in _rep_args(2, 12, 20, 192, 768, dtype, cuda)]
    upstream = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(2)).to(cuda)

    def grads(fn):
        inputs = [a.detach().requires_grad_() for a in args]
        return torch.autograd.grad((fn(*inputs).float() * upstream).sum(), inputs)

    reset_launch_counts()
    got = grads(repmixer_block)
    torch.cuda.synchronize()
    assert launch_counts()["repmixer_block"] == 1
    _same_grads(got, grads(repmixer_block_reference), dtype)


REP_SHAPES = [
    (2, 16, 16, 96, 384), (1, 12, 20, 192, 768), (1, 12, 20, 384, 1536),
    # ragged pixel grids: tiles cut by the image's edge
    (3, 12, 20, 96, 384), (2, 20, 28, 192, 768), (1, 36, 44, 192, 768),
    # batch 2 at each main-path stage shape (256 px)
    (2, 64, 64, 96, 384), (2, 32, 32, 192, 768), (2, 16, 16, 384, 1536),
]


@pytest.mark.parametrize("shape", REP_SHAPES)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-1)])
def test_repmixer_kernel_matches_plain(cuda, shape, dtype, atol):
    args = _rep_args(*shape, dtype, cuda)
    reset_launch_counts()
    out = repmixer_block(*args)
    torch.cuda.synchronize()
    assert launch_counts()["repmixer_block"] == 1
    ref = repmixer_block_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)


def _paged_inputs(b, n, kh, d, dtype, int8, device, page=16, p_slot=6, seed=0, room=1):
    """Slot b % 4 == 0: inactive (empty stored mask, all trash); others hold
    ragged, non page-aligned lengths with pad holes, the rest of their table
    on the trash page; each cursor leaves ``room`` positions for new rows."""
    from vla_fastvlm_tpu_torch.ops.quant import quantize_kv

    g = torch.Generator(device="cpu").manual_seed(seed)
    p_total = b * p_slot + 1
    rnd = lambda *s: torch.randn(*s, generator=g)
    q, kn, vn = rnd(b, n, d), rnd(b, kh, d), rnd(b, kh, d)
    pk, pv = rnd(p_total, kh, page, d), rnd(p_total, kh, page, d)
    tables = torch.zeros(b, p_slot, dtype=torch.int32)
    mask = torch.zeros(b, p_slot * page, dtype=torch.bool)
    lengths = torch.ones(b, dtype=torch.int32)
    perm = torch.randperm(p_total - 1, generator=g) + 1
    for i in range(b):
        if i % 4 == 0:
            continue
        length = int(torch.randint(1, p_slot * page + 1 - room, (1,), generator=g))
        used = -(-length // page)
        tables[i, :used] = perm[i * p_slot: i * p_slot + used]
        mask[i, :length] = True
        mask[i, length // 3] = False  # a dead pad slot
        lengths[i] = length
    scales = {}
    if int8:
        (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
        scales = dict(pool_k_scale=ks.to(device), pool_v_scale=vs.to(device))
        (kq, kss), (vq, vss) = quantize_kv(kn), quantize_kv(vn)
        kn, vn = kq.float() * kss[..., None], vq.float() * vss[..., None]
    else:
        pk, pv = pk.to(dtype), pv.to(dtype)
    args = [q.to(dtype), pk, pv, tables, mask, lengths, kn.to(dtype), vn.to(dtype)]
    return [a.to(device) for a in args], scales


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_paged_kernel_matches_plain(cuda, d, int8, dtype, atol):
    args, scales = _paged_inputs(9, 14, 2, d, dtype, int8, cuda)
    reset_launch_counts()
    out = paged_attention_decode(*args, **scales)
    torch.cuda.synchronize()
    assert launch_counts()["paged_attention"] == 1
    ref = paged_attention_decode_reference(*args, **scales)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)
    # inactive slots attend only their new row
    torch.testing.assert_close(out[0].float(), args[7][0].float().repeat_interleave(7, dim=0), atol=atol, rtol=atol)


def _window_inputs(b, w, n, kh, d, dtype, int8, device, seed=0, p_slot=6):
    """``_paged_inputs``' slots with a W-token window at each cursor; pool
    rows at and past the cursor hold random values (a rejected suffix)."""
    from vla_fastvlm_tpu_torch.ops.quant import quantize_kv

    args, scales = _paged_inputs(b, n, kh, d, dtype, int8, device, seed=seed, room=w, p_slot=p_slot)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    q, kn, vn = (torch.randn(*shape, generator=g) for shape in ((b, w, n, d), (b, w, kh, d), (b, w, kh, d)))
    if int8:
        (kq, kss), (vq, vss) = quantize_kv(kn), quantize_kv(vn)
        kn, vn = kq.float() * kss[..., None], vq.float() * vss[..., None]
    args[0], args[6], args[7] = (x.to(device, dtype) for x in (q, kn, vn))
    return args, scales


@pytest.mark.parametrize("w", [2, 5, 9])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_paged_window_kernel_matches_plain(cuda, w, d, int8, dtype, atol):
    args, scales = _window_inputs(9, w, 28, 4, d, dtype, int8, cuda)
    reset_launch_counts()
    out = paged_attention_window(*args, **scales)
    torch.cuda.synchronize()
    assert launch_counts()["paged_attention_window"] == 1 and launch_counts()["paged_attention"] == 0
    ref = paged_attention_window_reference(*args, **scales)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)
    # inactive slots (empty stored mask): window position 0 is its own new V row
    torch.testing.assert_close(out[0, 0].float(), args[7][0, 0].float().repeat_interleave(7, dim=0),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_paged_kernels_at_forced_split_counts(cuda, w, splits, int8, dtype, atol):
    """Both paged kernels with the stored window (4 tiles of 64) cut into 1, 2
    and 4 parts, slot 1 with tile 1 masked whole (an all-masked split at 4):
    one launch, the plain version's result and the split twin's, and every
    ticket counter back at 0."""
    from vla_fastvlm_tpu_torch.ops.kernels import paged_attention as pa

    if w == 1:
        args, scales = _paged_inputs(9, 14, 2, 64, dtype, int8, cuda, p_slot=16)
    else:
        args, scales = _window_inputs(9, w, 14, 2, 64, dtype, int8, cuda, p_slot=16)
    args[4][1, 64:128] = False
    reset_launch_counts()
    out = pa._launch(*args[:5], *args[6:], scales.get("pool_k_scale"), scales.get("pool_v_scale"), 64 ** -0.5,
                     splits=splits)
    torch.cuda.synchronize()
    assert sum(launch_counts().values()) == 1
    plain = (paged_attention_decode_reference if w == 1 else paged_attention_window_reference)(*args, **scales)
    torch.testing.assert_close(out.float(), plain.float(), atol=atol, rtol=atol)
    twin = pa.paged_attention_split_reference(*args, **scales, splits=splits)
    torch.testing.assert_close(out.float(), twin.float(), atol=atol, rtol=atol)
    assert all(int(c.abs().sum()) == 0 for c in pa._COUNTERS.values())


# (B, W, N, K, D, int8 pools, P_slot, parts): the serving shapes, with the
# part counts that measured fastest of 1, 2, 3 and 6 on an H100 80GB HBM3
# (chip_smoke.py --only paged). The int8 7B verify instance holds 4 blocks an
# SM and the bf16 one 2, so the two take 6 and 3 parts.
H100_PLANS = [(64, 1, 14, 2, 64, False, 24, 3), (64, 1, 14, 2, 64, True, 24, 3),
              (16, 1, 28, 4, 128, False, 24, 6), (16, 1, 28, 4, 128, True, 24, 6),
              (17, 5, 28, 4, 128, False, 23, 3), (17, 5, 28, 4, 128, True, 23, 6),
              (65, 5, 14, 2, 64, False, 23, 3), (65, 5, 14, 2, 64, True, 23, 3)]


@pytest.mark.parametrize("plan", H100_PLANS, ids=str)
def test_paged_split_plan_on_an_h100(cuda, plan):
    """The launch's plan reads the instance's occupancy on the card and picks
    the serving shapes' fastest part counts."""
    from vla_fastvlm_tpu_torch.ops.kernels import paged_attention as pa

    if "H100" not in torch.cuda.get_device_name(cuda):
        pytest.skip("part counts measured on an H100")
    b, w, n, kh, d, int8, p_slot, parts = plan
    q = torch.empty((b, w, n, d) if w > 1 else (b, n, d), dtype=torch.bfloat16, device=cuda)
    pool_k = torch.empty(b * p_slot + 1, kh, 16, d, dtype=torch.int8 if int8 else torch.bfloat16, device=cuda)
    tables = torch.zeros(b, p_slot, dtype=torch.int32, device=cuda)
    wave = pa.instance_wave(q, pool_k)
    assert wave % torch.cuda.get_device_properties(cuda).multi_processor_count == 0
    assert pa.planned_splits(q, pool_k, tables) == parts


def test_paged_counters_regrow_under_a_captured_graph(cuda):
    """A CUDA graph that captured the decode kernel replays to the same result
    after a larger batch has made the kernel's ticket counters grow: the old
    buffer is kept, and every counter is back at 0."""
    from vla_fastvlm_tpu_torch.ops.kernels import paged_attention as pa

    args, _ = _paged_inputs(9, 14, 2, 64, torch.float32, False, cuda)
    ref = paged_attention_decode_reference(*args)
    paged_attention_decode(*args)  # the counters exist before the capture
    torch.cuda.synchronize()
    key = next(k for k in pa._COUNTERS if k[1] == "paged_attention_fwd")
    old = pa._COUNTERS[key]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = paged_attention_decode(*args)
    big, _ = _paged_inputs(old.numel() // 2 + 1, 2, 2, 64, torch.float32, False, cuda, p_slot=1)
    paged_attention_decode(*big)
    torch.cuda.synchronize()
    assert pa._COUNTERS[key] is not old and any(r is old for r in pa._RETIRED)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    assert all(int(c.abs().sum()) == 0 for c in [*pa._COUNTERS.values(), *pa._RETIRED])


def test_paged_attention_window_on_the_card_launches_the_kernel(cuda):
    """``paged_attention`` at W > 1 on a CUDA tensor is the window kernel;
    ``impl="xla"`` is the only way to the plain version."""
    from vla_fastvlm_tpu_torch.ops.attention import paged_attention

    args, _ = _window_inputs(5, 5, 14, 2, 64, torch.bfloat16, False, cuda)
    reset_launch_counts()
    out = paged_attention(*args)
    plain = paged_attention(*args, impl="xla")
    torch.cuda.synchronize()
    assert launch_counts()["paged_attention_window"] == 1
    torch.testing.assert_close(out.float(), plain.float(), atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(args[0][..., :32].contiguous(), args[1][..., :32].contiguous(),
                        args[2][..., :32].contiguous(), *args[3:6], args[6][..., :32].contiguous(),
                        args[7][..., :32].contiguous())


def test_paged_server_kernel_path_raises_on_shapes_the_kernel_does_not_take(cuda):
    """On the card decode_impl "kernel" launches the paged kernel or raises:
    the tiny decoder's head_dim 16 has no kernel, and nothing falls back."""
    from vla_fastvlm_tpu_torch.models import FastVLM, fastvlm_tiny
    from vla_fastvlm_tpu_torch.serving import PagedGenerationServer

    with torch.device(cuda):
        model = FastVLM(fastvlm_tiny().replace(image_token_mode="none")).eval()
    server = PagedGenerationServer(model, num_slots=2, prompt_len=4, max_new_tokens=3, eos_token_id=-1, page_size=4)
    server.submit(np.array([[5, 6, 7, 0]], np.int32), np.array([[1, 1, 1, 0]], np.int32))
    with pytest.raises(ValueError, match="head_dim"):
        server.step()


def test_auto_impls_raise_on_shapes_the_kernels_do_not_take(cuda):
    """On the card "auto" is the kernel path: no quiet plain fallback."""
    from vla_fastvlm_tpu_torch.models.fastvit import RepMixerBlock, fastvithd_tiny
    from vla_fastvlm_tpu_torch.ops.attention import attention

    q, k, v, mask = _flash_inputs(1, 16, 4, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attention(q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous(),
                  kv_mask=mask, causal=True, impl="auto")
    with torch.device(cuda):
        block = RepMixerBlock(32, fastvithd_tiny(block_impl="auto"), 4.0)
    with pytest.raises(ValueError, match="repmixer kernel"), torch.no_grad():
        block(torch.zeros(1, 8, 8, 32, device=cuda))


def test_policy_forward_keeps_cuda_inputs_on_the_card(cuda):
    """Images and states already on the card go through ``FastVLAPolicy.forward``
    without a host round trip and give the numpy inputs' actions."""
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy

    cfg = FastVLAConfig(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny",
                        state_dim=6, action_dim=5, hidden_dim=16, fusion_dim=16,
                        tokenizer_max_length=16, attention_impl="xla", vision_block_impl="xla")
    policy = FastVLAPolicy(cfg)
    rng = np.random.default_rng(0)
    images = rng.random((2, 3, 48, 64), dtype=np.float32)
    states = rng.standard_normal((2, 6)).astype(np.float32)
    ref = policy.forward(images, states, "pick up the cube")
    cimg, cstates = torch.from_numpy(images).to(cuda), torch.from_numpy(states).to(cuda)
    prepared = policy.processor.prepare_images(cimg)
    assert prepared.device.type == "cuda"
    out = policy.forward(cimg, cstates, "pick up the cube")
    assert out.device.type == "cuda"
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_kernels_reject_non_contiguous(cuda):
    q, k, v, mask = _flash_inputs(1, 16, 4, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, mask, True)


def _card_policy(cls, **kw):
    """FastVLA-0.5B's decoder and tower, fp32, at 64 px (1 image token):
    every kernel of the closed loop takes these shapes."""
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig

    return cls(FastVLAConfig(vlm_model_name="fastvlm-0.5b", bootstrap_model_name="fastvlm-0.5b", image_size=64,
                             tokenizer_max_length=16, state_dim=4, action_dim=4, dtype="float32",
                             param_dtype="float32", dropout=0.0, **kw))


def _card_obs(b=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((b, 3, 48, 80), dtype=np.float32), (rng.standard_normal((b, 4)) * 0.5).astype(np.float32),
            ["pick up the cube", "open the drawer", "push", "stack the cups"][:b])


def test_token_head_paged_tick_on_the_card(cuda):
    """One control tick of the token head on the paged server, raw frames
    letterboxed inside admission: the paged kernel decodes (24 launches a
    tick), the RepMixer kernel runs in each admission, the tokens are the
    policy's own dense-cache decode (fp32), every page comes back."""
    from vla_fastvlm_tpu_torch.fastvla import FastVLMTokenPolicy
    from vla_fastvlm_tpu_torch.model.fastvlm_adapter import prepare_policy_images
    from vla_fastvlm_tpu_torch.serving import PagedGenerationServer, TokenPolicyServer

    policy = _card_policy(FastVLMTokenPolicy, action_head="token")
    mcfg, bcfg = policy.backbone.model_config, policy.backbone.config
    server = PagedGenerationServer(policy.backbone.model, num_slots=4, prompt_len=16 + 4, max_new_tokens=4,
                                   eos_token_id=-1, prefill_batch=2, page_size=16,
                                   image_prep=lambda imgs: prepare_policy_images(imgs, mcfg, bcfg))
    bridge = TokenPolicyServer(policy, server)
    obs = _card_obs()
    ref = policy.tokens(*obs).cpu().numpy()
    reset_launch_counts()
    actions = bridge.forward(*obs)
    assert launch_counts() == {"flash_attention": 0, "repmixer_block": 38 * server.admissions,
                               "paged_attention": 24 * server.ticks, "paged_attention_window": 0}
    assert (server.admissions, server.ticks) == (2, 3)
    np.testing.assert_array_equal(bridge.last_tokens, ref)
    np.testing.assert_array_equal(policy.tokenizer.decode(policy.tokenizer.encode(actions)), actions)
    assert server.pool.free_pages == server.pool.num_pages - 1 and not server.pool.page_table.any()


def test_staggered_runner_on_the_card(cuda):
    """The MLP policy in two staggered groups against the serial runner:
    the dispatch leaves its actions on the card, every forward launches 24
    flash and 38 RepMixer kernels, and the returns agree."""
    from vla_fastvlm_tpu_torch.fastvla import FastVLAPolicy
    from vla_fastvlm_tpu_torch.scripts.eval_closed_loop import DummyEnv
    from vla_fastvlm_tpu_torch.serving import ActionQueuePolicy, BatchedEnvRunner

    policy = _card_policy(FastVLAPolicy, hidden_dim=16, fusion_dim=16)
    make = lambda: [DummyEnv(horizon=3, state_dim=4, image_hw=48, seed=i) for i in range(4)]
    serial = BatchedEnvRunner(make(), ActionQueuePolicy(policy, 1), task="go").run(max_steps=3)
    reset_launch_counts()
    staggered = BatchedEnvRunner(make(), ActionQueuePolicy(policy, 1), task="go").run(max_steps=3, stagger=2)
    torch.cuda.synchronize()
    forwards = 2 * (3 + 1)  # each group: the prologue's dispatch and one after each tick
    assert launch_counts() == {"flash_attention": 24 * forwards, "repmixer_block": 38 * forwards,
                               "paged_attention": 0, "paged_attention_window": 0}
    np.testing.assert_allclose(staggered["returns"], serial["returns"], rtol=1e-5)
    assert staggered["lengths"].tolist() == serial["lengths"].tolist() == [3] * 4
    images, states, tasks = _card_obs()
    pending = ActionQueuePolicy(policy, 1).dispatch_chunk({"images": images, "states": states, "tasks": tasks})
    assert isinstance(pending, torch.Tensor) and pending.device.type == "cuda"


def _card_vlm(cuda):
    """FastVLM-0.5B's decoder and tower, fp32, at 64 px (1 image token)."""
    from vla_fastvlm_tpu_torch.models import FastVLM, fastvlm_0_5b, init_weights

    with torch.device(cuda):
        model = FastVLM(fastvlm_0_5b(image_size=64))
    init_weights(model, torch.Generator(device=cuda).manual_seed(0))
    return model.eval().requires_grad_(False)


def _template_requests(n, seed=0):
    """``n`` 48-token prompts on one 64-px frame sharing a 31-token
    template: the image and the template fill pages 0 and 1 (16 positions)."""
    rng = np.random.default_rng(seed)
    frame = rng.random((1, 3, 64, 64), dtype=np.float32)
    template = rng.integers(3, 250, 31)
    return [(np.concatenate([template, rng.integers(3, 250, 17)]).astype(np.int32)[None], np.ones((1, 48), np.int32),
             frame) for _ in range(n)]


def _prefill_logits(model, reqs, device):
    from vla_fastvlm_tpu_torch.models.qwen2 import init_kv_cache

    ids, mask, images = (np.concatenate([r[j] for r in reqs]) for j in range(3))
    with torch.no_grad():
        cache = init_kv_cache(model.cfg.text, len(reqs), 64, device=device)
        return model.prefill(*(torch.from_numpy(a).to(device) for a in (images, ids, mask)), cache)[0]


def test_chunked_admission_and_partial_hits_on_the_card(cuda):
    """A chunked miss (an image chunk, three text chunks) and three
    page-level partial hits on the paged server over the kernels: each
    first-token logits within 2e-2 rel. L2 of the whole-prompt prefill, the
    RepMixer kernel run once (the image chunk), the paged kernel 24 times a
    tick, every page back once the prefix cache is emptied."""
    from vla_fastvlm_tpu_torch.serving import PagedGenerationServer

    model = _card_vlm(cuda)
    reqs = _template_requests(4)
    server = PagedGenerationServer(model, num_slots=4, prompt_len=48, max_new_tokens=4, eos_token_id=-1,
                                   page_size=16, prefill_batch=2, prefix_cache_size=4, prefill_chunk_tokens=16)
    reset_launch_counts()
    server.submit(*reqs[0])
    server.flush()
    for req in reqs[1:]:
        server.submit(*req)
    server.run_to_completion()
    assert (server.prefix_cache_hits, server.prefix_cache_partial_hits, server.prefix_cache_misses) == (0, 3, 1)
    assert launch_counts() == {"flash_attention": 0, "repmixer_block": 38, "paged_attention": 24 * server.ticks,
                               "paged_attention_window": 0}
    got = torch.stack([server._prefix_cache[server._prompt_hashes(*r)[0]]["logits"] for r in reqs])
    ref = _prefill_logits(model, reqs, cuda)
    assert float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max()) <= 2e-2
    server.evict_prefix_cache()
    assert server.pool.free_pages == server.pool.num_pages - 1 and not server.pool.page_table.any()


def test_whole_prefix_hit_leaves_shared_pages_on_the_card(cuda):
    """A whole-prompt hit samples its first token from the entry's logits
    (within 2e-2 rel. L2 of the whole-prompt prefill), copies the tail page
    and decodes into the copy: the entry's pages keep their bytes."""
    from vla_fastvlm_tpu_torch.serving import PagedGenerationServer

    model = _card_vlm(cuda)
    req = _template_requests(1, seed=1)[0]  # prefill 49: three full pages and one position
    server = PagedGenerationServer(model, num_slots=2, prompt_len=48, max_new_tokens=4, eos_token_id=-1,
                                   page_size=16, prefill_batch=1, prefix_cache_size=2)
    server.submit(*req)
    first = server.run_to_completion()
    entry = next(iter(server._prefix_cache.values()))
    pages = torch.tensor(entry["pages"], device=cuda)
    before = {name: buf[:, pages].clone() for name, buf in server.pool.pools().items()}
    reset_launch_counts()
    server.submit(*req)
    second = server.run_to_completion()
    assert launch_counts()["repmixer_block"] == 0 and server.prefix_cache_hits == 1
    assert list(second.values()) == list(first.values())
    for name, buf in server.pool.pools().items():
        assert torch.equal(buf[:, pages], before[name]), name
    ref = _prefill_logits(model, [req], cuda)[0]
    assert float((entry["logits"] - ref).norm() / ref.norm()) <= 2e-2


@pytest.mark.parametrize("mode,tokens", [("int8", 16), ("int4", 16), ("int4", 512), ("w8a8", 1024)])
def test_quantized_products_on_the_card(cuda, mode, tokens):
    """The quantized products (plain torch: the codes converted each call;
    w8a8 through ``torch._int_mm`` at 1024 tokens) on the card in fp32
    against the same call on the CPU, within 1e-5 relative (the int32
    accumulation of w8a8 is exact on both)."""
    from vla_fastvlm_tpu_torch.ops import quant

    g = torch.Generator(device="cpu").manual_seed(0)
    w = torch.randn(384, 512, generator=g) / 512 ** 0.5
    x = torch.randn(tokens, 512, generator=g)
    leaf = quant.quantize_kernel_int4(w) if mode == "int4" else quant.quantize_kernel(w)
    ref = quant.dense_apply(x, leaf, torch.float32, act_quant=mode == "w8a8")
    got = quant.dense_apply(x.to(cuda), {k: v.to(cuda) for k, v in leaf.items()}, torch.float32,
                            act_quant=mode == "w8a8")
    assert float((got.cpu() - ref).norm() / ref.norm()) <= 1e-5


def test_quantized_paged_server_on_the_card(cuda):
    """An int8 FastVLM-0.5B decoder (64 px, fp32) on the paged server over
    the kernels: 24 paged launches a tick, and the tokens of the int8
    model's own ``generate``."""
    from vla_fastvlm_tpu_torch.io.quantize import quantize_params
    from vla_fastvlm_tpu_torch.serving import PagedGenerationServer, generate

    model = quantize_params(_card_vlm(cuda), mode="int8")
    req = _template_requests(1)[0]
    server = PagedGenerationServer(model, num_slots=2, prompt_len=48, max_new_tokens=4, eos_token_id=-1,
                                   page_size=16, prefill_batch=1)
    reset_launch_counts()
    rid = server.submit(*req)
    out = server.run_to_completion()
    assert launch_counts()["paged_attention"] == 24 * server.ticks
    ref = generate(model, req[2], req[0], req[1], max_new_tokens=4, eos_token_id=-1)
    assert out[rid] == ref[0].tolist()
