"""The port's speculative decoding over the paged server against the JAX package, on the CPU.

- ``FastVLM.verify_step_paged``: (B, W) window logits and the window's K/V
  rows against JAX's on pools holding random rows, to 1e-4 (float and int8
  pools; trash pages, a dead pad slot, an inactive slot).
- Greedy tokens of ``SpeculativePagedGenerationServer`` (k 1 and 3,
  ``decode_impl`` "kernel" and "gathered", float and int8 pools) against the
  JAX ``SpeculativePagedGenerationServer`` on the same bridged weights,
  exactly, and against the port's plain ``PagedGenerationServer``; slot and
  page reuse under oversubscription (5 requests, 2 slots, every page back);
  the self-draft server needs fewer ticks; kernel and gathered verify logits
  agree from one admitted state.
- Refusals: vocab mismatch, ``k < 1``, ``step_n``, a draft on another device.

On the CPU "kernel" runs the window kernel's plain version; the kernel
itself is held to it on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.models import fastvlm as j_vlm
from vla_fastvlm_tpu.models import qwen2 as j_qwen
from vla_fastvlm_tpu.ops import quant as j_quant
from vla_fastvlm_tpu.serving.speculative_paged import SpeculativePagedGenerationServer as JSpecPaged
from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch
from vla_fastvlm_tpu_torch.models import fastvlm as t_vlm
from vla_fastvlm_tpu_torch.models import qwen2 as t_qwen
from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from vla_fastvlm_tpu_torch.serving import PagedGenerationServer, SpeculativePagedGenerationServer

from _torch_parity import jax_param_shapes, random_params, t

PROMPT, NEW, PAGE = 8, 7, 4
LOGIT_ATOL = 1e-4
# The token embedding is scaled down so greedy sequences vary and a
# separate draft is mostly rejected (``tests/test_torch_speculative.py``).
EMBED_SCALE = 0.1


def _requests(n=5, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(2, PROMPT + 1))
        ids = np.zeros((1, PROMPT), np.int32)
        mask = np.zeros((1, PROMPT), np.int32)
        ids[0, :length] = rng.integers(3, 500, length)
        mask[0, :length] = 1
        out.append((ids, mask, rng.random((1, 3, 64, 64), dtype=np.float32)))
    return out


REQS = _requests()


def _drive(server, reqs=REQS):
    """Submit as slots free up, step until drained; tokens by request order."""
    rids, outputs = [], {}
    pending = list(reqs)
    while pending or server.num_active:
        while pending and server.has_free_slot():
            rids.append(server.submit(*pending.pop(0)))
        outputs.update(server.step())
    return np.array([outputs[r] for r in rids])


def _models(kvq, seed):
    jm = j_vlm.FastVLM(j_vlm.fastvlm_tiny().replace(text=j_qwen.qwen2_tiny(kv_cache_quantization=kvq)))
    params = random_params(jax_param_shapes(jm, jnp.zeros((1, 3, 64, 64)), jnp.ones((1, PROMPT), jnp.int32)),
                           seed=seed)
    embed = params["language_model"]["embed_tokens"]
    embed["embedding"] = embed["embedding"] * EMBED_SCALE
    tm = t_vlm.FastVLM(t_vlm.fastvlm_tiny().replace(text=t_qwen.qwen2_tiny(kv_cache_quantization=kvq)))
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    return jm, params, tm.eval().requires_grad_(False)


SERVER_KW = dict(num_slots=2, prompt_len=PROMPT, max_new_tokens=NEW, eos_token_id=-1, page_size=PAGE)


@pytest.fixture(scope="module", params=["none", "int8"])
def pair(request):
    """Target and draft on both sides, the port's plain paged server's
    tokens, and the JAX speculative paged server's tokens per k."""
    kvq = request.param
    (jt, tp, tt), (jd, dp, td) = _models(kvq, 2), _models(kvq, 9)
    plain = _drive(PagedGenerationServer(tt, **SERVER_KW))
    ref = {k: _drive(JSpecPaged(jt, tp, jd, dp, k=k, **SERVER_KW)) for k in (1, 3)}
    return dict(kvq=kvq, jt=jt, tp=tp, tt=tt, td=td, plain=plain, ref=ref)


class TestVerifyStepPaged:
    @pytest.mark.parametrize("kvq", ["none", "int8"])
    def test_logits_and_rows_match_jax(self, kvq):
        jm, params, tm = _models(kvq, 4)
        cfg = jm.cfg.text
        rng = np.random.default_rng(3)
        n_layers, kv, d = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.resolved_head_dim
        p_total, p_slot, w = 9, 4, 4
        pools = {name: rng.standard_normal((n_layers, p_total, kv, PAGE, d)).astype(np.float32)
                 for name in ("pool_k", "pool_v")}
        if kvq == "int8":
            for name in ("pool_k", "pool_v"):
                qv, sc = j_quant.quantize_kv(jnp.asarray(pools[name]))
                pools[name], pools[name + "_scale"] = np.asarray(qv), np.asarray(sc)
        tables = np.array([[1, 4, 7, 0], [2, 3, 0, 0], [0, 0, 0, 0]], np.int32)
        mask = np.zeros((3, p_slot * PAGE), bool)
        mask[0, :6] = True
        mask[0, 2] = False  # a dead pad slot inside the window
        mask[1, :3] = True
        mask[2, 0] = True  # an inactive slot: one-hot on trash
        cache = dict(pools, tables=tables, mask=mask, index=np.array([6, 3, 1], np.int32))
        window = rng.integers(3, 500, (3, w)).astype(np.int32)
        jlogits, jrows = jm.apply({"params": params}, jnp.asarray(window),
                                  {k: jnp.asarray(v) for k, v in cache.items()},
                                  method=j_vlm.FastVLM.verify_step_paged)
        with torch.no_grad():
            tlogits, trows = tm.verify_step_paged(t(window), {k: t(v) for k, v in cache.items()})
        assert tuple(tlogits.shape) == (3, w, cfg.vocab_size)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL)
        assert sorted(trows) == sorted(jrows)
        for name in jrows:
            assert tuple(trows[name].shape) == tuple(jrows[name].shape)  # (L, B, W, K[, D])
            np.testing.assert_allclose(trows[name].float().numpy(), np.asarray(jrows[name], np.float32),
                                       atol=LOGIT_ATOL)


class TestSpeculativePagedServer:
    @pytest.mark.parametrize("impl", ["kernel", "gathered"])
    @pytest.mark.parametrize("k", [1, 3])
    def test_greedy_tokens_match_jax_and_the_plain_server(self, pair, k, impl):
        server = SpeculativePagedGenerationServer(pair["tt"], pair["td"], k=k, decode_impl=impl, **SERVER_KW)
        assert server.pool.quantized == (pair["kvq"] == "int8")
        reset_launch_counts()
        got = _drive(server)
        assert launch_counts() == {name: 0 for name in launch_counts()}  # CPU: plain versions only
        np.testing.assert_array_equal(got, pair["ref"][k])
        np.testing.assert_array_equal(got, pair["plain"])
        # every page is back on the free list
        assert server.pool.free_pages == server.pool.num_pages - 1
        assert not server.pool.page_table.any()
        assert server.spec_tokens_emitted == len(REQS) * (NEW - 1)

    def test_self_draft_needs_fewer_ticks(self, pair):
        other = SpeculativePagedGenerationServer(pair["tt"], pair["td"], k=3, **SERVER_KW)
        self_ = SpeculativePagedGenerationServer(pair["tt"], pair["tt"], k=3, **SERVER_KW)
        np.testing.assert_array_equal(_drive(self_), pair["plain"])
        np.testing.assert_array_equal(_drive(other), pair["plain"])
        assert self_.spec_ticks < other.spec_ticks
        assert self_.tokens_per_tick > other.tokens_per_tick
        # every self-draft proposal is accepted: k + 1 tokens a slot and round
        # but where a request runs out of budget first
        assert self_.tokens_per_slot_round > 2.0 > other.tokens_per_slot_round >= 1.0

    def test_verify_logits_agree_between_impls(self, pair):
        server = SpeculativePagedGenerationServer(pair["tt"], pair["td"], k=3, prefill_batch=2,
                                                  **dict(SERVER_KW, num_slots=3))
        for req in REQS[:2]:
            server.submit(*req)
        server.step()
        before = {name: v.clone() for name, v in server.pool.pools().items()}
        draft_before = {name: v.clone() for name, v in server.draft_cache.items() if name in ("mask", "index")}
        kernel, gathered = server.verify_logits("kernel"), server.verify_logits("gathered")
        assert tuple(kernel.shape) == (4, 4, pair["tt"].cfg.text.vocab_size)
        np.testing.assert_allclose(kernel.numpy(), gathered.numpy(), atol=1e-5)
        for name, v in server.pool.pools().items():  # neither wrote the pools
            assert torch.equal(v, before[name])
        for name, v in draft_before.items():  # nor moved the draft's cursors
            assert torch.equal(server.draft_cache[name], v)
        # the state is unchanged: the rest of the run gives the plain tokens
        outputs = server.run_to_completion()
        np.testing.assert_array_equal(np.array([outputs[0], outputs[1]]), pair["plain"][:2])

    def test_rejected_rows_are_rolled_back(self, pair):
        """After each round only count positions per slot become valid: the
        host mask marks exactly the cursor's prefix (less the prompt pads)."""
        server = SpeculativePagedGenerationServer(pair["tt"], pair["td"], k=3, **SERVER_KW)
        server.submit(*REQS[0])
        n_img = pair["tt"].cfg.num_image_tokens
        pads = PROMPT - int(REQS[0][1].sum())
        while server.num_active:
            server.step()
            slot = server._slots[0]
            if slot.active:
                assert server._slot_mask[0].sum() == slot.length - pads
                assert not server._slot_mask[0, slot.length:].any()
                assert slot.length == n_img + PROMPT + len(slot.tokens) - 1


class TestRefusals:
    def test_vocab_k_step_n_and_device(self):
        target = t_vlm.FastVLM(t_vlm.fastvlm_tiny())
        small = t_vlm.FastVLM(t_vlm.fastvlm_tiny().replace(text=t_qwen.qwen2_tiny().replace(vocab_size=256)))
        with pytest.raises(ValueError, match="vocab mismatch"):
            SpeculativePagedGenerationServer(target, small, **SERVER_KW)
        with pytest.raises(ValueError, match="k must be"):
            SpeculativePagedGenerationServer(target, target, k=0, **SERVER_KW)
        with torch.device("meta"):
            draft = t_vlm.FastVLM(t_vlm.fastvlm_tiny())
        with pytest.raises(ValueError, match="one device"):
            SpeculativePagedGenerationServer(target, draft, **SERVER_KW)
        server = SpeculativePagedGenerationServer(target, target, k=2, **SERVER_KW)
        assert server._max_len % PAGE == 0 and server._max_len >= target.cfg.num_image_tokens + PROMPT + NEW + 3
        with pytest.raises(NotImplementedError, match="step_n"):
            server.step_n(4)

    @pytest.mark.parametrize("kw", [dict(mesh=object())])
    def test_unported_parent_options_raise(self, kw):
        target = t_vlm.FastVLM(t_vlm.fastvlm_tiny())
        with pytest.raises(ValueError, match="mesh must be"):  # meshes: tests/test_torch_sharded_serving.py
            SpeculativePagedGenerationServer(target, target, **dict(SERVER_KW, **kw))
