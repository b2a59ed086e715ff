"""The port's serving stack against the JAX package on the CPU.

Greedy tokens of ``serving.generate`` and of ``PagedGenerationServer``
(decode_impl "kernel" and "gathered", float and int8 pools) against the JAX
``generate`` and JAX ``PagedGenerationServer`` on the tiny FastVLM with the
same weights (bridged), fp32; ``warp_logits`` and greedy ``sample_tokens``
against JAX; the page pool's bookkeeping; the refusals (a mesh that is no
("data", "model") DeviceMesh; an empty adapter list, a ``lora_index``
without multi-LoRA). Prefix caching and chunked admission: ``test_torch_prefix_cache.py``,
``test_torch_chunked_prefill.py``.

Greedy tokens are compared exactly: both sides compute the same fp32 logits
up to summation order (pinned to 1e-4 in ``test_torch_paged_attention.py``)
and the argmax of these random-weight models is far from ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.models import fastvlm as j_vlm
from vla_fastvlm_tpu.models import qwen2 as j_qwen
from vla_fastvlm_tpu.serving import generate as j_generate
from vla_fastvlm_tpu.serving import sampling as j_sampling
from vla_fastvlm_tpu.serving.paged_kv import PagedGenerationServer as JServer
from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch
from vla_fastvlm_tpu_torch.models import fastvlm as t_vlm
from vla_fastvlm_tpu_torch.models import qwen2 as t_qwen
from vla_fastvlm_tpu_torch.serving import PagedGenerationServer, PagedKVPool, generate, sample_tokens, warp_logits

from _torch_parity import jax_param_shapes, random_params, t

PROMPT, NEW, PAGE = 8, 6, 4


def _requests(n=5, seed=0):
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


@pytest.fixture(scope="module", params=["none", "int8"])
def setup(request):
    """JAX model + params, the port's model with the same weights, and the
    JAX references: whole-batch generate and the JAX paged server."""
    kvq = request.param
    jm = j_vlm.FastVLM(j_vlm.fastvlm_tiny().replace(text=j_qwen.qwen2_tiny(kv_cache_quantization=kvq)))
    params = random_params(jax_param_shapes(jm, jnp.zeros((1, 3, 64, 64)), jnp.ones((1, PROMPT), jnp.int32)), seed=2)
    tm = t_vlm.FastVLM(t_vlm.fastvlm_tiny().replace(text=t_qwen.qwen2_tiny(kv_cache_quantization=kvq)))
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    tm.eval().requires_grad_(False)
    ids, mask, imgs = (np.concatenate([r[i] for r in REQS]) for i in range(3))
    ref_generate = np.asarray(j_generate(jm, params, jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(mask),
                                         max_new_tokens=NEW, eos_token_id=-1))
    jserver = JServer(jm, params, num_slots=2, prompt_len=PROMPT, max_new_tokens=NEW, eos_token_id=-1,
                      page_size=PAGE, decode_impl="kernel")
    return dict(kvq=kvq, jm=jm, params=params, tm=tm, ref_generate=ref_generate, ref_server=_drive(jserver),
                batch=(imgs, ids, mask))


class TestGenerate:
    def test_greedy_tokens_match_jax(self, setup):
        imgs, ids, mask = setup["batch"]
        out = generate(setup["tm"], imgs, ids, mask, max_new_tokens=NEW, eos_token_id=-1)
        assert out.dtype == torch.int32 and tuple(out.shape) == (5, NEW)
        np.testing.assert_array_equal(out.numpy(), setup["ref_generate"])

    def test_eos_pads_after_finish(self, setup):
        imgs, ids, mask = setup["batch"]
        eos = int(setup["ref_generate"][0, 1])  # row 0 emits it second
        out = generate(setup["tm"], imgs, ids, mask, max_new_tokens=NEW, eos_token_id=eos).numpy()
        ref = np.asarray(j_generate(setup["jm"], setup["params"], jnp.asarray(imgs), jnp.asarray(ids),
                                    jnp.asarray(mask), max_new_tokens=NEW, eos_token_id=eos))
        np.testing.assert_array_equal(out, ref)
        assert (out[0, 1:] == eos).all()


class TestPagedServer:
    @pytest.mark.parametrize("impl", ["kernel", "gathered"])
    def test_greedy_tokens_match_jax_server_and_generate(self, setup, impl):
        server = PagedGenerationServer(setup["tm"], num_slots=2, prompt_len=PROMPT, max_new_tokens=NEW,
                                       eos_token_id=-1, page_size=PAGE, decode_impl=impl)
        assert server.pool.quantized == (setup["kvq"] == "int8")
        got = _drive(server)
        np.testing.assert_array_equal(got, setup["ref_server"])
        np.testing.assert_array_equal(got, setup["ref_generate"])
        # every page is back on the free list
        assert server.pool.free_pages == server.pool.num_pages - 1
        assert not server.pool.page_table.any()

    def test_tick_logits_agree_between_impls(self, setup):
        server = PagedGenerationServer(setup["tm"], num_slots=3, prompt_len=PROMPT, max_new_tokens=NEW,
                                       eos_token_id=-1, page_size=PAGE, prefill_batch=2)
        for req in REQS[:2]:
            server.submit(*req)
        server.step()
        before = {k: v.clone() for k, v in server.pool.pools().items()}
        kernel, gathered = server.tick_logits("kernel"), server.tick_logits("gathered")
        np.testing.assert_allclose(kernel.numpy(), gathered.numpy(), atol=1e-5)
        for k, v in server.pool.pools().items():  # neither wrote the pools
            assert torch.equal(v, before[k])

    def test_step_n_matches_step(self, setup):
        make = lambda: PagedGenerationServer(setup["tm"], num_slots=2, prompt_len=PROMPT, max_new_tokens=NEW,
                                             eos_token_id=-1, page_size=PAGE)
        a, b = make(), make()
        for s in (a, b):
            for req in REQS[:2]:
                s.submit(*req)
        out_a = a.step_n(NEW)
        out_a.update(a.run_to_completion())
        out_b = b.run_to_completion()
        assert out_a == out_b and len(out_a) == 2


class TestPool:
    def test_allocate_free_roundtrip(self):
        pool = PagedKVPool(t_qwen.qwen2_tiny(), num_pages=9, page_size=4, num_slots=2, max_len=16)
        assert pool.free_pages == 8 and tuple(pool.pool_k.shape) == (2, 9, 2, 4, 16)
        pool.allocate(0, 9)  # 3 pages
        assert pool.free_pages == 5 and np.count_nonzero(pool.page_table[0]) == 3
        pool.allocate(0, 10)  # still 3
        assert pool.free_pages == 5
        pool.allocate(0, 13)  # grows to 4
        assert pool.free_pages == 4
        assert 0 not in pool.page_table[0]  # the trash page is never handed out
        pool.free(0)
        assert pool.free_pages == 8 and not pool.page_table.any()

    def test_exhaustion_and_reservations(self):
        pool = PagedKVPool(t_qwen.qwen2_tiny(), num_pages=5, page_size=4, num_slots=3, max_len=16)
        pool.reserve(0, 12)  # 3 of the 4 free pages
        assert pool.can_reserve(4) and not pool.can_reserve(5)
        with pytest.raises(RuntimeError, match="cannot admit"):
            pool.reserve(1, 8)
        with pytest.raises(ValueError, match="pages_per_slot"):
            pool.reserve(2, 20)
        pool.allocate(1, 16)  # unreserved allocation takes the last free pages
        with pytest.raises(RuntimeError, match="exhausted"):
            pool.allocate(2, 4)

    def test_refcounts(self):
        pool = PagedKVPool(t_qwen.qwen2_tiny(), num_pages=4, page_size=4, num_slots=2, max_len=8)
        pool.allocate(0, 4)
        page = int(pool.page_table[0, 0])
        pool.install(1, 0, page)
        pool.free(0)
        assert pool.free_pages == 2  # still held by slot 1
        pool.free(1)
        assert pool.free_pages == 3
        with pytest.raises(ValueError, match="unallocated"):
            pool.add_ref(page)

    def test_int8_pool_layout(self):
        pool = PagedKVPool(t_qwen.qwen2_tiny(kv_cache_quantization="int8"), num_pages=3, page_size=4, num_slots=1,
                           max_len=8)
        assert pool.pool_k.dtype == torch.int8 and tuple(pool.pool_k_scale.shape) == (2, 3, 2, 4)
        assert sorted(pool.pools()) == ["k", "k_scale", "v", "v_scale"]

    def test_max_len_page_multiple(self):
        with pytest.raises(ValueError, match="multiple"):
            PagedKVPool(t_qwen.qwen2_tiny(), num_pages=4, page_size=5, num_slots=1, max_len=16)


class TestServerOptions:
    @pytest.mark.parametrize("kw,error", [pytest.param(dict(mesh=object()), (ValueError, "mesh must be"), id="kw0"),
                                          pytest.param(dict(lora=[]), (ValueError, "at least one adapter"), id="kw1")])
    def test_unported_options_raise(self, kw, error):
        """A mesh that is no ("data", "model") DeviceMesh is refused (meshes:
        tests/test_torch_sharded_serving.py); an empty adapter list too."""
        with pytest.raises(error[0], match=error[1]):
            PagedGenerationServer(t_vlm.FastVLM(t_vlm.fastvlm_tiny()), num_slots=1, prompt_len=4, **kw)

    def test_bad_decode_impl_and_lora_index(self):
        model = t_vlm.FastVLM(t_vlm.fastvlm_tiny())
        with pytest.raises(ValueError, match="decode_impl"):
            PagedGenerationServer(model, decode_impl="pallas")
        server = PagedGenerationServer(model, num_slots=1, prompt_len=4, max_new_tokens=2)
        assert server.decode_impl == "kernel"
        with pytest.raises(ValueError, match="LIST of adapters"):  # lora_index needs a multi-LoRA server
            server.submit(np.ones((1, 4), np.int32), np.ones((1, 4), np.int32), lora_index=0)


class TestSampling:
    @pytest.mark.parametrize("temperature,top_p", [(1.0, 1.0), (0.7, 0.9), (1.3, 0.5)])
    def test_warp_logits_matches_jax(self, temperature, top_p):
        logits = np.random.default_rng(4).standard_normal((3, 2, 50)).astype(np.float32) * 3
        ref = np.asarray(j_sampling.warp_logits(jnp.asarray(logits), temperature, top_p))
        out = warp_logits(t(logits), temperature, top_p).numpy()
        np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
        np.testing.assert_allclose(out[np.isfinite(out)], ref[np.isfinite(ref)], rtol=1e-6)

    def test_greedy_matches_jax(self):
        logits = np.random.default_rng(5).standard_normal((4, 3, 64)).astype(np.float32)
        logits[0, 0, [7, 9]] = 10.0  # a tie: both take the first maximum
        ref = np.asarray(j_sampling.sample_tokens(jnp.asarray(logits), None, 0.0))
        out = sample_tokens(t(logits), None, 0.0)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)
        assert int(out[0, 0]) == 7

    def test_temperature_draws_from_the_nucleus(self):
        logits = torch.tensor([[5.0, 4.0, -3.0, -4.0]]).repeat(200, 1)
        g = torch.Generator().manual_seed(0)
        draws = sample_tokens(logits, g, temperature=1.0, top_p=0.9)
        assert set(draws.tolist()) <= {0, 1} and (draws == 0).any() and (draws == 1).any()
        with pytest.raises(ValueError, match="Generator"):
            sample_tokens(logits, None, temperature=1.0)
