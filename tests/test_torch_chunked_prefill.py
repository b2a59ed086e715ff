"""The port's chunked prefill against the JAX package on the CPU.

- ``FastVLM.prefill_image_chunk`` / ``prefill_text_chunk`` against the
  one-shot ``prefill`` (cursor, mask, valid K/V rows and last-real-position
  logits within 1e-5), multimodal and text-only, ragged right-padded
  prompts, float and int8 dense caches; each chunk's (B, C, V) logits
  against JAX's within 1e-5 (relative and absolute).
- The chunked ``PagedGenerationServer`` (``prefill_chunk_tokens``) against
  the JAX chunked server: greedy tokens with staggered arrivals, so chunks
  interleave with decode ticks; the programs it runs; ``flush`` drains
  in-flight work; buckets that are not multiples of the chunk raise; every
  page comes back.

Tiny FastVLM (1 image token at 64 px), fp32, weights from numpy seeds
through the bridge; the token embedding is scaled by 0.1 so greedy
sequences vary (``tests/test_torch_speculative.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.models import fastvlm as j_vlm
from vla_fastvlm_tpu.models import qwen2 as j_qwen
from vla_fastvlm_tpu.serving.paged_kv import PagedGenerationServer as JServer
from vla_fastvlm_tpu_torch.models import qwen2 as t_qwen
from vla_fastvlm_tpu_torch.serving import PagedGenerationServer

from _torch_parity import t, tiny_vlm_pair

TOL = 1e-5
PROMPT, NEW, PAGE, CHUNK = 8, 5, 4, 4


def ragged(rng, b, width):
    """Right-padded prompts of 2..width real tokens."""
    ids = np.zeros((b, width), np.int32)
    mask = np.zeros((b, width), np.int32)
    for i in range(b):
        length = int(rng.integers(2, width + 1))
        ids[i, :length] = rng.integers(3, 500, length)
        mask[i, :length] = 1
    return ids, mask


def requests(n, seed, width=PROMPT):
    rng = np.random.default_rng(seed)
    ids, mask = ragged(rng, n, width)
    return [(ids[i: i + 1], mask[i: i + 1], rng.random((1, 3, 64, 64), dtype=np.float32)) for i in range(n)]


def running_last(logits, mask, last):
    """The server's running last-real-position logits after one chunk."""
    has = mask.astype(bool).any(axis=1)
    idx = mask.shape[1] - 1 - np.argmax(mask[:, ::-1], axis=1)
    return np.where(has[:, None], logits[np.arange(len(idx)), idx], last)


@pytest.fixture(scope="module", params=["prefix", "none"])
def chunks(request):
    """One ragged batch prefilled one-shot and in chunks by the port, and
    chunk by chunk by JAX."""
    mode = request.param
    jm, params, tm = tiny_vlm_pair(3, mode=mode)
    rng = np.random.default_rng(4)
    b, width = 3, 12
    ids, mask = ragged(rng, b, width)
    images = rng.random((b, 3, 64, 64), dtype=np.float32) if mode == "prefix" else None
    max_len = tm.cfg.num_image_tokens + width + 4
    with torch.no_grad():
        cache = t_qwen.init_kv_cache(tm.cfg.text, b, max_len)
        ref_last, _, ref_cache, _, _ = tm.prefill(None if images is None else t(images), t(ids), t(mask), cache)
        cache = t_qwen.init_kv_cache(tm.cfg.text, b, max_len)
        if images is not None:
            cache = tm.prefill_image_chunk(t(images), cache)
        last, logits = np.zeros((b, tm.cfg.text.vocab_size), np.float32), []
        for lo in range(0, width, CHUNK):
            out, cache = tm.prefill_text_chunk(t(ids[:, lo: lo + CHUNK]), t(mask[:, lo: lo + CHUNK]), cache)
            logits.append(out.numpy())
            last = running_last(logits[-1], mask[:, lo: lo + CHUNK], last)
    jcache = j_qwen.init_kv_cache(jm.cfg.text, b, max_len)
    if images is not None:
        jcache = jm.apply({"params": params}, jnp.asarray(images), jcache, method=j_vlm.FastVLM.prefill_image_chunk)
    jlogits = []
    for lo in range(0, width, CHUNK):
        out, jcache = jm.apply({"params": params}, jnp.asarray(ids[:, lo: lo + CHUNK]),
                               jnp.asarray(mask[:, lo: lo + CHUNK]), jcache, method=j_vlm.FastVLM.prefill_text_chunk)
        jlogits.append(np.asarray(out))
    return dict(ref_last=ref_last.numpy(), ref_cache=ref_cache, last=last, cache=cache, logits=logits,
                jlogits=jlogits, width=width)


class TestModelChunks:
    def test_chunks_match_one_shot_prefill(self, chunks):
        ref, got = chunks["ref_cache"], chunks["cache"]
        np.testing.assert_array_equal(got["index"].numpy(), ref["index"].numpy())
        np.testing.assert_array_equal(got["mask"].numpy(), ref["mask"].numpy())
        # K/V rows compared where valid: pad slots hold rows on both paths,
        # at other RoPE positions, and the mask keeps attention off them.
        valid = ref["mask"].numpy()
        for name in ("k", "v"):
            sel = np.broadcast_to(valid[None, :, :, None, None], tuple(ref[name].shape))
            np.testing.assert_allclose(got[name].numpy()[sel], ref[name].numpy()[sel], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(chunks["last"], chunks["ref_last"], rtol=TOL, atol=TOL)

    def test_chunk_logits_match_jax(self, chunks):
        assert len(chunks["logits"]) == chunks["width"] // CHUNK
        for got, ref in zip(chunks["logits"], chunks["jlogits"]):
            assert got.shape == ref.shape == (3, CHUNK, 512)
            np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)

    def test_int8_cache_chunks_quantize_at_write(self):
        """Text chunks on the int8 dense cache quantize at write: the same
        scales as the one-shot prefill where valid, codes at most one step
        apart (fp32 rounding in another order), last logits within 1e-4."""
        _, _, tm = tiny_vlm_pair(5, kvq="int8")
        rng = np.random.default_rng(6)
        ids, mask = ragged(rng, 2, 8)
        images = t(rng.random((2, 3, 64, 64), dtype=np.float32))
        with torch.no_grad():
            ref_last, _, ref, _, _ = tm.prefill(images, t(ids), t(mask), t_qwen.init_kv_cache(tm.cfg.text, 2, 12))
            cache = tm.prefill_image_chunk(images, t_qwen.init_kv_cache(tm.cfg.text, 2, 12))
            last = np.zeros((2, 512), np.float32)
            for lo in (0, 4):
                out, cache = tm.prefill_text_chunk(t(ids[:, lo: lo + 4]), t(mask[:, lo: lo + 4]), cache)
                last = running_last(out.numpy(), mask[:, lo: lo + 4], last)
        valid = ref["mask"].numpy()
        assert cache["k"].dtype == torch.int8
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(cache[name].numpy()[:, valid], ref[name].numpy()[:, valid], rtol=TOL)
        for name in ("k", "v"):  # int8 codes: at most one step off where fp32 rounding differs
            diff = cache[name].numpy()[:, valid].astype(int) - ref[name].numpy()[:, valid].astype(int)
            assert np.abs(diff).max() <= 1
        np.testing.assert_allclose(last, ref_last.numpy(), rtol=1e-4, atol=1e-4)


SERVER_KW = dict(num_slots=4, prompt_len=PROMPT, max_new_tokens=NEW, eos_token_id=-1, page_size=PAGE,
                 prefill_batch=2)
REQS = requests(6, seed=7)


def staggered(server, reqs=REQS):
    """Two requests up front, the rest one a tick as slots free up: chunks
    interleave with decode ticks. Tokens by request order."""
    queue = list(reqs)
    rids = [server.submit(*queue.pop(0)) for _ in range(2)]
    outputs = {}
    while queue or server.num_active:
        if queue and server.has_free_slot():
            rids.append(server.submit(*queue.pop(0)))
        outputs.update(server.step())
    return np.array([outputs[r] for r in rids])


@pytest.fixture(scope="module")
def served():
    jm, params, tm = tiny_vlm_pair(8)
    ref = staggered(JServer(jm, params, prefill_chunk_tokens=CHUNK, **SERVER_KW))
    return dict(tm=tm, ref=ref)


class TestChunkedServer:
    @pytest.mark.parametrize("impl", ["kernel", "gathered"])
    def test_greedy_tokens_match_jax_chunked_server(self, served, impl):
        server = PagedGenerationServer(served["tm"], prefill_chunk_tokens=CHUNK, decode_impl=impl, **SERVER_KW)
        got = staggered(server)
        np.testing.assert_array_equal(got, served["ref"])
        np.testing.assert_array_equal(got, staggered(PagedGenerationServer(served["tm"], **SERVER_KW)))
        # one image chunk and PROMPT / CHUNK text chunks an admission batch; no whole prefill
        assert server.admissions == 0 and server.image_chunks >= 3
        assert server.text_chunks == server.image_chunks * PROMPT // CHUNK

    def test_step_runs_one_chunk_of_admission(self, served):
        server = PagedGenerationServer(served["tm"], prefill_chunk_tokens=CHUNK, **SERVER_KW)
        server.submit(*REQS[0])
        for image_chunks, text_chunks in ((1, 0), (1, 1), (1, 2)):
            server.step()
            ticks = int(text_chunks == PROMPT // CHUNK)  # the slot decodes once its last chunk lands
            assert (server.image_chunks, server.text_chunks, server.ticks) == (image_chunks, text_chunks, ticks)
        assert server._inflight is None and server.num_active == 1

    def test_flush_drains_inflight(self, served):
        server = PagedGenerationServer(served["tm"], prefill_chunk_tokens=CHUNK, **SERVER_KW)
        server.submit(*REQS[0])
        server.step()  # the image chunk only
        assert server._inflight is not None and server.num_active == 1
        server.submit(*REQS[1])
        server.flush()
        assert server._inflight is None and not server._pending
        assert sum(s.active for s in server._slots) == 2

    def test_text_only_server(self):
        jm, params, tm = tiny_vlm_pair(9, mode="none")
        reqs = [(ids, mask, None) for ids, mask, _ in requests(4, seed=10)]
        ref = JServer(jm, params, prefill_chunk_tokens=2, **SERVER_KW)
        got = PagedGenerationServer(tm, prefill_chunk_tokens=2, **SERVER_KW)
        for server in (ref, got):
            for req in reqs:
                server.submit(*req)
        assert got.run_to_completion() == ref.run_to_completion()
        assert got.image_chunks == 0 and got.text_chunks == 2 * PROMPT // 2

    def test_bucket_divisibility_validated(self, served):
        with pytest.raises(ValueError, match="multiples"):
            PagedGenerationServer(served["tm"], num_slots=2, prompt_len=(4, 10), max_new_tokens=2, page_size=2,
                                  prefill_chunk_tokens=4)

    def test_pool_accounting_balances(self, served):
        server = PagedGenerationServer(served["tm"], prefill_chunk_tokens=CHUNK, **SERVER_KW)
        free0 = server.pool.free_pages
        staggered(server)
        assert server.pool.free_pages == free0 == server.pool.num_pages - 1
        assert server.pool._refcount[1:].sum() == 0 and not server.pool.page_table.any()
