"""The port's prefix caching on the paged servers against the JAX package, on the CPU.

- A mixed stream (a shared frame and instruction template with different
  tails, an exact repeat, a distinct request, the template under another
  frame, a share that ends inside a page) through the cached
  ``PagedGenerationServer`` against the JAX cached server: greedy tokens and
  whole-prompt hits, partial hits and misses equal, float and int8 pools;
  the tokens also equal the port's server with no cache.
- Whole-prompt hits: token-exact against no cache, no prefill run, the
  shared pages' bytes (and int8 scales) unchanged after the hit decodes
  into its private tail copy, concurrent hits sharing pages.
- Page-level partial hits: another frame gives no reuse, a share that ends
  inside a page matches fewer pages, a short bucket reuses a long one's
  pages, a short prompt inside a longer cached one keeps its last real
  token in the tail; eviction returns every page and a mixed stream leaks none.
- Chunked admission with the cache, and the speculative paged server with
  the cache and with chunking, against the JAX speculative paged server.

Tiny FastVLM (1 image token at 64 px: page 0 holds the image and text 0..2),
fp32, weights from numpy seeds through the bridge.
"""

import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.serving.paged_kv import PagedGenerationServer as JServer
from vla_fastvlm_tpu.serving.speculative_paged import SpeculativePagedGenerationServer as JSpecPaged
from vla_fastvlm_tpu_torch.serving import PagedGenerationServer, SpeculativePagedGenerationServer

from _torch_parity import tiny_vlm_pair

PAGE, PROMPT, NEW = 4, 12, 5
KW = dict(num_slots=3, prompt_len=PROMPT, max_new_tokens=NEW, eos_token_id=-1, prefill_batch=2, page_size=PAGE)


def req(rng, length=PROMPT, prefix=None, image=None, width=PROMPT):
    """A request of ``length`` real tokens; ``prefix`` overrides the leading ones."""
    ids = np.zeros((1, width), np.int32)
    mask = np.zeros((1, width), np.int32)
    ids[0, :length] = rng.integers(3, 500, length)
    mask[0, :length] = 1
    if prefix is not None:
        ids[0, : len(prefix)] = prefix
    if image is None:
        image = rng.random((1, 3, 64, 64), dtype=np.float32)
    return ids, mask, image


def drain(server, reqs, max_ticks=300):
    """One arrival a tick while slots allow (a request can then hit what
    the ones before it registered); tokens by request order."""
    queue, rids, outputs = list(reqs), [], {}
    for _ in range(max_ticks):
        if queue and server.has_free_slot():
            rids.append(server.submit(*queue.pop(0)))
        outputs.update(server.step())
        if not queue and not server.num_active:
            break
    assert len(outputs) == len(reqs), "server did not drain"
    return np.array([outputs[r] for r in rids])


def counts(server):
    return server.prefix_cache_hits, server.prefix_cache_partial_hits, server.prefix_cache_misses


def template_stream(seed):
    """A, B: one frame and a 7-token template (pages 0 and 1), different
    tails; C distinct; A again; D: the template under another frame; E: a
    5-token share of the template (ends inside page 1); B again."""
    rng = np.random.default_rng(seed)
    template = rng.integers(3, 500, 7).astype(np.int32)
    frame = rng.random((1, 3, 64, 64), dtype=np.float32)
    a, b = req(rng, prefix=template, image=frame), req(rng, prefix=template, image=frame)
    c = req(rng)
    d = req(rng, prefix=template)
    e = req(rng, prefix=template[:5], image=frame)
    return [a, b, c, a, d, e, b]


def pinned_balance(server):
    """Free pages plus the pages the cache layers pin make the whole pool."""
    return server.pool.free_pages + len(server.pinned_pages()) == server.pool.num_pages - 1


@pytest.fixture(scope="module")
def tiny():
    return tiny_vlm_pair(0)


@pytest.fixture(scope="module", params=["none", "int8"])
def mixed(request):
    jm, params, tm = tiny_vlm_pair(1, kvq=request.param)
    reqs = template_stream(2)
    jserver = JServer(jm, params, prefix_cache_size=4, **KW)
    return dict(tm=tm, reqs=reqs, ref=drain(jserver, reqs), ref_counts=counts(jserver))


class TestMixedStream:
    @pytest.mark.parametrize("impl", ["kernel", "gathered"])
    def test_tokens_and_counts_match_jax(self, mixed, impl):
        server = PagedGenerationServer(mixed["tm"], prefix_cache_size=4, decode_impl=impl, **KW)
        got = drain(server, mixed["reqs"])
        np.testing.assert_array_equal(got, mixed["ref"])
        assert counts(server) == mixed["ref_counts"]
        # A's repeat hits whole; B, E and B's repeat (its whole entry evicted
        # by E's under the LRU of 4, its pages still held) hit partly; A, C
        # and D miss
        assert counts(server) == (1, 3, 3)
        np.testing.assert_array_equal(got, drain(PagedGenerationServer(mixed["tm"], **KW), mixed["reqs"]))
        assert pinned_balance(server) and not server.pool.page_table.any()
        assert server.pool.quantized == (mixed["tm"].cfg.text.kv_cache_quantization == "int8")

    def test_eviction_leaves_no_page_behind(self, mixed):
        server = PagedGenerationServer(mixed["tm"], prefix_cache_size=1, **KW)
        np.testing.assert_array_equal(drain(server, mixed["reqs"]), mixed["ref"])
        assert len(server._prefix_cache) == 1 and len(server._page_cache) <= server._page_cache_capacity
        assert pinned_balance(server)
        server.evict_prefix_cache()
        assert server.pool.free_pages == server.pool.num_pages - 1 and not server.pinned_pages()


class TestWholePromptHits:
    @pytest.mark.parametrize("prompt", [7, 8])  # prefill 8 ends on a page; 9 needs the tail page copied
    def test_hits_token_exact_without_prefill(self, tiny, prompt):
        rng = np.random.default_rng(3)
        base = [req(rng, width=prompt, length=prompt - 1) for _ in range(2)]
        reqs = [base[0], base[1], base[0], base[0]]
        kw = dict(KW, num_slots=2, prompt_len=prompt)
        ref = drain(PagedGenerationServer(tiny[2], **kw), reqs)
        server = PagedGenerationServer(tiny[2], prefix_cache_size=4, **kw)
        np.testing.assert_array_equal(drain(server, reqs), ref)
        assert counts(server) == (2, 0, 2)
        assert server.admissions == 2  # the hits ran no prefill

    @pytest.mark.parametrize("kvq", ["none", "int8"])
    def test_shared_pages_unchanged_after_hit_decodes(self, kvq):
        """Copy-on-write: the hit decodes into its private copy of the tail
        page; the entry's pages keep their bytes in every pool buffer."""
        _, _, tm = tiny_vlm_pair(4, kvq=kvq)
        a = req(np.random.default_rng(5), length=9)  # prefill 13: pages 0..2 full, tail page 3
        server = PagedGenerationServer(tm, prefix_cache_size=2, **KW)
        first = drain(server, [a])
        entry = next(iter(server._prefix_cache.values()))
        pages = torch.tensor(entry["pages"])
        assert len(entry["pages"]) == 4
        before = {name: buf[:, pages].clone() for name, buf in server.pool.pools().items()}
        logits = entry["logits"].clone()
        server.submit(*a)
        server.step()  # admitted from the cache, one decode tick
        hit_pages = server.pool.page_table[0, :4].tolist()
        assert hit_pages[:3] == entry["pages"][:3] and hit_pages[3] != entry["pages"][3]
        out = server.run_to_completion()
        np.testing.assert_array_equal(np.array(list(out.values())), first)
        for name, buf in server.pool.pools().items():
            assert torch.equal(buf[:, pages], before[name]), name
        assert torch.equal(entry["logits"], logits) and counts(server) == (1, 0, 1)

    def test_concurrent_hits_share_pages(self, tiny):
        a = req(np.random.default_rng(6), length=11, width=11)  # prefill 12: three full pages
        kw = dict(KW, num_slots=2, prompt_len=11, prefill_batch=1)
        used = {}
        for size in (0, 2):
            server = PagedGenerationServer(tiny[2], prefix_cache_size=size, **kw)
            server.submit(*a)
            server.submit(*a)
            server.flush()
            used[size] = server.pool.num_pages - 1 - server.pool.free_pages
            server.run_to_completion()
            assert pinned_balance(server)
        assert used[2] < used[0]


class TestPartialHits:
    def _pair(self, tiny, share, second_image=None, **kw):
        rng = np.random.default_rng(7)
        template = rng.integers(3, 500, share).astype(np.int32)
        frame = rng.random((1, 3, 64, 64), dtype=np.float32)
        a = req(rng, prefix=template, image=frame)
        b = req(rng, prefix=template, image=frame if second_image is None else second_image)
        server = PagedGenerationServer(tiny[2], prefix_cache_size=4, **dict(KW, **kw))
        ref = drain(PagedGenerationServer(tiny[2], **dict(KW, **kw)), [a, b])
        return server, [a, b], ref

    def test_shared_template_prefills_the_tail_alone(self, tiny):
        server, reqs, ref = self._pair(tiny, share=7)
        server.submit(*reqs[0])
        server.step()
        rid = server.submit(*reqs[1])
        assert server._longest_page_prefix(server._pending[0]) == 2
        server.step()
        assert counts(server) == (0, 1, 1) and server.admissions == 1
        assert server.text_chunks == 2  # the tail, text 7..11: page 2 and the first position of page 3
        assert server.pool.page_table[1, :2].tolist() == server.pool.page_table[0, :2].tolist()
        out = server.run_to_completion()
        np.testing.assert_array_equal(out[rid], ref[1])

    def test_tails_sharing_a_match_prefill_together(self, tiny):
        """Three partial hits pending at once, one match length: their tails
        run as programs of up to ``prefill_batch`` rows (2 and 1 here, two
        text chunks each); tokens and counts equal the JAX server's, which
        admits them one at a time."""
        jm, params, tm = tiny
        rng = np.random.default_rng(17)
        template = rng.integers(3, 500, 7).astype(np.int32)
        frame = rng.random((1, 3, 64, 64), dtype=np.float32)
        reqs = [req(rng, prefix=template, image=frame) for _ in range(4)]
        out = {}
        for name, server in (("jax", JServer(jm, params, prefix_cache_size=4, **KW)),
                             ("port", PagedGenerationServer(tm, prefix_cache_size=4, **KW))):
            first = server.submit(*reqs[0])
            done = server.run_to_completion()
            rids = [first] + [server.submit(*r) for r in reqs[1:]]
            done.update(server.run_to_completion())
            out[name] = (np.array([done[r] for r in rids]), counts(server))
        np.testing.assert_array_equal(out["port"][0], out["jax"][0])
        assert out["port"][1] == out["jax"][1] == (0, 3, 1)
        assert server.text_chunks == 4 and server.admissions == 1
        assert pinned_balance(server) and not server.pool.page_table.any()

    def test_different_image_no_reuse(self, tiny):
        other = np.random.default_rng(8).random((1, 3, 64, 64), dtype=np.float32)
        server, reqs, ref = self._pair(tiny, share=7, second_image=other)
        np.testing.assert_array_equal(drain(server, reqs), ref)
        assert counts(server) == (0, 0, 2)

    def test_unaligned_share_matches_fewer_pages(self, tiny):
        server, reqs, ref = self._pair(tiny, share=5)
        server.submit(*reqs[0])
        server.run_to_completion()
        server.submit(*reqs[1])
        assert server._longest_page_prefix(server._pending[0]) == 1
        server.run_to_completion()
        assert counts(server) == (0, 1, 1)
        np.testing.assert_array_equal(drain(server, reqs), ref)

    def test_cross_bucket_sharing(self, tiny):
        rng = np.random.default_rng(9)
        template = rng.integers(3, 500, 7).astype(np.int32)
        frame = rng.random((1, 3, 64, 64), dtype=np.float32)
        long = req(rng, prefix=template, image=frame)
        short = (np.concatenate([template, [int(rng.integers(3, 500))]]).astype(np.int32)[None],
                 np.ones((1, 8), np.int32), frame)
        kw = dict(KW, prompt_len=(8, PROMPT))
        server = PagedGenerationServer(tiny[2], prefix_cache_size=4, **kw)
        np.testing.assert_array_equal(drain(server, [long, short]),
                                      drain(PagedGenerationServer(tiny[2], **kw), [long, short]))
        assert counts(server) == (0, 1, 1)

    @pytest.mark.parametrize("long_len, short_len, expect", [(7, 3, (0, 0, 2)), (11, 7, (0, 1, 1))])
    def test_short_prompt_inside_a_cached_one(self, tiny, long_len, short_len, expect):
        """A prompt whose real tokens end on a page boundary, inside a longer
        cached prompt on its frame: the match stops before the page of its
        last real token, so its tail is never padding alone (which would
        leave its first token no logits to come from). The JAX server caps
        the match by the padded bucket only, so no JAX run is compared."""
        rng = np.random.default_rng(16)
        frame = rng.random((1, 3, 64, 64), dtype=np.float32)
        long = req(rng, length=long_len, image=frame)
        short = req(rng, length=short_len, prefix=long[0][0, :short_len], image=frame)
        server = PagedGenerationServer(tiny[2], prefix_cache_size=4, **KW)
        np.testing.assert_array_equal(drain(server, [long, short]),
                                      drain(PagedGenerationServer(tiny[2], **KW), [long, short]))
        assert counts(server) == expect

    def test_image_spanning_pages(self, tiny):
        """16 image tokens over 4 pages of 4 (the 1024-px case: 256 image
        tokens, 16 pages of 16): each image page has its own chain hash, so
        a partial hit installs every image page in its place and its tokens
        equal the server's with no cache. The JAX server's chain gives its
        image-only pages one hash (``serving/paged_kv.py::_prompt_hashes``),
        so no JAX run is compared here."""
        from vla_fastvlm_tpu_torch.models import fastvlm as t_vlm

        model = t_vlm.FastVLM(t_vlm.fastvlm_tiny(image_size=256)).eval().requires_grad_(False)
        model.load_state_dict(tiny[2].state_dict())
        assert model.cfg.num_image_tokens == 16
        rng = np.random.default_rng(15)
        template = rng.integers(3, 500, 8).astype(np.int32)
        frame = rng.random((1, 3, 256, 256), dtype=np.float32)
        reqs = [req(rng, prefix=template, image=frame) for _ in range(3)]
        server = PagedGenerationServer(model, prefix_cache_size=4, **KW)
        hashes = server._prompt_hashes(*reqs[0])[1]
        assert len(hashes) == 7 and len(set(hashes)) == 7  # 4 image pages, 3 text pages
        np.testing.assert_array_equal(drain(server, reqs), drain(PagedGenerationServer(model, **KW), reqs))
        assert counts(server) == (0, 2, 1)

    def test_text_only(self):
        _, _, tm = tiny_vlm_pair(10, mode="none")
        rng = np.random.default_rng(11)
        template = rng.integers(3, 500, 8).astype(np.int32)
        reqs = []
        for _ in range(2):
            ids = rng.integers(3, 500, (1, PROMPT)).astype(np.int32)
            ids[0, :8] = template
            reqs.append((ids, np.ones((1, PROMPT), np.int32), None))
        server = PagedGenerationServer(tm, prefix_cache_size=4, **KW)
        np.testing.assert_array_equal(drain(server, reqs), drain(PagedGenerationServer(tm, **KW), reqs))
        assert counts(server) == (0, 1, 1)


class TestComposition:
    def test_chunked_admission_with_the_cache(self, tiny):
        """Hits admit at once while a miss batch is mid-chunk."""
        rng = np.random.default_rng(12)
        base = [req(rng, length=6, width=8), req(rng, length=8, width=8)]
        kw = dict(KW, num_slots=4, prompt_len=8)
        ref = PagedGenerationServer(tiny[2], **kw)
        for r in base + base:
            ref.submit(*r)
        expected = ref.run_to_completion()
        server = PagedGenerationServer(tiny[2], prefill_chunk_tokens=4, prefix_cache_size=4, **kw)
        for r in base:
            server.submit(*r)
        server.step()  # the image chunk of the miss batch
        for r in base:
            server.submit(*r)
        assert server.run_to_completion() == expected
        assert counts(server) == (2, 0, 2) and server.image_chunks == 1

    @pytest.mark.parametrize("extra", [dict(prefix_cache_size=4), dict(prefill_chunk_tokens=4),
                                       dict(prefix_cache_size=4, prefill_chunk_tokens=4)])
    def test_speculative_paged_matches_jax(self, tiny, extra):
        """The draft prefills after every kind of target admission (whole at
        a chunked batch's finalize); tokens equal JAX's speculative paged
        server and the plain paged server on the target."""
        jm, params, tm = tiny
        jd, dparams, td = tiny_vlm_pair(13)
        reqs = template_stream(14)
        jserver = JSpecPaged(jm, params, jd, dparams, k=2, **KW, **extra)
        ref = drain(jserver, reqs)
        server = SpeculativePagedGenerationServer(tm, td, k=2, **KW, **extra)
        got = drain(server, reqs)
        np.testing.assert_array_equal(got, ref)
        assert counts(server) == counts(jserver)
        np.testing.assert_array_equal(got, drain(PagedGenerationServer(tm, **KW), reqs))
        towers = server.admissions + server.image_chunks
        if extra.get("prefix_cache_size"):
            hits, partial, misses = counts(server)
            assert hits >= 1 and partial >= 2 and server.draft_admissions == hits + partial + towers
        else:
            assert server.draft_admissions == towers
        assert pinned_balance(server) and not server.pool.page_table.any()
