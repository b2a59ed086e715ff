"""The port's speculative decoding on dense caches against the JAX package, on the CPU.

- ``FastVLM.verify_step``: (B, W) window logits and the cache it writes,
  against JAX's, to 1e-4 (float and int8 caches).
- Greedy tokens of ``SpeculativeGenerator`` (k 1 and 3, a separate draft and
  the target as its own draft), the dense ``GenerationServer`` and
  ``SpeculativeGenerationServer`` against the JAX objects on the same
  bridged weights, exactly, and against the port's ``generate``; slot reuse
  under oversubscription (5 requests, 2 slots); the self-draft server needs
  fewer ticks.
- Refusals: vocab mismatch, ``k < 1``, ``step_n``, a draft on another device,
  the options not ported yet.
- ``speculative_accept`` / ``_accept``: the greedy rule exactly as JAX's; the
  sampled rule holds the emitted tokens to the target distribution (total
  variation under 0.02 over 60,000 draws), as the JAX package's test does.

Models: the tiny FastVLM in fp32, target and draft with different random
weights from seeds and a scaled-down token embedding (see ``_pair``); both
sides compute the same fp32 logits up to summation order, and the argmax of
these models is far from ties.
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
from vla_fastvlm_tpu.serving import speculative as j_spec
from vla_fastvlm_tpu.serving.continuous_batching import GenerationServer as JGenerationServer
from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch
from vla_fastvlm_tpu_torch.models import fastvlm as t_vlm
from vla_fastvlm_tpu_torch.models import qwen2 as t_qwen
from vla_fastvlm_tpu_torch.serving import (
    GenerationServer,
    SpeculativeGenerationServer,
    SpeculativeGenerator,
    generate,
    speculative_accept,
    warp_logits,
)
from vla_fastvlm_tpu_torch.serving.speculative import _accept

from _torch_parity import jax_param_shapes, random_params, t

PROMPT, NEW = 8, 7
LOGIT_ATOL = 1e-4
EMBED_SCALE = 0.1


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


def _batch():
    """The requests as one (images, ids, mask) batch."""
    ids, mask, imgs = (np.concatenate([r[i] for r in REQS]) for i in range(3))
    return imgs, ids, mask


def _drive(server, reqs=REQS):
    """Submit as slots free up, step until drained; tokens by request order."""
    rids, outputs = [], {}
    pending = list(reqs)
    while pending or server.num_active:
        while pending and server.has_free_slot():
            rids.append(server.submit(*pending.pop(0)))
        outputs.update(server.step())
    return np.array([outputs[r] for r in rids])


def _pair(kvq="none"):
    """JAX (target, draft) modules and params, the port's modules with the
    same weights. The token embedding is scaled by ``EMBED_SCALE``: at unit
    scale it dominates the residual stream and the tied LM head copies the
    input token, so greedy decoding repeats one token and any draft is
    always accepted; scaled down, the sequences vary and a separate draft
    is mostly rejected."""
    jcfg = j_vlm.fastvlm_tiny().replace(text=j_qwen.qwen2_tiny(kv_cache_quantization=kvq))
    tcfg = t_vlm.fastvlm_tiny().replace(text=t_qwen.qwen2_tiny(kv_cache_quantization=kvq))
    out = []
    for seed in (2, 9):
        jm = j_vlm.FastVLM(jcfg)
        params = random_params(jax_param_shapes(jm, jnp.zeros((1, 3, 64, 64)), jnp.ones((1, PROMPT), jnp.int32)),
                               seed=seed)
        embed = params["language_model"]["embed_tokens"]
        embed["embedding"] = embed["embedding"] * EMBED_SCALE
        tm = t_vlm.FastVLM(tcfg)
        tm.load_state_dict(jax_params_to_torch(params), strict=True)
        out.append((jm, params, tm.eval().requires_grad_(False)))
    return out


@pytest.fixture(scope="module")
def pair():
    (jt, tp, tt), (jd, dp, td) = _pair()
    imgs, ids, mask = _batch()
    ref = np.asarray(j_generate(jt, tp, jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(mask),
                                max_new_tokens=NEW, eos_token_id=-1))
    return dict(jt=jt, tp=tp, tt=tt, jd=jd, dp=dp, td=td, ref=ref)


class TestVerifyStep:
    @pytest.mark.parametrize("kvq", ["none", "int8"])
    def test_logits_and_cache_match_jax(self, kvq):
        (jm, params, tm), _ = _pair(kvq)
        imgs, ids, mask = _batch()
        imgs, ids, mask = imgs[:3], ids[:3], mask[:3]
        max_len = jm.cfg.num_image_tokens + PROMPT + 6
        jcache = j_qwen.init_kv_cache(jm.cfg.text, 3, max_len)
        _, _, jcache, _, _ = jm.apply({"params": params}, jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(mask),
                                      jcache, method=j_vlm.FastVLM.prefill)
        tcache = t_qwen.init_kv_cache(tm.cfg.text, 3, max_len)
        window = np.random.default_rng(1).integers(3, 500, (3, 4)).astype(np.int32)
        with torch.no_grad():
            _, _, tcache, _, _ = tm.prefill(t(imgs), t(ids), t(mask), tcache)
            tlogits, tcache = tm.verify_step(t(window), tcache)
        jlogits, jcache = jm.apply({"params": params}, jnp.asarray(window), jcache, method=j_vlm.FastVLM.verify_step)
        assert tuple(tlogits.shape) == (3, 4, tm.cfg.text.vocab_size)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL)
        np.testing.assert_array_equal(tcache["mask"].numpy(), np.asarray(jcache["mask"]))
        np.testing.assert_array_equal(tcache["index"].numpy(), np.asarray(jcache["index"]))
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in jcache:
                np.testing.assert_allclose(tcache[name].float().numpy(), np.asarray(jcache[name], np.float32),
                                           atol=LOGIT_ATOL)


class TestSpeculativeGenerator:
    @pytest.mark.parametrize("k", [1, 3])
    def test_greedy_tokens_match_jax_and_generate(self, pair, k):
        imgs, ids, mask = _batch()
        jgen = j_spec.SpeculativeGenerator(pair["jt"], pair["tp"], pair["jd"], pair["dp"], k=k, eos_token_id=-1)
        ref = np.asarray(jgen.generate(jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=NEW))
        got = SpeculativeGenerator(pair["tt"], pair["td"], k=k, eos_token_id=-1).generate(
            imgs, ids, mask, max_new_tokens=NEW)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, pair["ref"])
        np.testing.assert_array_equal(got, generate(pair["tt"], imgs, ids, mask, max_new_tokens=NEW,
                                                    eos_token_id=-1).numpy())

    def test_self_draft_is_exact(self, pair):
        imgs, ids, mask = _batch()
        got = SpeculativeGenerator(pair["tt"], pair["tt"], k=3, eos_token_id=-1).generate(
            imgs, ids, mask, max_new_tokens=NEW)
        np.testing.assert_array_equal(got, pair["ref"])

    def test_eos_truncation_matches_generate(self, pair):
        imgs, ids, mask = _batch()
        eos = int(pair["ref"][0, NEW // 2])
        ref = generate(pair["tt"], imgs, ids, mask, max_new_tokens=NEW, eos_token_id=eos).numpy()
        got = SpeculativeGenerator(pair["tt"], pair["td"], k=2, eos_token_id=eos).generate(
            imgs, ids, mask, max_new_tokens=NEW)
        np.testing.assert_array_equal(got, ref)


class TestDenseServers:
    def test_generation_server_matches_jax(self, pair):
        jserver = JGenerationServer(pair["jt"], pair["tp"], num_slots=2, prompt_len=PROMPT, max_new_tokens=NEW,
                                    eos_token_id=-1)
        ref = _drive(jserver)
        server = GenerationServer(pair["tt"], num_slots=2, prompt_len=PROMPT, max_new_tokens=NEW, eos_token_id=-1)
        got = _drive(server)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, pair["ref"])

    def test_generation_server_step_n_matches_step(self, pair):
        make = lambda: GenerationServer(pair["tt"], num_slots=2, prompt_len=PROMPT, max_new_tokens=NEW,
                                        eos_token_id=-1)
        a, b = make(), make()
        for s in (a, b):
            for req in REQS[:2]:
                s.submit(*req)
        out_a = a.step_n(NEW)
        out_a.update(a.run_to_completion())
        assert out_a == b.run_to_completion() and len(out_a) == 2

    @pytest.mark.parametrize("k", [1, 3])
    def test_speculative_server_matches_jax_and_plain(self, pair, k):
        jserver = j_spec.SpeculativeGenerationServer(pair["jt"], pair["tp"], pair["jd"], pair["dp"], k=k,
                                                     num_slots=2, prompt_len=PROMPT, max_new_tokens=NEW,
                                                     eos_token_id=-1)
        ref = _drive(jserver)
        server = SpeculativeGenerationServer(pair["tt"], pair["td"], k=k, num_slots=2, prompt_len=PROMPT,
                                             max_new_tokens=NEW, eos_token_id=-1)
        got = _drive(server)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, pair["ref"])
        assert server.spec_ticks > 0 and server.spec_tokens_emitted == len(REQS) * (NEW - 1)

    def test_self_draft_needs_fewer_ticks(self, pair):
        other = SpeculativeGenerationServer(pair["tt"], pair["td"], k=3, num_slots=2, prompt_len=PROMPT,
                                            max_new_tokens=NEW, eos_token_id=-1)
        self_ = SpeculativeGenerationServer(pair["tt"], pair["tt"], k=3, num_slots=2, prompt_len=PROMPT,
                                            max_new_tokens=NEW, eos_token_id=-1)
        np.testing.assert_array_equal(_drive(self_), pair["ref"])
        np.testing.assert_array_equal(_drive(other), pair["ref"])
        assert self_.spec_ticks < other.spec_ticks
        assert self_.tokens_per_tick > other.tokens_per_tick
        # every self-draft proposal is accepted: k + 1 tokens a slot and round
        # but where a request runs out of budget first
        assert self_.tokens_per_slot_round > 2.0 > other.tokens_per_slot_round >= 1.0


class TestRefusals:
    def test_vocab_mismatch_and_k(self, pair):
        small = t_vlm.FastVLM(t_vlm.fastvlm_tiny().replace(text=t_qwen.qwen2_tiny().replace(vocab_size=256)))
        with pytest.raises(ValueError, match="vocab mismatch"):
            SpeculativeGenerator(pair["tt"], small)
        with pytest.raises(ValueError, match="vocab mismatch"):
            SpeculativeGenerationServer(pair["tt"], small)
        with pytest.raises(ValueError, match="k must be"):
            SpeculativeGenerator(pair["tt"], pair["td"], k=0)

    def test_draft_on_another_device(self, pair):
        with torch.device("meta"):
            draft = t_vlm.FastVLM(t_vlm.fastvlm_tiny())
        with pytest.raises(ValueError, match="one device"):
            SpeculativeGenerator(pair["tt"], draft)
        with pytest.raises(ValueError, match="one device"):
            SpeculativeGenerationServer(pair["tt"], draft)

    def test_step_n_and_unported_options(self, pair):
        server = SpeculativeGenerationServer(pair["tt"], pair["td"], k=2, num_slots=1, prompt_len=PROMPT)
        with pytest.raises(NotImplementedError, match="step_n"):
            server.step_n(4)
        with pytest.raises(ValueError, match="mesh must be"):  # meshes: tests/test_torch_sharded_serving.py
            GenerationServer(pair["tt"], num_slots=1, prompt_len=4, mesh=object())
        # An empty adapter tree mounts nothing; lora_index needs multi-LoRA.
        assert SpeculativeGenerationServer(pair["tt"], pair["td"], k=2, num_slots=1, prompt_len=PROMPT,
                                           lora={})._lora == {}
        with pytest.raises(ValueError, match="LIST of adapters"):
            GenerationServer(pair["tt"], num_slots=1, prompt_len=4).submit(
                np.ones((1, 4), np.int32), np.ones((1, 4), np.int32), lora_index=0)


class TestAcceptRule:
    def test_greedy_matches_jax(self):
        rng = np.random.default_rng(3)
        b, k, v = 64, 4, 16
        tlogits = rng.standard_normal((b, k + 1, v)).astype(np.float32)
        greedy = tlogits.argmax(-1)
        dtoks = rng.integers(0, v, (b, k)).astype(np.int32)
        # rows accepting 0..k proposals: the first a proposals match
        for row in range(b):
            a = row % (k + 1)
            dtoks[row, :a] = greedy[row, :a]
        ja, jc = j_spec._accept(jnp.asarray(dtoks), None, jnp.asarray(tlogits), None, temperature=0.0, top_p=1.0)
        a, c = _accept(t(dtoks), None, t(tlogits), None, temperature=0.0, top_p=1.0)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        assert sorted(set(a.tolist())) == list(range(k + 1))

    @pytest.mark.parametrize("top_p", [1.0, 0.8])
    def test_sampled_rule_follows_the_target_distribution(self, top_p):
        """With fixed draft and target distributions, the first emitted token
        follows the warped p_0 and, given one acceptance, the second follows
        p_1 (the Leviathan et al. invariant)."""
        v, k, temp, n = 8, 3, 0.7, 60000
        g = torch.Generator().manual_seed(0)
        p_logits = torch.randn(1, k + 1, v, generator=g)
        q_logits = p_logits[:, :k] + 0.5 * torch.randn(1, k, v, generator=g)
        dtoks = torch.multinomial(torch.softmax(warp_logits(q_logits, temp, top_p), -1)[0], n, replacement=True,
                                  generator=g).T.to(torch.int32)  # (n, k)
        a, corr = speculative_accept(dtoks, q_logits.expand(n, k, v), p_logits.expand(n, k + 1, v), g, temp, top_p)
        first = torch.where(a >= 1, dtoks[:, 0], corr)
        second = torch.where(a >= 2, dtoks[:, 1], corr)[a >= 1]
        p = torch.softmax(warp_logits(p_logits, temp, top_p), -1)[0].numpy()
        np.testing.assert_allclose(p, np.asarray(jax.nn.softmax(
            j_sampling.warp_logits(jnp.asarray(p_logits.numpy()), temp, top_p), axis=-1))[0], atol=1e-6)
        tv = lambda x, ref: 0.5 * np.abs(np.bincount(x.numpy(), minlength=v) / len(x) - ref).sum()
        assert tv(first, p[0]) < 0.02
        assert len(second) > n // 4 and tv(second, p[1]) < 0.02

    def test_degenerate_residual_falls_back_to_the_target(self):
        """p == q and proposals outside the nucleus: every proposal is
        rejected (p = q = 0 there) and the residual p - q is 0 everywhere,
        so the correction samples p_0 itself."""
        v, k, n = 6, 2, 4000
        logits = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -12.0]).expand(n, k + 1, v)
        g = torch.Generator().manual_seed(2)
        dtoks = torch.full((n, k), 5, dtype=torch.int32)
        a, corr = speculative_accept(dtoks, logits[:, :k], logits, g, 1.0, top_p=0.9)
        p0 = torch.softmax(warp_logits(logits[:1, 0], 1.0, 0.9), -1)[0].numpy()
        assert (a == 0).all() and p0[5] == 0.0
        emp = np.bincount(corr.numpy(), minlength=v) / n
        assert 0.5 * np.abs(emp - p0).sum() < 0.03
