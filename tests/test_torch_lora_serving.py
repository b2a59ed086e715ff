"""LoRA and multi-LoRA through the port's serving stack, against the JAX package on the CPU.

- ``stack_loras`` / ``lora_with_ids``: shapes, values and errors against JAX's.
- A multi-LoRA batch's rows against single-adapter runs of each row.
- Greedy tokens of ``generate`` and of the dense, paged and chunked servers,
  single adapter and multi-LoRA (requests routed by ``lora_index``), equal
  to the JAX ``generate(..., lora=...)`` over the same adapters (the
  reference JAX's own LoRA serving tests pin their servers to).
- The paged server's prefix cache keyed by adapter: hits, partial hits and
  misses and the tokens equal to the JAX cached multi-LoRA server's.
- The speculative dense and paged servers with target adapters against the
  plain LoRA server; ``lora_index`` validation; the serve CLI with two
  ``--lora-dir`` adapters.

Tiny FastVLM (1 image token at 64 px), fp32, weights and adapters (non-zero
B) from numpy seeds through the bridge. Tokens are compared exactly (fp32
logits up to summation order, far from ties); logits within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.io import lora as jlora
from vla_fastvlm_tpu.serving import generate as j_generate
from vla_fastvlm_tpu.serving.paged_kv import PagedGenerationServer as JPagedServer
from vla_fastvlm_tpu_torch.io.bridge import flatten_params, jax_lora_to_torch
from vla_fastvlm_tpu_torch.io.lora import lora_with_ids, stack_loras
from vla_fastvlm_tpu_torch.serving import (
    GenerationServer,
    PagedGenerationServer,
    SpeculativeGenerationServer,
    SpeculativePagedGenerationServer,
    generate,
)

from _torch_parity import jax_adapter, t, tiny_vlm_pair

PROMPT, NEW, PAGE = 8, 5, 4
LOGIT_ATOL = 1e-5
DENSE = dict(num_slots=3, prompt_len=PROMPT, max_new_tokens=NEW, eos_token_id=-1, prefill_batch=2)
PAGED = dict(DENSE, page_size=PAGE)
# The adapter of each request: None is the base, i the i-th adapter.
ROUTES = [None, 0, 1, 0, 1]


def _requests(n=len(ROUTES), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(3, PROMPT + 1))
        ids = np.zeros((1, PROMPT), np.int32)
        mask = np.zeros((1, PROMPT), np.int32)
        ids[0, :length] = rng.integers(3, 500, length)
        mask[0, :length] = 1
        out.append((ids, mask, rng.random((1, 3, 64, 64), dtype=np.float32)))
    return out


REQS = _requests()


def _stacked_ids(routes):
    return np.array([0 if r is None else r + 1 for r in routes], np.int32)


@pytest.fixture(scope="module")
def setup():
    """The tiny pair, two JAX adapters and their port twins, and the JAX
    ``generate`` references: one adapter on every row, and multi-LoRA by ROUTES."""
    jm, params, tm = tiny_vlm_pair(3)
    jl = [jax_adapter(params, 4, seed=7 + i) for i in (1, 2)]
    imgs, ids, mask = (jnp.asarray(np.concatenate([r[i] for r in REQS])) for i in (2, 0, 1))
    gen = lambda lora: np.asarray(j_generate(jm, params, imgs, ids, mask, max_new_tokens=NEW, eos_token_id=-1,
                                             lora=lora))
    multi = jlora.lora_with_ids(jlora.stack_loras(jl), jnp.asarray(_stacked_ids(ROUTES)))
    return dict(jm=jm, params=params, tm=tm, jl=jl, tl=[jax_lora_to_torch(x) for x in jl],
                ref={"single": gen(jl[0]), "multi": gen(multi)})


def _drive(server, reqs=REQS, routes=None):
    """Submit as slots free up, step until drained; tokens by request order."""
    pending = list(zip(reqs, routes or [None] * len(reqs)))
    rids, outputs = [], {}
    while pending or server.num_active:
        while pending and server.has_free_slot():
            req, route = pending.pop(0)
            rids.append(server.submit(*req, lora_index=route))
        outputs.update(server.step())
    return np.array([outputs[r] for r in rids])


class TestStackHelpers:
    def test_stack_matches_jax(self, setup):
        jl, tl = setup["jl"], setup["tl"]
        ref = flatten_params(jax_lora_to_torch(jax.device_get(jlora.stack_loras(jl))))
        got = flatten_params(stack_loras(tl))
        assert sorted(got) == sorted(ref)
        for name, value in ref.items():
            assert got[name].shape == value.shape and got[name].shape[1] == 3  # (L, 1 + 2, ...)
            assert torch.equal(got[name], value) and not got[name][:, 0].any()
        no_base = flatten_params(stack_loras(tl, include_base=False))
        assert all(v.shape[1] == 2 for v in no_base.values())
        stacked = stack_loras(tl)
        site = lora_with_ids(stacked, [2, 0])["language_model"]["layers"]["mlp"]["up_proj"]
        assert site["ids"].tolist() == [2, 0]
        assert site["a"] is stacked["language_model"]["layers"]["mlp"]["up_proj"]["a"]  # shared, not copied

    def test_errors(self, setup):
        tl = setup["tl"]
        with pytest.raises(ValueError, match="at least one"):
            stack_loras([])
        other = jax_lora_to_torch(jax_adapter(setup["params"], 2, 1))
        with pytest.raises(ValueError, match="one structure"):
            stack_loras([tl[0], other])
        with pytest.raises(ValueError, match=r"\(B,\)"):
            lora_with_ids(stack_loras(tl), np.zeros((2, 2), np.int32))

    def test_multi_row_logits_match_single_adapter(self, setup):
        tm, tl = setup["tm"], setup["tl"]
        images, ids, mask = (t(np.concatenate([r[i] for r in REQS[:3]])) for i in (2, 0, 1))
        multi = lora_with_ids(stack_loras(tl), [0, 1, 2])
        with torch.no_grad():
            got, _, _ = tm.forward_logits(images, ids, mask, lora=multi)
            rows = [tm.forward_logits(images, ids, mask, lora=lora)[0] for lora in (None, tl[0], tl[1])]
        for row, ref in enumerate(rows):
            np.testing.assert_allclose(got[row].numpy(), ref[row].numpy(), atol=LOGIT_ATOL)


class TestGreedyTokens:
    @pytest.mark.parametrize("mode", ["single", "multi"])
    def test_generate(self, setup, mode):
        tm, tl = setup["tm"], setup["tl"]
        lora = tl[0] if mode == "single" else lora_with_ids(stack_loras(tl), _stacked_ids(ROUTES))
        imgs, ids, mask = (np.concatenate([r[i] for r in REQS]) for i in (2, 0, 1))
        out = generate(tm, imgs, ids, mask, max_new_tokens=NEW, eos_token_id=-1, lora=lora)
        np.testing.assert_array_equal(out.numpy(), setup["ref"][mode])

    @pytest.mark.parametrize("mode", ["single", "multi"])
    @pytest.mark.parametrize("kind", ["dense", "paged", "chunked"])
    def test_servers(self, setup, kind, mode):
        tm, tl = setup["tm"], setup["tl"]
        lora, routes = (tl[0], None) if mode == "single" else (tl, ROUTES)
        if kind == "dense":
            server = GenerationServer(tm, lora=lora, **DENSE)
        else:
            server = PagedGenerationServer(tm, lora=lora, prefill_chunk_tokens=4 if kind == "chunked" else 0, **PAGED)
        np.testing.assert_array_equal(_drive(server, routes=routes), setup["ref"][mode])
        if kind != "dense":
            assert server.pool.free_pages == server.pool.num_pages - 1


def _prefix_stream(seed=4):
    """One (frame, prompt) under the base, adapter 0, adapter 0 again,
    adapter 1 and the base again; then a template share under adapter 0."""
    rng = np.random.default_rng(seed)
    frame = rng.random((1, 3, 64, 64), dtype=np.float32)
    ids = np.zeros((1, PROMPT), np.int32)
    mask = np.ones((1, PROMPT), np.int32)
    ids[0] = rng.integers(3, 500, PROMPT)
    tail = ids.copy()
    tail[0, 5:] = rng.integers(3, 500, 3)
    return [(ids, mask, frame)] * 5 + [(tail, mask, frame)], [None, 0, 0, 1, None, 0]


def test_prefix_cache_keys_by_adapter_like_jax(setup):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
    reqs, routes = _prefix_stream()
    kw = dict(PAGED, num_slots=1, prefix_cache_size=4)
    jserver = JPagedServer(jm, params, lora=list(setup["jl"]), **kw)
    ref = _drive(jserver, reqs, routes)
    server = PagedGenerationServer(tm, lora=setup["tl"], **kw)
    np.testing.assert_array_equal(_drive(server, reqs, routes), ref)
    counts = lambda s: (s.prefix_cache_hits, s.prefix_cache_partial_hits, s.prefix_cache_misses)
    assert counts(server) == counts(jserver)
    # A repeat under another adapter is a miss; under the same one a hit.
    assert counts(server) == (2, 1, 3), counts(server)
    server.evict_prefix_cache()
    assert server.pool.free_pages == server.pool.num_pages - 1


class TestSpeculative:
    @pytest.fixture(scope="class")
    def draft(self):
        return tiny_vlm_pair(5)[2]

    @pytest.mark.parametrize("kind", ["dense", "paged"])
    def test_target_adapters_match_the_plain_lora_server(self, setup, draft, kind):
        tm, tl = setup["tm"], setup["tl"]
        if kind == "dense":
            server = SpeculativeGenerationServer(tm, draft, k=2, lora=tl, **DENSE)
        else:
            server = SpeculativePagedGenerationServer(tm, draft, k=2, lora=tl, prefix_cache_size=2, **PAGED)
        np.testing.assert_array_equal(_drive(server, routes=ROUTES), setup["ref"]["multi"])
        assert server.spec_ticks > 0 and 1.0 <= server.tokens_per_slot_round <= 3.0


class TestValidation:
    @pytest.mark.parametrize("cls,kw", [(GenerationServer, DENSE), (PagedGenerationServer, PAGED)],
                             ids=["dense", "paged"])
    def test_lora_index(self, setup, cls, kw):
        tm, tl = setup["tm"], setup["tl"]
        req = REQS[0]
        with pytest.raises(ValueError, match="LIST of adapters"):
            cls(tm, **kw).submit(*req, lora_index=0)
        with pytest.raises(ValueError, match="LIST of adapters"):
            cls(tm, lora=tl[0], **kw).submit(*req, lora_index=0)
        multi = cls(tm, lora=tl, **kw)
        for bad in (2, -1):
            with pytest.raises(ValueError, match="out of range"):
                multi.submit(*req, lora_index=bad)
        multi.submit(*req, lora_index=1)


def test_serve_cli_with_two_adapters(tmp_path, capsys):
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy
    from vla_fastvlm_tpu_torch.io.checkpoint import save_policy_checkpoint
    from vla_fastvlm_tpu_torch.scripts import serve

    dirs = []
    for i in range(2):
        policy = FastVLAPolicy(FastVLAConfig(vlm_model_name="fastvlm-tiny", hidden_dim=8, fusion_dim=8, lora_rank=2,
                                             tokenizer_max_length=8, seed=i), device="cpu")
        with torch.no_grad():
            for name, p in policy.params["lora"].items():
                if name.endswith(".b"):
                    p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(i))
        save_policy_checkpoint(tmp_path / f"a{i}", policy.config, policy.jax_params(as_numpy=False))
        dirs.append(str(tmp_path / f"a{i}"))
    args = dict(device="cpu", model_id="fastvlm-tiny", dtype="float32", num_requests=6, num_slots=3,
                prompt_len=8, max_new_tokens=4, paged=True, page_size=4, prefix_cache=2, repeat_fraction=0.5)
    summary = serve.main(serve.ServeArgs(lora_dir=tuple(dirs), **args))
    assert summary["lora_adapters"] == 2 and summary["total_new_tokens"] == 6 * 4
    assert summary["pages"]["free_after_evict"] == summary["pages"]["usable"]
    single = serve.main(serve.ServeArgs(lora_dir=tuple(dirs[:1]), **dict(args, paged=False, prefix_cache=0)))
    assert single["lora_adapters"] == 1 and single["total_new_tokens"] == 6 * 4
