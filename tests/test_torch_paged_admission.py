"""Paged miss admission on its real rows, on the CPU.

A ``PagedGenerationServer`` whose ``prefill_batch`` is wider than a
program's requests runs the vision tower and the prefill on exactly those
requests (spies on the target's ``encode_images``, ``prefill`` and
``prefill_text_chunk``), and gives every request the first-token logits and
the greedy tokens of a server whose ``prefill_batch`` equals the program's
rows, so that every program of it is full. Cases: plain and chunked
admission, multi-LoRA, int8 pools, and the speculative paged server, whose
draft admission keeps its ``prefill_batch`` rows (the draft's fixed-row
slot insert).

Tiny FastVLM (one image token at 64 px), fp32, the port alone.
"""

import numpy as np
import pytest
import torch

from vla_fastvlm_tpu_torch.io.lora import init_lora, map_lora
from vla_fastvlm_tpu_torch.models import fastvlm as t_vlm
from vla_fastvlm_tpu_torch.models import qwen2 as t_qwen
from vla_fastvlm_tpu_torch.serving import PagedGenerationServer, SpeculativePagedGenerationServer

LOGIT_ATOL = 1e-5
# Scaled down so greedy sequences vary (``tests/test_torch_speculative.py``).
EMBED_SCALE = 0.1
# Two requests of each bucket: every program holds ROWS requests, of
# PREFILL_BATCH rows on the wide server and of ROWS on the full one.
ROWS, PREFILL_BATCH = 2, 4
SERVER_KW = dict(num_slots=4, prompt_len=(4, 8), max_new_tokens=5, eos_token_id=-1, page_size=4)
LENGTHS = (7, 3, 5, 2)  # buckets 8, 4, 8, 4
ROUTES = (None, 0, 1, 0)  # the multi-LoRA case's adapters


def _model(seed, kvq="none"):
    torch.manual_seed(seed)
    model = t_vlm.FastVLM(t_vlm.fastvlm_tiny().replace(text=t_qwen.qwen2_tiny(kv_cache_quantization=kvq)))
    with torch.no_grad():
        model.language_model.embed_tokens.weight.mul_(EMBED_SCALE)
    return model.eval().requires_grad_(False)


def _adapter(model, seed):
    """A rank-4 adapter with every leaf seeded and non-zero (B included)."""
    gen = torch.Generator().manual_seed(seed)
    return map_lora(lambda x: torch.randn(x.shape, generator=gen) * 0.05, init_lora(model, 4, seed=seed))


def _requests():
    rng = np.random.default_rng(5)
    out = []
    for length in LENGTHS:
        ids = rng.integers(3, 500, (1, length)).astype(np.int32)
        out.append((ids, np.ones_like(ids), rng.random((1, 3, 64, 64), dtype=np.float32)))
    return out


@pytest.fixture(scope="module")
def models():
    target = _model(0)
    return {"target": target, "int8": _model(0, "int8"), "draft": _model(1),
            "adapters": [_adapter(target, 7), _adapter(target, 8)]}


CASES = ["plain", "chunked", "multi_lora", "int8", "speculative"]


def _server(models, case, prefill_batch):
    kw = dict(SERVER_KW, prefill_batch=prefill_batch)
    if case == "chunked":
        kw["prefill_chunk_tokens"] = 4
    if case == "multi_lora":
        kw["lora"] = models["adapters"]
    if case == "speculative":
        return SpeculativePagedGenerationServer(models["target"], models["draft"], k=2, **kw)
    return PagedGenerationServer(models["int8" if case == "int8" else "target"], **kw)


def _spy(monkeypatch, obj, name, rows, key):
    """Record the batch dimension of ``obj.name``'s argument ``key`` (an index) in ``rows``."""
    inner = getattr(obj, name)

    def spy(*args, **kwargs):
        rows.append(args[key].shape[0])
        return inner(*args, **kwargs)

    monkeypatch.setattr(obj, name, spy)


def _serve(server, case):
    """Submit every request, drain; each request's first-token logits and tokens, in request order."""
    first = {}
    register = server._register_misses

    def record(batch, tokens, masks, last_logits, prefill_len):
        first.update({req.request_id: last_logits[row].clone() for row, req in enumerate(batch)})
        return register(batch, tokens, masks, last_logits, prefill_len)

    server._register_misses = record
    routes = ROUTES if case == "multi_lora" else (None,) * len(LENGTHS)
    rids = [server.submit(*req, lora_index=route) for req, route in zip(_requests(), routes)]
    out = server.run_to_completion()
    return torch.stack([first[r] for r in rids]).numpy(), np.array([out[r] for r in rids])


@pytest.mark.parametrize("case", CASES)
def test_a_miss_program_runs_on_its_requests_alone(monkeypatch, models, case):
    full_logits, full_tokens = _serve(_server(models, case, ROWS), case)

    model = models["int8" if case == "int8" else "target"]
    tower, prefill, chunks, draft = [], [], [], []
    _spy(monkeypatch, model, "encode_images", tower, 0)
    _spy(monkeypatch, model, "prefill", prefill, 1)
    _spy(monkeypatch, model, "prefill_text_chunk", chunks, 0)
    _spy(monkeypatch, models["draft"], "prefill", draft, 1)
    logits, tokens = _serve(_server(models, case, PREFILL_BATCH), case)

    # One program a bucket, each on its ROWS requests.
    assert tower == [ROWS, ROWS]
    if case == "chunked":  # the image chunk, then 2 + 1 text chunks of 4 tokens
        assert prefill == [] and chunks == [ROWS] * 3
    else:
        assert prefill == [ROWS, ROWS] and chunks == []
    assert draft == ([PREFILL_BATCH, PREFILL_BATCH] if case == "speculative" else [])
    np.testing.assert_allclose(logits, full_logits, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(tokens, full_tokens)
    assert tokens.shape == (len(LENGTHS), SERVER_KW["max_new_tokens"])
