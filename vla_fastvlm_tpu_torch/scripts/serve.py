"""Continuous-batching generation server load CLI of the port (twin of the
repository's ``scripts/serve.py``).

    python -m vla_fastvlm_tpu_torch.scripts.serve --model-id fastvlm-0.5b --paged \\
        --num-slots 64 --prefill-batch 16 --prompt-len 64 --max-new-tokens 64 --num-requests 128
    python -m vla_fastvlm_tpu_torch.scripts.serve ... --paged --prefix-cache 16 --repeat-fraction 0.5
    python -m vla_fastvlm_tpu_torch.scripts.serve ... --paged --prefill-chunk-tokens 16
    python -m vla_fastvlm_tpu_torch.scripts.serve ... --paged --lora-dir CKPT_A CKPT_B CKPT_C
    python -m vla_fastvlm_tpu_torch.scripts.serve --device cpu --model-id fastvlm-tiny --num-requests 6 \\
        --num-slots 3 --dtype float32

Drives one of the port's four servers (dense ``GenerationServer``,
``PagedGenerationServer``, and the speculative dense and paged servers with
``--draft-model-id``) with the JAX script's synthetic request stream: the
same ``ServeArgs`` flags and defaults, the same requests from
``np.random.default_rng(seed)`` (prompt lengths 4..``prompt_len``, a
``repeat_fraction`` share reusing the first request, ``arrivals_per_tick``
arrivals a tick while slots allow). A preset's weights are random from
``seed`` (the draft's from ``seed + 1``); a ``--model-id`` (or
``--draft-model-id``) naming a local HF FastVLM directory loads its
``*.safetensors`` over that init (``io/model_loader.py``).

Prints one JSON summary and returns it from ``main``: the JAX script's keys
(``tokens_per_sec``, ``p50_tick_ms``, ``ticks``, ``device``, the prefix-cache
hits and misses, ``spec_k`` and ``tokens_per_tick``), unrounded, and the
port's own: the largest tick; the ticks that ran admission work (a prefill,
an image or text chunk, a prefix-cache hit) and their p50 against the p50
of the pure decode ticks; the host time of ``submit`` (the prefix-cache
hashes of the raw frame); the servers' program counters; and for a paged
server its page accounting (free and cache-pinned pages, and the free pages
once the prefix cache is emptied).

``--lora-dir`` serves LoRA adapters over the random base: each directory
is a policy checkpoint trained with ``--lora-rank`` (its ``"lora"`` tree,
``io/lora.py::load_lora``). One directory applies to every request; with
more, requests round-robin over the base and the adapters (multi-LoRA), and
the summary gains ``lora_adapters``. On a speculative server they mount on
the target only.

``--quantization int8|int4|w8a8`` quantizes the target's decoder
(``io/quantize.py``); a draft stays float, as in the JAX script (the
deployment: ``--model-id fastvlm-7b --quantization int8 --draft-model-id
fastvlm-0.5b --paged``). ``--device`` is the card unless ``--device cpu`` is
given; without CUDA the script raises. ``--tp`` above 1 serves on a (1, tp)
mesh: the target's decoder split over its ranks (heads, MLP width, cache or
page pools by KV head), the draft and adapters whole on each, the paged
decode "gathered" under "auto"; under ``torchrun`` on its ranks, else on
``tp`` ranks the command starts itself. Rank 0 prints the summary.
"""

from __future__ import annotations

import json
import statistics
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..io.lora import load_lora
from ..io.presets import resolve_fastvlm_config
from ..model import FastVLMBackbone, FastVLMBackboneConfig
from ..parallel import cli_mesh, is_main_rank, needs_own_ranks, spawn_ranks
from ..parallel.sharding import tp_text_config
from ..serving import (
    GenerationServer,
    PagedGenerationServer,
    SpeculativeGenerationServer,
    SpeculativePagedGenerationServer,
)
from ..utils import configure_logging, parse_cli


@dataclass
class ServeArgs:
    model_id: str = "fastvlm-0.5b"
    num_slots: int = 8
    prefill_batch: int = 4
    prompt_len: int = 32
    max_new_tokens: int = 32
    num_requests: int = 16
    # New requests admitted per decode tick, slots permitting.
    arrivals_per_tick: int = 2
    image_size: Optional[int] = None
    dtype: str = "bfloat16"
    # The card unless "cpu" is asked for.
    device: Optional[str] = "cuda"
    seed: int = 0
    # Mesh size of the JAX script; the port serves on one card.
    tp: int = 1
    # "int8" | "int4" | "w8a8": quantized decoder projections of the target (io/quantize.py).
    quantization: str = "none"
    # "int8": int8 KV cache storage (dense and paged servers).
    kv_cache_quantization: str = "none"
    # Sampling (0.0 = greedy); top_p < 1 applies nucleus filtering.
    temperature: float = 0.0
    top_p: float = 1.0
    # Paged KV cache (serving/paged_kv.py).
    paged: bool = False
    page_size: int = 16
    # "kernel" (the paged-attention kernel), "gathered" (the plain program), "auto" = kernel.
    decode_impl: str = "auto"
    # Pool size in pages (default: every slot at max length + trash page).
    num_pages: Optional[int] = None
    # > 0: prefix caching over that many distinct prompts (paged servers).
    prefix_cache: int = 0
    # Share of requests reusing the first request's (prompt, frame).
    repeat_fraction: float = 0.0
    # > 0: chunked admission of this many prompt tokens a tick (paged servers);
    # buckets must be multiples of it.
    prefill_chunk_tokens: int = 0
    # LoRA adapters: policy checkpoint dirs trained with --lora-rank; more
    # than one is multi-LoRA (requests round-robin over base + adapters).
    lora_dir: Tuple[str, ...] = ()
    # Speculative decoding: a same-vocab draft preset proposes spec_k tokens a tick.
    draft_model_id: Optional[str] = None
    spec_k: int = 4


def build_backbone(args: ServeArgs, model_id: str, seed: int, image_size: Optional[int], kv: str,
                   device: torch.device, quantization: str = "none") -> FastVLMBackbone:
    """A preset's or a directory's backbone on ``device``, weights random
    from ``seed`` under what the directory holds."""
    return FastVLMBackbone(FastVLMBackboneConfig(
        model_id=model_id, bootstrap_model_id=model_id, force_image_size=image_size, dtype=args.dtype,
        param_dtype=args.dtype, quantization=quantization, kv_cache_quantization=kv, seed=seed,
    ), device=device)


def build_server(args: ServeArgs, device: torch.device, lora=None, mesh=None):
    """The server ``args`` name, over a random-weight model of its preset,
    with ``lora`` (None, one adapter tree or a list) on the target, on
    ``mesh`` when one is given."""
    backbone = build_backbone(args, args.model_id, args.seed, args.image_size, args.kv_cache_quantization, device,
                              args.quantization)
    common = dict(num_slots=args.num_slots, prompt_len=args.prompt_len, max_new_tokens=args.max_new_tokens,
                  eos_token_id=-1,  # synthetic stream: run to max length
                  prefill_batch=args.prefill_batch, temperature=args.temperature, top_p=args.top_p, seed=args.seed,
                  lora=lora, mesh=mesh)
    paged = dict(page_size=args.page_size, num_pages=args.num_pages, prefix_cache_size=args.prefix_cache,
                 prefill_chunk_tokens=args.prefill_chunk_tokens)
    if args.draft_model_id:
        draft = build_backbone(args, args.draft_model_id, args.seed + 1, backbone.model_config.image_size, "none",
                               device)
        if args.paged:
            return SpeculativePagedGenerationServer(backbone.model, draft.model, k=args.spec_k, **paged, **common)
        return SpeculativeGenerationServer(backbone.model, draft.model, k=args.spec_k, **common)
    if args.paged:
        return PagedGenerationServer(backbone.model, decode_impl=args.decode_impl, **paged, **common)
    return GenerationServer(backbone.model, **common)


def admission_work(server) -> tuple:
    """Counters that move when a ``step`` runs admission work."""
    names = ("admissions", "image_chunks", "text_chunks", "prefix_cache_hits", "prefix_cache_partial_hits")
    return tuple(getattr(server, name, 0) for name in names)


def main(args: ServeArgs) -> dict:
    if needs_own_ranks(args.tp):
        tp_text_config(resolve_fastvlm_config(args.model_id, args.model_id)[0].text, args.tp)
        return spawn_ranks(main, args.tp, args, device=args.device)
    mesh, device = cli_mesh(1, args.tp, args.device)
    configure_logging()
    adapters = [load_lora(d) for d in args.lora_dir]
    num_adapters = len(adapters)
    server = build_server(args, device, None if not adapters else adapters[0] if num_adapters == 1 else adapters,
                          mesh)
    size = server.model.cfg.image_size

    rng = np.random.default_rng(args.seed)
    shared_request = None

    def make_request():
        nonlocal shared_request
        # A repeat_fraction share reuses the first (prompt, frame): the
        # prefix cache's whole-prompt hits.
        if args.repeat_fraction > 0 and shared_request is not None:
            if rng.random() < args.repeat_fraction:
                return shared_request
        length = int(rng.integers(4, args.prompt_len + 1))
        ids = np.zeros((1, args.prompt_len), np.int32)
        mask = np.zeros((1, args.prompt_len), np.int32)
        ids[0, :length] = rng.integers(3, 250, length)
        mask[0, :length] = 1
        image = rng.random((1, 3, size, size), dtype=np.float32)
        if shared_request is None:
            shared_request = (ids, mask, image)
        return ids, mask, image

    submitted = 0
    finished: dict = {}
    tick_times, admission_ticks, submit_times = [], [], []
    t_start = time.perf_counter()
    while len(finished) < args.num_requests:
        arrivals = 0
        while submitted < args.num_requests and server.has_free_slot() and arrivals < args.arrivals_per_tick:
            request = make_request()
            # Multi-LoRA: round-robin over base + adapters.
            cycle = submitted % (num_adapters + 1) if num_adapters > 1 else 0
            t0 = time.perf_counter()
            server.submit(*request, lora_index=None if cycle == 0 else cycle - 1)
            submit_times.append(time.perf_counter() - t0)
            submitted += 1
            arrivals += 1
        before = admission_work(server)
        t0 = time.perf_counter()
        finished.update(server.step())
        tick_times.append(time.perf_counter() - t0)
        admission_ticks.append(admission_work(server) != before)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t_start

    total_tokens = sum(len(t) for t in finished.values())
    ms = lambda xs: float(statistics.median(xs)) * 1e3 if xs else None
    admit = [t for t, a in zip(tick_times, admission_ticks) if a]
    decode = [t for t, a in zip(tick_times, admission_ticks) if not a]
    speculative = args.draft_model_id is not None
    summary = {
        "requests": args.num_requests,
        "slots": args.num_slots,
        "prefill_batch": args.prefill_batch,
        "total_new_tokens": total_tokens,
        "tokens_per_sec": total_tokens / elapsed,
        "p50_tick_ms": ms(tick_times),
        "ticks": len(tick_times),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "max_tick_ms": max(tick_times) * 1e3,
        "admission_ticks": len(admit),
        "p50_admission_tick_ms": ms(admit),
        "p50_decode_tick_ms": ms(decode),
        "p50_submit_ms": ms(submit_times),
        "max_submit_ms": max(submit_times) * 1e3,
        "admissions": server.admissions,
    }
    # Decode ticks (rounds on a speculative server); the dense server counts none.
    ticks = getattr(server, "spec_ticks", getattr(server, "ticks", None))
    if ticks is not None:
        summary["decode_ticks"] = ticks
    if args.paged:
        summary.update(image_chunks=server.image_chunks, text_chunks=server.text_chunks)
    if num_adapters:
        summary["lora_adapters"] = num_adapters
    if args.prefix_cache > 0 and args.paged:
        summary["prefix_cache_hits"] = server.prefix_cache_hits
        summary["prefix_cache_misses"] = server.prefix_cache_misses
        summary["prefix_cache_partial_hits"] = server.prefix_cache_partial_hits
    if speculative:
        summary["spec_k"] = args.spec_k
        # Tokens emitted a speculative round (plain greedy serving is 1.0);
        # admission-time first tokens are not counted.
        summary["tokens_per_tick"] = server.tokens_per_tick
        if args.paged:
            summary["draft_admissions"] = server.draft_admissions
    if args.paged:
        pool = server.pool
        pinned = len(server.pinned_pages())
        free = pool.free_pages
        server.evict_prefix_cache()
        summary["pages"] = {"usable": pool.num_pages - 1, "free": free, "pinned": pinned,
                            "free_after_evict": pool.free_pages, "tables_empty": not pool.page_table.any()}
    if is_main_rank():
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(parse_cli(ServeArgs, prog="python -m vla_fastvlm_tpu_torch.scripts.serve"))
