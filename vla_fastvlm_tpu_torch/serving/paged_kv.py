"""Paged KV cache and the continuous-batching server over it (counterpart of
``vla_fastvlm_tpu/serving/paged_kv.py``).

K/V live in a shared pool of fixed-size pages and each slot has a page
table, so device memory scales with allocated tokens, not slots x max_len:

- **Pool**: ``(L, num_pages, K, page_size, D)`` per K/V (kv-head major).
  Physical page 0 is the trash page: unallocated table entries point at it,
  inactive tick rows and the shared entries of partial hits' tails write
  there, and the kv mask keeps attention from reading it.
- **Page tables**: host-side ``(num_slots, pages_per_slot)`` int32, shipped
  to the device per tick. Allocation is host bookkeeping: a free list,
  reference counts and worst-case reservations (admission control), so a
  mid-decode allocation never fails.
- **Admission**: requests queue at ``submit``; ``step``/``flush`` prefill
  them by prompt bucket, up to ``prefill_batch`` a program, into a dense
  cache of exactly the program's requests (no dummy rows: the port runs
  eagerly and gains nothing from a fixed batch), then scatter the rows into
  their pages.
- **Prefix caching** (``prefix_cache_size``): a whole-prompt repeat installs
  the cached prompt pages by reference and samples its first token from the
  cached logits, with no prefill at all; a request that shares only
  page-aligned leading pages (a common frame and instruction template)
  installs those and prefills its tail alone, page-size text chunks against
  the gathered shared rows (the tails of hits admitted together that share
  a match length run as the rows of one program). Both layers are LRU maps that pin pages through
  the pool's reference counts.
- **Chunked admission** (``prefill_chunk_tokens``): a miss batch prefills
  into its own dense cache one program per ``step``, the vision tower first,
  then the prompt ``prefill_chunk_tokens`` tokens at a time, so an arrival
  stalls the decode ticks by one chunk, not a whole prefill.
- **Decode tick** (``decode_impl`` "kernel", the default): the decoder reads
  the pool through the tables (``ops/attention.py::paged_attention``, the
  paged decode kernel on the card) and returns each slot's new K/V row, which
  one scatter writes at ``(tables[slot, len // page], len % page)``.
  "gathered" gathers each slot's window and runs the dense-cache decode step
  (the plain program). The tick is the W = 1 case of a window forward that
  the speculative server (``serving/speculative_paged.py``) runs at W = k + 1.

The pools are updated in place (the JAX server donates its buffers to the
jitted programs instead). ``image_prep`` letterboxes raw frames inside
admission, the image chunk included, as on the dense server
(``serving/continuous_batching.py``); the prefix-cache keys hash the raw
frames. LoRA (``lora=``, single or multi-LoRA with
``submit(lora_index=...)``) as on the dense server: admission, chunks,
partial-hit tails and ticks get each row's adapter, and the adapter index
keys both prefix-cache layers (the whole-prompt key and the page chain),
so a hit never crosses adapters. ``mesh``: as on the dense server, the
pools split over KV heads (pool axis 2) with the model's heads; under a
mesh ``decode_impl`` "auto" is "gathered" and "kernel" raises, as in JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.fastvlm import FastVLM
from ..models.qwen2 import Qwen2Config, init_kv_cache
from ..parallel.sharding import rank_text_config, shard_params
from ..utils import tracing
from .continuous_batching import (
    _pad_to,
    admission_arrays,
    batch_lora,
    device_images,
    normalize_buckets,
    normalize_lora,
    pick_bucket,
    resolve_lora_index,
    slots_lora,
)
from .sampling import sample_tokens


@dataclasses.dataclass
class _Slot:
    request_id: int = -1
    active: bool = False
    # Slot assigned to a queued (not yet prefilled) request: holds its page
    # reservation but must not decode until admission.
    claimed: bool = False
    tokens: List[int] = dataclasses.field(default_factory=list)
    remaining: int = 0
    length: int = 0  # write cursor in the logical window
    lora_index: int = 0  # internal stacked-adapter index (0 = base)


@dataclasses.dataclass
class _Pending:
    request_id: int
    slot: int
    input_ids: np.ndarray  # (1, bucket)
    attention_mask: np.ndarray  # (1, bucket)
    images: Optional[np.ndarray]  # (1, 3, S, S), raw frames under image_prep | None
    bucket: int = 0
    key: Optional[bytes] = None  # whole-prompt cache key (None: caching off)
    # One chain hash per full prompt page: hash i commits to the adapter,
    # the frame and every prompt token through position (i + 1) * page_size.
    page_hashes: Optional[List[bytes]] = None
    lora_index: int = 0  # internal stacked-adapter index (0 = base)


@dataclasses.dataclass
class _Inflight:
    """A chunked admission in progress: the batch prefills into its own
    dense cache, one program per ``step``; at the last chunk its rows
    scatter into the pages and the slots activate."""

    batch: List[_Pending]
    bucket: int
    ids: np.ndarray  # (n, bucket) host, n = len(batch)
    mask: np.ndarray  # (n, bucket) host
    images: Optional[np.ndarray]  # (n, ...) host | None
    cache: dict  # dense (n, max_len) cache the chunks fill
    last_logits: torch.Tensor  # (n, V) running last-real-position logits
    images_done: bool  # image chunk run (or none needed)
    lora: Optional[dict] = None  # the batch's adapter argument
    chunk_idx: int = 0  # next text chunk


def _program_span(batch: List[_Pending]):
    """The span of one admission program over ``batch``: a prefill, one
    chunk of a chunked one, or partial hits' tails."""
    if not tracing.on():
        return tracing.span("serve.admit.program")
    return tracing.span("serve.admit.program", bucket=batch[0].bucket, rows=len(batch),
                        requests=[req.request_id for req in batch])


def _count_prefill(batch: List[_Pending], n_img: int, width: int, skipped: int = 0) -> None:
    """Admission counters of one prefill of ``batch`` of ``width`` positions
    a row (image tokens + bucket), the first ``skipped`` of each taken from
    the prefix cache: its real rows and positions (image and real prompt
    tokens), and the rows and positions it computes. Every caller (miss,
    chunked miss, partial-hit tails) runs on the batch's rows alone, so the
    bucket's prompt padding is all it computes that is not real. The dense
    server and the speculative draft, which pad rows, count nothing."""
    if not tracing.on():
        return
    rows = len(batch)
    tracing.count("serve.admit.rows", rows)
    tracing.count("serve.admit.rows_computed", rows)
    tracing.count("serve.admit.positions", sum(n_img + int(req.attention_mask.sum()) - skipped for req in batch))
    tracing.count("serve.admit.positions_computed", rows * (width - skipped))


class PagedKVPool:
    """Host-managed page allocator over device-resident K/V pools."""

    def __init__(self, cfg: Qwen2Config, num_pages: int, page_size: int, num_slots: int, max_len: int,
                 dtype: Optional[torch.dtype] = None, device=None) -> None:
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of page_size {page_size}")
        self.page_size = page_size
        self.num_pages = num_pages
        self.pages_per_slot = max_len // page_size
        self.max_len = max_len
        shape = (cfg.num_hidden_layers, num_pages, cfg.num_key_value_heads, page_size, cfg.resolved_head_dim)
        dtype = dtype or cfg.dtype
        self.quantized = cfg.kv_cache_quantization == "int8"
        if self.quantized:
            dtype = torch.int8
            # Per-(kv-head, page-position) scales: the dense int8 cache's
            # k_scale/v_scale in pool layout.
            self.pool_k_scale = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
            self.pool_v_scale = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        else:
            self.pool_k_scale = self.pool_v_scale = None
        self.pool_k = torch.zeros(shape, dtype=dtype, device=device)
        self.pool_v = torch.zeros(shape, dtype=dtype, device=device)
        # Page 0 = trash: never allocated, absorbs the writes of inactive tick rows and of shared tail entries.
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refcount = np.zeros(num_pages, np.int64)
        # Host page tables; 0 (trash) marks unallocated entries.
        self.page_table = np.zeros((num_slots, self.pages_per_slot), np.int32)
        # Worst-case page reservations per slot: pages are allocated lazily,
        # but a slot is only admitted when its maximum growth is covered.
        self._reserved = np.zeros(num_slots, np.int64)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def _outstanding(self) -> int:
        held = np.count_nonzero(self.page_table, axis=1)
        return int(np.maximum(self._reserved - held, 0).sum())

    def can_reserve(self, tokens: int) -> bool:
        return self.pages_needed(tokens) <= self.free_pages - self._outstanding()

    def reserve(self, slot: int, tokens: int) -> None:
        """Admission control: claim worst-case pages for ``slot``."""
        need = self.pages_needed(tokens)
        if need > self.pages_per_slot:
            raise ValueError(f"request needs {need} pages > pages_per_slot {self.pages_per_slot}")
        if not self.can_reserve(tokens):
            raise RuntimeError(
                f"paged KV pool cannot admit a {need}-page request ({self.free_pages} free, "
                f"{self._outstanding()} reserved); wait for active requests to finish"
            )
        self._reserved[slot] = need

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def allocate(self, slot: int, tokens: int) -> None:
        """Ensure ``slot`` has pages covering ``tokens`` logical positions."""
        have = int(np.count_nonzero(self.page_table[slot]))
        need = self.pages_needed(tokens)
        if need > self.pages_per_slot:
            raise ValueError(f"request needs {need} pages > pages_per_slot {self.pages_per_slot}")
        for i in range(have, need):
            if not self._free:
                raise RuntimeError("paged KV pool exhausted")
            page = self._free.pop()
            self._refcount[page] = 1
            self.page_table[slot, i] = page

    def add_ref(self, page: int) -> None:
        """Take an extra reference on an allocated page."""
        if page <= 0 or self._refcount[page] <= 0:
            raise ValueError(f"cannot add_ref unallocated page {page}")
        self._refcount[page] += 1

    def install(self, slot: int, index: int, page: int) -> None:
        """Point ``slot``'s table entry ``index`` at a shared ``page`` (takes a reference)."""
        self.add_ref(page)
        self.page_table[slot, index] = page

    def release_page(self, page: int) -> None:
        """Drop one reference; the page frees at refcount 0."""
        page = int(page)
        if page <= 0:
            return
        self._refcount[page] -= 1
        if self._refcount[page] == 0:
            self._free.append(page)
        elif self._refcount[page] < 0:
            raise RuntimeError(f"page {page} over-released")

    def free(self, slot: int) -> None:
        for i in range(self.pages_per_slot):
            self.release_page(int(self.page_table[slot, i]))
        self.page_table[slot] = 0
        self._reserved[slot] = 0

    def copy_page(self, src: int, dst: int) -> None:
        """Copy one physical page across every pool buffer, int8 scales
        included: the copy-on-write step for a shared partial tail page."""
        for buf in self.pools().values():
            buf[:, dst] = buf[:, src]

    def pools(self) -> dict:
        """Device pools as a dict (k/v + scales when int8)."""
        out = {"k": self.pool_k, "v": self.pool_v}
        if self.quantized:
            out["k_scale"] = self.pool_k_scale
            out["v_scale"] = self.pool_v_scale
        return out


class PagedGenerationServer:
    """Continuous batching over a paged KV pool.

    ``model`` is the port's ``FastVLM``; its parameters carry the weights and
    the device the server runs on (the JAX server's ``params`` argument has
    no counterpart). The other keywords are the JAX server's.
    """

    def __init__(
        self,
        model: FastVLM,
        num_slots: int = 8,
        prompt_len=64,
        max_new_tokens: int = 32,
        eos_token_id: int = 2,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        mesh=None,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
        prefill_batch: int = 4,
        decode_impl: str = "auto",
        prefix_cache_size: int = 0,
        prefill_chunk_tokens: int = 0,
        lora=None,
        cache_slack: int = 0,
        image_prep=None,
    ) -> None:
        """``decode_impl``: "kernel" decodes through the model's paged path
        (the paged-attention kernel on the card, its plain version on the
        CPU); "gathered" gathers each slot's window and runs the dense decode
        step; "auto" is "kernel", or "gathered" under a ``mesh``, where
        "kernel" raises (JAX's rule: its Pallas call is single-chip).

        ``prefix_cache_size``: > 0 caches that many distinct prompts (LRU)
        and as many prompts' worth of full prompt pages (the page layer);
        the default pool grows by both layers' pinned pages, so a full cache
        never cuts admission below ``num_slots``. The first token of a
        whole-prompt hit is sampled from the cached logits under the
        server's generator.

        ``prefill_chunk_tokens``: > 0 admits misses chunk by chunk, one
        chunk of work a ``step`` (``flush`` and ``step_n`` admit fully).
        Every prompt bucket must be a multiple of it."""
        if decode_impl not in ("auto", "kernel", "gathered"):
            raise ValueError(f"unknown decode_impl {decode_impl!r}")
        if decode_impl == "kernel" and mesh is not None:
            raise ValueError("decode_impl='kernel' reads whole pools through one kernel and takes no mesh; "
                             "use decode_impl='gathered' with a TP mesh")
        if decode_impl == "auto":
            decode_impl = "gathered" if mesh is not None else "kernel"
        self.decode_impl = decode_impl
        if mesh is not None:
            shard_params(mesh, model)
        self.mesh = mesh
        self.model = model
        self.image_prep = image_prep
        self.device = next(model.parameters()).device
        self._lora, self._lora_multi, self._num_adapters = normalize_lora(lora, self.device, model.cfg.text.dtype)
        self.num_slots = num_slots
        self.prompt_buckets = normalize_buckets(prompt_len)
        self.prompt_len = self.prompt_buckets[-1]
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.prefill_batch = max(1, min(prefill_batch, num_slots))
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        if self.prefill_chunk_tokens:
            bad = [b for b in self.prompt_buckets if b % self.prefill_chunk_tokens]
            if bad:
                raise ValueError(f"prompt buckets {bad} are not multiples of "
                                 f"prefill_chunk_tokens={self.prefill_chunk_tokens}")
        self._inflight: Optional[_Inflight] = None
        self._pending: List[_Pending] = []
        # Two prefix-cache layers, LRU, pinning pages through the pool's
        # reference counts: whole prompts (key -> pages, last logits, mask,
        # prefill_len) and full prompt pages (chain hash -> page, mask).
        self.prefix_cache_size = int(prefix_cache_size)
        caching = self.prefix_cache_size > 0
        self._prefix_cache: Optional[OrderedDict] = OrderedDict() if caching else None
        self._page_cache: Optional[OrderedDict] = OrderedDict() if caching else None
        self.prefix_cache_hits = 0
        self.prefix_cache_partial_hits = 0
        self.prefix_cache_misses = 0

        cfg = model.cfg
        # cache_slack: extra logical positions past image + prompt + new tokens.
        self._growth_slack = int(cache_slack)
        logical = cfg.num_image_tokens + self.prompt_len + max_new_tokens + self._growth_slack
        page_count = -(-logical // page_size)
        self._max_len = page_count * page_size
        prompt_pages = max(-(-(cfg.num_image_tokens + self.prompt_len) // page_size), 1)
        if num_pages is None:
            # Every slot at max length, plus the trash page.
            num_pages = num_slots * page_count + 1
            if caching:
                # Headroom for the pages both cache layers pin (they evict
                # independently, so each may hold its own budget).
                num_pages += 2 * self.prefix_cache_size * prompt_pages
        self._page_cache_capacity = self.prefix_cache_size * prompt_pages
        self.pool = PagedKVPool(rank_text_config(model), num_pages, page_size, num_slots, self._max_len,
                                device=self.device)
        self._slots = [_Slot() for _ in range(num_slots)]
        self._next_rid = 0
        # Fixed by the first request and checked at submit, never mid-admit.
        self._multimodal: Optional[bool] = None
        self._pending_token = np.full(num_slots, eos_token_id, np.int32)
        # Host mirror of each slot's valid-position mask.
        self._slot_mask = np.zeros((num_slots, self._max_len), bool)
        self._finished: Dict[int, List[int]] = {}
        # Programs run so far: whole-prompt admission prefills, image chunks
        # (each a vision-tower pass, like a multimodal admission), text
        # chunks (of chunked admissions and of partial-hit tails) and decode
        # ticks.
        self.admissions = 0
        self.image_chunks = 0
        self.text_chunks = 0
        self.ticks = 0

    # ------------------------------------------------------------------

    def has_free_slot(self) -> bool:
        """A slot is free AND the pool can cover a worst-case request."""
        if not any(not s.active and not s.claimed for s in self._slots):
            return False
        worst = self.model.cfg.num_image_tokens + self.prompt_len + self.max_new_tokens + self._growth_slack
        return self.pool.can_reserve(worst)

    @property
    def num_active(self) -> int:
        inflight = len(self._inflight.batch) if self._inflight else 0
        return sum(s.active for s in self._slots) + len(self._pending) + inflight

    def submit(self, input_ids: np.ndarray, attention_mask: np.ndarray, images: Optional[np.ndarray] = None,
               lora_index: Optional[int] = None) -> int:
        """Queue a request: a slot and its worst-case pages are claimed now;
        the prefill runs batched at the next ``step``/``flush``.
        ``lora_index`` picks the request's adapter on a multi-LoRA server
        (None: the base); it keys the prefix cache too."""
        lidx = resolve_lora_index(self._lora_multi, self._num_adapters, lora_index)
        is_mm = images is not None
        if self._multimodal is None:
            self._multimodal = is_mm
        elif is_mm != self._multimodal:
            raise ValueError("all requests in a server must be consistently multimodal or text-only")
        ids = np.atleast_2d(np.asarray(input_ids, np.int32))
        mask = np.atleast_2d(np.asarray(attention_mask, np.int32))
        bucket = pick_bucket(self.prompt_buckets, ids.shape[1])
        ids, mask = _pad_to(ids, mask, bucket)
        free = [i for i, s in enumerate(self._slots) if not s.active and not s.claimed]
        if not free:
            raise RuntimeError("no free generation slots")
        slot_idx = free[0]
        prefill_len = self.model.cfg.num_image_tokens + bucket
        self.pool.reserve(slot_idx, prefill_len + self.max_new_tokens + self._growth_slack)
        self._slots[slot_idx].claimed = True
        rid = self._next_rid
        self._next_rid += 1
        key = page_hashes = None
        if self._prefix_cache is not None:
            key, page_hashes = self._prompt_hashes(ids, mask, images, lidx)
        self._pending.append(_Pending(rid, slot_idx, ids, mask, images, bucket, key, page_hashes, lidx))
        return rid

    def _prompt_hashes(self, ids: np.ndarray, mask: np.ndarray, images: Optional[np.ndarray], lora_index: int = 0):
        """The whole-prompt key and the page chain hashes of a request.

        The adapter index and the frame are hashed once (shape and raw
        bytes); both hashes branch from that state, so requests under two
        adapters never share a cached prompt or page (their K/V differ). The key adds the bucket and the padded ids and
        mask. Chain hash ``i`` adds the page index and the prompt tokens and
        mask of the positions in full page ``i``: the K/V rows of a page
        depend on the frame, their positions and every token up to the
        page's end (causal attention), so pages are shared exactly when
        their chains match. The page index keeps apart the pages that hold
        only image rows (``num_image_tokens`` > ``page_size``), which add no
        token; the JAX server's chain leaves it out, so its image-only pages
        share one hash and a partial hit there installs the first image
        page in every image page's place. The bucket is left out of the
        chain: text position j sits at slot n_img + j and RoPE counts true
        lengths, so a short and a long bucket share pages.
        """
        frame = hashlib.sha1()
        frame.update(np.int64(lora_index).tobytes())
        if images is not None:
            img = np.ascontiguousarray(images)
            frame.update(np.asarray(img.shape, np.int64).tobytes())
            frame.update(img)
        whole = frame.copy()
        whole.update(np.int64(ids.shape[1]).tobytes())
        whole.update(ids.tobytes())
        whole.update(mask.tobytes())
        ps, n_img, bucket = self.pool.page_size, self.model.cfg.num_image_tokens, ids.shape[1]
        hashes = []
        for i in range((n_img + bucket) // ps):
            lo, hi = max(i * ps - n_img, 0), min((i + 1) * ps - n_img, bucket)
            frame.update(np.int64(i).tobytes())
            if hi > lo:
                frame.update(np.ascontiguousarray(ids[0, lo:hi]).tobytes())
                frame.update(np.ascontiguousarray(mask[0, lo:hi]).tobytes())
            hashes.append(frame.digest())
        return whole.digest(), hashes

    def _to_device(self, array) -> torch.Tensor:
        """A device copy of a host array (never a view of it: the host
        arrays change between ticks)."""
        return torch.tensor(np.asarray(array)).to(self.device)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_tokens(logits, self._generator, self.temperature, self.top_p)

    # ------------------------------------------------------------------
    # admission

    def _take_hits(self) -> bool:
        """Admit every pending whole-prompt hit; True when there was one."""
        if self._prefix_cache is None:
            return False
        hits = [p for p in self._pending if p.key in self._prefix_cache]
        self._pending = [p for p in self._pending if p.key not in self._prefix_cache]
        for req in hits:
            self._admit_from_cache(req)
        return bool(hits)

    def _take_partials(self) -> bool:
        """Admit every pending page-level partial hit, each with the match
        length it had before any of them was admitted; True when there was
        one. The tails prefill in programs of up to ``prefill_batch`` rows
        that share a match length and a bucket (the JAX server runs one
        program a hit); the cache layers then record them in arrival order,
        as if admitted one at a time."""
        if self._page_cache is None:
            return False
        partial = [(p, m) for p in self._pending if (m := self._longest_page_prefix(p)) > 0]
        taken = {id(p) for p, _ in partial}
        self._pending = [p for p in self._pending if id(p) not in taken]
        groups: Dict[tuple, List[_Pending]] = {}
        for req, m in partial:
            groups.setdefault((m, req.bucket), []).append(req)
        prefilled = {}
        for (m, _), reqs in groups.items():
            for i in range(0, len(reqs), self.prefill_batch):
                batch = reqs[i: i + self.prefill_batch]
                with _program_span(batch):
                    prefilled.update(self._prefill_tails(batch, m))
        for req, m in partial:
            self.prefix_cache_partial_hits += 1
            for h in req.page_hashes[:m]:
                if h in self._page_cache:
                    self._page_cache.move_to_end(h)
            token, mask_row, logits = prefilled[id(req)]
            prefill_len = self.model.cfg.num_image_tokens + req.bucket
            self._activate(req, token, prefill_len, mask_row)
            # The tail completes this prompt: both layers record it.
            self._cache_insert(req, prefill_len, logits)
            self._register_pages(req)
            self._finish_if_done(req.slot)
        return bool(partial)

    def _next_batch(self) -> List[_Pending]:
        """Take up to ``prefill_batch`` queued requests of the oldest one's bucket."""
        bucket = self._pending[0].bucket
        batch = [p for p in self._pending if p.bucket == bucket][: self.prefill_batch]
        taken = {id(p) for p in batch}
        self._pending = [p for p in self._pending if id(p) not in taken]
        return batch

    def flush(self) -> None:
        """Admit queued requests: prefix-cache hits with no prefill, partial
        hits by their tails, misses ``prefill_batch`` per prefill, grouped by
        prompt bucket. Hits are looked up again after every miss batch, so a
        prompt submitted twice in one flush prefills once. Under chunked
        admission this drains pending and in-flight work to the end."""
        if self.prefill_chunk_tokens:
            while self._pending or self._inflight is not None:
                self._admission_work()
            return
        while self._pending:
            if not (self._take_hits() or self._take_partials()):
                batch = self._next_batch()
                with _program_span(batch):
                    self._admit(batch)

    def _admit_pending(self) -> None:
        """A ``step``'s admission: one chunk of work under chunked admission,
        else every queued request."""
        if self.prefill_chunk_tokens:
            self._admission_work()
        else:
            self.flush()

    def _activate(self, req: _Pending, token: int, prefill_len: int, mask_row: np.ndarray) -> None:
        slot = self._slots[req.slot]
        slot.request_id = req.request_id
        slot.claimed = False
        slot.active = True
        slot.tokens = [token]
        slot.remaining = self.max_new_tokens - 1
        slot.length = prefill_len
        slot.lora_index = req.lora_index
        self._slot_mask[req.slot] = mask_row
        self._pending_token[req.slot] = token

    def _register_misses(self, batch: List[_Pending], tokens_host, masks_host, last_logits, prefill_len: int):
        """Activate a prefilled miss batch's slots and record each prompt in
        both cache layers (before a slot that is done frees its pages)."""
        for row, req in enumerate(batch):
            self._activate(req, int(tokens_host[row]), prefill_len, masks_host[row])
            if self._prefix_cache is not None:
                self.prefix_cache_misses += 1
                self._cache_insert(req, prefill_len, last_logits[row].clone())
                self._register_pages(req)
            self._finish_if_done(req.slot)

    @torch.no_grad()
    def _admit(self, batch: List[_Pending]) -> None:
        """Prefill a miss batch of one bucket on its own rows: the frames,
        the tower, the dense cache, the prefill, the first tokens and the
        scatter are all ``len(batch)`` rows."""
        n = len(batch)
        # Logical prefill width: image tokens + padded prompt (the cursor
        # advances by the padded width; see models/fastvlm.py::prefill).
        prefill_len = self.model.cfg.num_image_tokens + batch[0].bucket
        _count_prefill(batch, self.model.cfg.num_image_tokens, prefill_len)
        ids, mask, images = admission_arrays(batch, n, self.eos_token_id)
        for req in batch:
            self.pool.allocate(req.slot, prefill_len + 1)
        pages = self.pool.page_table[[req.slot for req in batch]]  # fancy indexing: a copy

        model = self.model
        images = device_images(self, images)
        with tracing.span("serve.admit.upload"):
            ids, mask = self._to_device(ids), self._to_device(mask)
        with tracing.span("serve.admit.prefill"):
            cache = init_kv_cache(rank_text_config(model), n, self._max_len, device=self.device)
            last_logits, _, cache, _, _ = model.prefill(images, ids, mask, cache, lora=batch_lora(self, batch, n))
            tokens = self._sample(last_logits)
        with tracing.span("serve.admit.scatter"):
            self._scatter_prefill(cache, self._to_device(pages).long())
        self.admissions += 1
        with tracing.span("serve.admit.fetch"):
            tokens, masks = tokens.cpu().numpy(), cache["mask"].cpu().numpy()
        self._register_misses(batch, tokens, masks, last_logits, prefill_len)

    def _scatter_prefill(self, cache: dict, pages: torch.Tensor) -> None:
        """Write the prefilled (L, n, max_len, K[, D]) rows into ``pages``
        (n, pages_per_slot); entries that are 0 write the trash page."""
        pool = self.pool
        n_layers, n = cache["k"].shape[:2]

        def paged(buf):  # -> (L, n, P_slot, K, page[, D]) pool layout
            split = buf.reshape((n_layers, n, pool.pages_per_slot, pool.page_size) + tuple(buf.shape[3:]))
            return split.permute(0, 1, 2, 4, 3, 5) if buf.ndim == 5 else split.permute(0, 1, 2, 4, 3)

        for name, buf in pool.pools().items():
            buf[:, pages] = paged(cache[name]).to(buf.dtype)

    def _gather_windows(self, tables: torch.Tensor) -> dict:
        """Each row's pages gathered into dense (L, B, max_len, K[, D])
        windows, one per pool buffer (the trash page where a table is 0)."""
        n_layers, b, tab = self.pool.pool_k.shape[0], tables.shape[0], tables.long()

        def gather(buf):  # (L, P, K, page[, D]) -> (L, B, S, K[, D])
            g = buf[:, tab]  # (L, B, P_slot, K, page[, D])
            g = g.permute(0, 1, 2, 4, 3, 5) if buf.ndim == 5 else g.permute(0, 1, 2, 4, 3)
            return g.reshape((n_layers, b, self._max_len) + tuple(buf.shape[2:3] + buf.shape[4:]))

        return {name: gather(buf) for name, buf in self.pool.pools().items()}

    def _text_chunk(self, ids: np.ndarray, mask: np.ndarray, cache: dict, last: torch.Tensor, lora=None):
        """One prompt chunk through ``prefill_text_chunk`` -> (running
        last-real-position logits, cache). A row with real tokens in the
        chunk takes its last one's logits; a row already past its prompt
        keeps the earlier chunk's (prompts are right-padded)."""
        mask_d = self._to_device(mask)
        logits, cache = self.model.prefill_text_chunk(self._to_device(ids), mask_d, cache, lora=lora)
        self.text_chunks += 1
        has = mask_d.bool().any(dim=1)
        idx = (torch.arange(mask_d.shape[1], device=mask_d.device) * mask_d).amax(dim=1)  # last real position
        chunk_last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
        return torch.where(has[:, None], chunk_last, last), cache

    def _admission_work(self) -> None:
        """One unit of chunked admission work: start a miss batch or run its
        next chunk, the image chunk first; finalize at the last one. Whole
        and partial hits admit at once (their tails are short by
        construction, so pacing them buys nothing)."""
        inf = self._inflight
        if inf is None:
            self._take_hits()
            if self._pending:
                self._take_partials()
            if not self._pending:
                return
            inf = self._inflight = self._start_inflight(self._next_batch())
        with _program_span(inf.batch):
            if not inf.images_done:
                images = device_images(self, inf.images)
                with tracing.span("serve.admit.prefill"):
                    inf.cache = self.model.prefill_image_chunk(images, inf.cache, lora=inf.lora)
                self.image_chunks += 1
                inf.images_done = True
                return
            c = self.prefill_chunk_tokens
            lo = inf.chunk_idx * c
            with tracing.span("serve.admit.prefill"):
                inf.last_logits, inf.cache = self._text_chunk(inf.ids[:, lo: lo + c], inf.mask[:, lo: lo + c],
                                                              inf.cache, inf.last_logits, inf.lora)
            inf.chunk_idx += 1
            if inf.chunk_idx * c >= inf.bucket:
                self._inflight = None
                self._finalize_inflight(inf)

    def _start_inflight(self, batch: List[_Pending]) -> _Inflight:
        """Host set-up of a chunked miss batch, on its own rows as in
        ``_admit``: its arrays, its pages allocated up front, a fresh dense
        cache and zero running logits."""
        cfg = self.model.cfg
        n = len(batch)
        _count_prefill(batch, cfg.num_image_tokens, cfg.num_image_tokens + batch[0].bucket)
        ids, mask, images = admission_arrays(batch, n, self.eos_token_id)
        for req in batch:
            self.pool.allocate(req.slot, cfg.num_image_tokens + batch[0].bucket + 1)
        return _Inflight(
            batch=batch, bucket=batch[0].bucket, ids=ids, mask=mask, images=images,
            cache=init_kv_cache(rank_text_config(self.model), n, self._max_len, device=self.device),
            last_logits=torch.zeros((n, cfg.text.vocab_size), dtype=cfg.text.dtype, device=self.device),
            images_done=images is None or cfg.num_image_tokens == 0,
            lora=batch_lora(self, batch, n),
        )

    @torch.no_grad()
    def _finalize_inflight(self, inf: _Inflight) -> None:
        """The last chunk landed: scatter the chunk cache into the pages,
        sample each first token from the running logits, activate."""
        pages = self.pool.page_table[[req.slot for req in inf.batch]]  # fancy indexing: a copy
        with tracing.span("serve.admit.scatter"):
            self._scatter_prefill(inf.cache, self._to_device(pages).long())
        tokens = self._sample(inf.last_logits)
        with tracing.span("serve.admit.fetch"):
            tokens, masks = tokens.cpu().numpy(), inf.cache["mask"].cpu().numpy()
        self._register_misses(inf.batch, tokens, masks, inf.last_logits, self.model.cfg.num_image_tokens + inf.bucket)

    def _cache_insert(self, req: _Pending, prefill_len: int, logits: torch.Tensor) -> None:
        """Record ``req``'s prompt pages and last-position logits. The entry
        holds its own page references, so it outlives the request: prompt
        rows are write-once (the owner writes only positions >= prefill_len,
        inside the tail page a hit copies)."""
        cache = self._prefix_cache
        if req.key is None or req.key in cache:
            return
        pages = [int(p) for p in self.pool.page_table[req.slot, : self.pool.pages_needed(prefill_len)]]
        for p in pages:
            self.pool.add_ref(p)
        cache[req.key] = {"pages": pages, "logits": logits, "mask": self._slot_mask[req.slot].copy(),
                          "prefill_len": prefill_len}
        while len(cache) > self.prefix_cache_size:
            _, evicted = cache.popitem(last=False)
            for p in evicted["pages"]:
                self.pool.release_page(p)

    @torch.no_grad()
    def _admit_from_cache(self, req: _Pending) -> None:
        """Admit a whole-prompt hit with no prefill: the full prompt pages by
        reference; the tail page, which this slot's decode writes, copied to
        a private page (copy-on-write); the first token sampled from the
        cached logits."""
        entry = self._prefix_cache[req.key]
        self._prefix_cache.move_to_end(req.key)
        self.prefix_cache_hits += 1
        prefill_len = entry["prefill_len"]
        n_full, partial = divmod(prefill_len, self.pool.page_size)
        for i in range(n_full):
            self.pool.install(req.slot, i, entry["pages"][i])
        # One fresh page: the private tail copy, or the first decode page.
        self.pool.allocate(req.slot, prefill_len + 1)
        if partial:
            self.pool.copy_page(entry["pages"][n_full], int(self.pool.page_table[req.slot, n_full]))
        token = int(self._sample(entry["logits"][None])[0])
        self._activate(req, token, prefill_len, entry["mask"])
        # The page layer evicts on its own: refresh this prompt's pages there.
        self._register_pages(req)
        self._finish_if_done(req.slot)

    def _register_pages(self, req: _Pending) -> None:
        """Record ``req``'s full prompt pages in the page layer, one pinned
        page per chain hash; evicted entries release their page."""
        cache = self._page_cache
        if cache is None or not req.page_hashes:
            return
        ps = self.pool.page_size
        for i, h in enumerate(req.page_hashes):
            if h in cache:
                cache.move_to_end(h)
                continue
            page = int(self.pool.page_table[req.slot, i])
            if page <= 0:
                break
            self.pool.add_ref(page)
            cache[h] = {"page": page, "mask": self._slot_mask[req.slot, i * ps: (i + 1) * ps].copy()}
        while len(cache) > self._page_cache_capacity:
            _, evicted = cache.popitem(last=False)
            self.pool.release_page(evicted["page"])

    def _longest_page_prefix(self, req: _Pending) -> int:
        """Leading full prompt pages of ``req`` in the page layer; 0 when a
        partial hit cannot help (nothing cached, the match ends inside the
        image, or nothing would be left to prefill)."""
        if self._page_cache is None or not req.page_hashes:
            return 0
        ps, n_img = self.pool.page_size, self.model.cfg.num_image_tokens
        m = 0
        for h in req.page_hashes:
            if h not in self._page_cache:
                break
            m += 1
        # Keep the last real prompt token in the tail: it gives the first
        # token's logits. Capping by the padded bucket alone (as the JAX
        # server does) lets a short prompt that a longer cached one extends
        # match through its last real page and prefill only padding.
        m = min(m, (n_img + int(req.attention_mask.sum()) - 1) // ps)
        # Text chunks cannot continue a match that stops inside the image.
        return 0 if m * ps < n_img else m

    @torch.no_grad()
    def _prefill_tails(self, batch: List[_Pending], m: int) -> dict:
        """Prefill the tails of partial hits that share the match length
        ``m`` and a bucket, one row each: install the ``m`` shared pages by
        reference, then page-size text chunks against the gathered shared
        rows; the tails scatter into the slots' own pages, the shared
        entries into the trash page. The match covers the image, so the
        vision tower does not run. Returns ``{id(req): (first token, mask
        row, last-position logits)}``."""
        ps, n_img, bucket = self.pool.page_size, self.model.cfg.num_image_tokens, batch[0].bucket
        n = len(batch)
        _count_prefill(batch, n_img, n_img + bucket, skipped=m * ps)
        shared = np.zeros((n, self.pool.pages_per_slot), np.int32)
        mask_host = np.zeros((n, self._max_len), bool)
        for row, req in enumerate(batch):
            entries = [self._page_cache[h] for h in req.page_hashes[:m]]
            for i, entry in enumerate(entries):
                self.pool.install(req.slot, i, entry["page"])
            self.pool.allocate(req.slot, n_img + bucket + 1)
            shared[row, :m] = self.pool.page_table[req.slot, :m]
            mask_host[row, : m * ps] = np.concatenate([e["mask"] for e in entries])
        with tracing.span("serve.admit.upload"):
            shared, mask_host = self._to_device(shared), self._to_device(mask_host)
        ids = np.concatenate([req.input_ids for req in batch])
        mask = np.concatenate([req.attention_mask for req in batch])
        text = self.model.cfg.text
        with tracing.span("serve.admit.prefill"):
            cache = dict(self._gather_windows(shared), mask=mask_host,
                         index=torch.full((n,), m * ps, dtype=torch.int32, device=self.device))
            last = torch.zeros((n, text.vocab_size), dtype=text.dtype, device=self.device)
            lora = batch_lora(self, batch, n)
            for off in range(m * ps - n_img, bucket, ps):
                last, cache = self._text_chunk(ids[:, off: off + ps], mask[:, off: off + ps], cache, last, lora)
            tokens = self._sample(last)

        pages = self.pool.page_table[[req.slot for req in batch]]  # fancy indexing: a copy
        pages[:, :m] = 0
        with tracing.span("serve.admit.scatter"):
            self._scatter_prefill(cache, self._to_device(pages).long())
        with tracing.span("serve.admit.fetch"):
            tokens, masks = tokens.cpu().numpy(), cache["mask"].cpu().numpy()
        return {id(req): (int(tokens[row]), masks[row], last[row].clone()) for row, req in enumerate(batch)}

    def _finish_if_done(self, slot_idx: int) -> None:
        slot = self._slots[slot_idx]
        if not slot.active:
            return
        if slot.remaining > 0 and slot.tokens[-1] != self.eos_token_id:
            return
        slot.active = False
        self._pending_token[slot_idx] = self.eos_token_id
        self._finished[slot.request_id] = list(slot.tokens)
        self.pool.free(slot_idx)
        self._slot_mask[slot_idx] = False
        slot.length = 0

    def evict_prefix_cache(self) -> None:
        """Drop every entry of both prefix-cache layers, releasing their pages."""
        for cache, pages_of in ((self._prefix_cache, lambda e: e["pages"]), (self._page_cache, lambda e: [e["page"]])):
            while cache:
                for p in pages_of(cache.popitem(last=False)[1]):
                    self.pool.release_page(p)

    def pinned_pages(self) -> set:
        """Distinct pages the prefix-cache layers hold."""
        if self._prefix_cache is None:
            return set()
        return ({p for e in self._prefix_cache.values() for p in e["pages"]}
                | {e["page"] for e in self._page_cache.values()})

    # ------------------------------------------------------------------
    # decode ticks

    def _tick_inputs(self):
        """Device (tables, masks, lengths, tokens) of a tick over all slots.

        Inactive slots decode token ``max(eos_token_id, 0)`` against the
        trash page with length 1 and a one-hot mask; their outputs are
        dropped and their rows land in the trash page.
        """
        active = np.array([s.active for s in self._slots])
        lengths = np.array([s.length if s.active else 1 for s in self._slots], np.int32)
        tokens = np.where(active, self._pending_token, max(self.eos_token_id, 0)).astype(np.int32)
        masks = self._slot_mask.copy()
        masks[~active] = False
        masks[~active, 0] = True
        return (self._to_device(self.pool.page_table), self._to_device(masks), self._to_device(lengths),
                self._to_device(tokens))

    def _run_window(self, impl: str, tables, masks, lengths, window, write: bool = True, lora=None) -> torch.Tensor:
        """One forward of a (B, W) token window over all slots -> (B, W, V)
        logits; window position i sits at ``lengths + i``. With ``write``
        the window's K/V rows are scattered into the slots' pages there.
        ``lora``: the adapter argument of the B rows.

        "kernel" reads the pool through the tables (``verify_step_paged``:
        the paged decode kernel at W = 1, the window kernel at W > 1 on the
        card); "gathered" gathers each slot's window into a dense cache and
        runs ``verify_step`` (the plain program)."""
        pool, model = self.pool, self.model
        b, w = window.shape
        dev = tables.device
        cols = lengths.long()[:, None] + torch.arange(w, device=dev)[None, :]  # (B, W)
        if impl == "kernel":
            cache = {"pool_k": pool.pool_k, "pool_v": pool.pool_v, "tables": tables, "mask": masks,
                     "index": lengths}
            if pool.quantized:
                cache.update(pool_k_scale=pool.pool_k_scale, pool_v_scale=pool.pool_v_scale)
            logits, rows = model.verify_step_paged(window, cache, lora=lora)
            new = {"k": rows["k_rows"], "v": rows["v_rows"]}
            if pool.quantized:
                new.update(k_scale=rows["k_scale_rows"], v_scale=rows["v_scale_rows"])
            if w == 1:  # the decoder squeezes a decode tick's window axis
                new = {name: r[:, :, None] for name, r in new.items()}
        else:
            cache = dict(self._gather_windows(tables), mask=masks, index=lengths)
            logits, new_cache = model.verify_step(window, cache, lora=lora)
            rows_b = torch.arange(b, device=dev)[:, None]
            new = {name: new_cache[name][:, rows_b, cols] for name in pool.pools()}  # (L, B, W, ...)
        if write:
            page_ids = tables.long()[torch.arange(b, device=dev)[:, None], cols // pool.page_size]
            offsets = cols % pool.page_size
            # Pool layout (L, P, K, page[, D]): the advanced indices at axes 1
            # and 3 put the (B, W) axes first, (B, W, L, K[, D]).
            for name, buf in pool.pools().items():
                buf[:, page_ids, :, offsets] = new[name].movedim(0, 2).to(buf.dtype)
        return logits

    def _run_tick(self, impl: str, tables, masks, lengths, tokens, write: bool = True, lora=None) -> torch.Tensor:
        """One decode step over all slots -> (B, V) logits. With ``write``
        each slot's new K/V row is scattered into its page at its cursor."""
        return self._run_window(impl, tables, masks, lengths, tokens[:, None], write, lora)[:, 0]

    @torch.no_grad()
    def tick_logits(self, impl: Optional[str] = None) -> torch.Tensor:
        """(num_slots, V) logits of one decode tick over the current state by
        ``impl`` ("kernel" or "gathered", default the server's), without
        writing the pools or advancing a slot: for holding one tick program
        against the other on the same state."""
        return self._run_tick(impl or self.decode_impl, *self._tick_inputs(), write=False,
                              lora=slots_lora(self, self.num_slots))

    @torch.no_grad()
    def step(self) -> Dict[int, List[int]]:
        """Admit pending requests (one chunk of work under chunked
        admission), then one decode tick across all slots."""
        if self._pending or self._inflight is not None:
            with tracing.span("serve.admit"):
                self._admit_pending()
        if any(s.active for s in self._slots):
            with tracing.span("serve.tick"):
                self._decode_tick()
        finished = self._finished
        self._finished = {}
        return finished

    def _decode_tick(self) -> None:
        """One decode tick across all slots: each active slot appends its
        sampled token."""
        with tracing.span("serve.tick.inputs"):
            for i, slot in enumerate(self._slots):
                if slot.active:
                    # Page for the K/V this tick writes at position length.
                    self.pool.allocate(i, slot.length + 1)
            inputs, lora = self._tick_inputs(), slots_lora(self, self.num_slots)
        with tracing.span("serve.tick.forward"):
            tokens = self._sample(self._run_tick(self.decode_impl, *inputs, lora=lora))
            self.ticks += 1
        with tracing.span("serve.tick.fetch"):
            next_host = tokens.cpu().numpy()
        with tracing.span("serve.tick.bookkeep"):
            for i, slot in enumerate(self._slots):
                if not slot.active:
                    continue
                token = int(next_host[i])
                slot.tokens.append(token)
                slot.remaining -= 1
                # The tick wrote this slot's new K/V at position length.
                self._slot_mask[i, slot.length] = True
                slot.length += 1
                self._pending_token[i] = token
                self._finish_if_done(i)

    @torch.no_grad()
    def step_n(self, n: int) -> Dict[int, List[int]]:
        """Admit pending requests fully (chunk pacing has nothing to
        interleave with here), then up to ``n`` decode ticks on the device
        with one host fetch at the end (``eos_token_id`` must be < 0 for
        n > 1: the ticks cannot stop at EOS in between)."""
        self.flush()
        active = [i for i, s in enumerate(self._slots) if s.active]
        if active:
            n_eff = min(int(n), min(self._slots[i].remaining for i in active))
            if n_eff <= 1:
                return self.step()
            if self.eos_token_id >= 0:
                raise ValueError("step_n with n > 1 requires eos_token_id < 0 (the ticks cannot stop at "
                                 "EOS in between)")
            for i in active:
                self.pool.allocate(i, self._slots[i].length + n_eff)
            tables, masks, lengths, tokens = self._tick_inputs()
            rows = torch.arange(self.num_slots, device=self.device)
            lora = slots_lora(self, self.num_slots)
            toks = []
            for _ in range(n_eff):
                logits = self._run_tick(self.decode_impl, tables, masks, lengths, tokens, lora=lora)
                self.ticks += 1
                tokens = self._sample(logits)
                masks[rows, lengths.long()] = True
                lengths = lengths + 1
                toks.append(tokens)
            toks_host = torch.stack(toks, dim=1).cpu().numpy()  # (B, n_eff): one fetch
            for i in active:
                slot = self._slots[i]
                slot.tokens.extend(int(t) for t in toks_host[i])
                slot.remaining -= n_eff
                self._slot_mask[i, slot.length: slot.length + n_eff] = True
                slot.length += n_eff
                self._pending_token[i] = int(toks_host[i, -1])
                self._finish_if_done(i)
        finished = self._finished
        self._finished = {}
        return finished

    def run_to_completion(self, max_ticks: Optional[int] = None) -> Dict[int, List[int]]:
        """Drain all active slots; ``max_ticks`` bounds decode ticks exactly."""
        outputs: Dict[int, List[int]] = {}
        ticks = 0
        while self.num_active and (max_ticks is None or ticks < max_ticks):
            outputs.update(self.step())
            ticks += 1
        return outputs
