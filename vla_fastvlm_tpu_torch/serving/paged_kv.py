"""Paged KV cache and the continuous-batching server over it (counterpart of
``vla_fastvlm_tpu/serving/paged_kv.py``).

K/V live in a shared pool of fixed-size pages and each slot has a page
table, so device memory scales with allocated tokens, not slots x max_len:

- **Pool**: ``(L, num_pages, K, page_size, D)`` per K/V (kv-head major).
  Physical page 0 is the trash page: unallocated table entries point at it,
  dummy and inactive rows write there, and the kv mask keeps attention from
  reading it.
- **Page tables**: host-side ``(num_slots, pages_per_slot)`` int32, shipped
  to the device per tick. Allocation is host bookkeeping: a free list,
  reference counts and worst-case reservations (admission control), so a
  mid-decode allocation never fails.
- **Admission**: requests queue at ``submit``; ``step``/``flush`` prefill
  them ``prefill_batch`` at a time into a dense cache, then scatter the rows
  into their pages.
- **Decode tick** (``decode_impl`` "kernel", the default): the decoder reads
  the pool through the tables (``ops/attention.py::paged_attention``, the
  paged decode kernel on the card) and returns each slot's new K/V row, which
  one scatter writes at ``(tables[slot, len // page], len % page)``.
  "gathered" gathers each slot's window and runs the dense-cache decode step
  (the plain program). The tick is the W = 1 case of a window forward that
  the speculative server (``serving/speculative_paged.py``) runs at W = k + 1.

The pools are updated in place (the JAX server donates its buffers to the
jitted programs instead). ``image_prep`` letterboxes raw frames inside
admission, as on the dense server (``serving/continuous_batching.py``). Not
in this port yet: prefix caching, chunked prefill, LoRA and a TP mesh; each
raises ``NotImplementedError`` when set.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.fastvlm import FastVLM
from ..models.qwen2 import Qwen2Config, init_kv_cache
from .continuous_batching import _pad_to, admission_arrays, device_images, normalize_buckets, pick_bucket
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


@dataclasses.dataclass
class _Pending:
    request_id: int
    slot: int
    input_ids: np.ndarray  # (1, bucket)
    attention_mask: np.ndarray  # (1, bucket)
    images: Optional[np.ndarray]  # (1, 3, S, S), raw frames under image_prep | None
    bucket: int = 0


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
        # Page 0 = trash: never allocated, absorbs writes from dummy rows.
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
        step; "auto" is "kernel"."""
        unported = {
            "mesh": mesh is not None, "prefix_cache_size": prefix_cache_size > 0,
            "prefill_chunk_tokens": prefill_chunk_tokens > 0, "lora": lora is not None,
        }
        named = [k for k, on in unported.items() if on]
        if named:
            raise NotImplementedError(f"{', '.join(named)}: not ported to the PyTorch paged server yet")
        if decode_impl not in ("auto", "kernel", "gathered"):
            raise ValueError(f"unknown decode_impl {decode_impl!r}")
        self.decode_impl = "kernel" if decode_impl == "auto" else decode_impl
        self.model = model
        self.image_prep = image_prep
        self.device = next(model.parameters()).device
        self.num_slots = num_slots
        self.prompt_buckets = normalize_buckets(prompt_len)
        self.prompt_len = self.prompt_buckets[-1]
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.prefill_batch = max(1, min(prefill_batch, num_slots))
        self._pending: List[_Pending] = []

        cfg = model.cfg
        # cache_slack: extra logical positions past image + prompt + new tokens.
        self._growth_slack = int(cache_slack)
        logical = cfg.num_image_tokens + self.prompt_len + max_new_tokens + self._growth_slack
        page_count = -(-logical // page_size)
        self._max_len = page_count * page_size
        if num_pages is None:
            # Every slot at max length, plus the trash page.
            num_pages = num_slots * page_count + 1
        self.pool = PagedKVPool(cfg.text, num_pages, page_size, num_slots, self._max_len, device=self.device)
        self._slots = [_Slot() for _ in range(num_slots)]
        self._next_rid = 0
        # Fixed by the first request and checked at submit, never mid-admit.
        self._multimodal: Optional[bool] = None
        self._pending_token = np.full(num_slots, eos_token_id, np.int32)
        # Host mirror of each slot's valid-position mask.
        self._slot_mask = np.zeros((num_slots, self._max_len), bool)
        self._finished: Dict[int, List[int]] = {}
        # Programs run so far: admission prefills and decode ticks.
        self.admissions = 0
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
        return sum(s.active for s in self._slots) + len(self._pending)

    def submit(self, input_ids: np.ndarray, attention_mask: np.ndarray, images: Optional[np.ndarray] = None,
               lora_index: Optional[int] = None) -> int:
        """Queue a request: a slot and its worst-case pages are claimed now;
        the prefill runs batched at the next ``step``/``flush``."""
        if lora_index is not None:
            raise NotImplementedError("lora_index: LoRA is not ported to the PyTorch paged server yet")
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
        self._pending.append(_Pending(rid, slot_idx, ids, mask, images, bucket))
        return rid

    def flush(self) -> None:
        """Admit queued requests, ``prefill_batch`` per prefill, grouped by prompt bucket."""
        while self._pending:
            bucket = self._pending[0].bucket
            batch = [p for p in self._pending if p.bucket == bucket][: self.prefill_batch]
            taken = {id(p) for p in batch}
            self._pending = [p for p in self._pending if id(p) not in taken]
            self._admit(batch)

    def _to_device(self, array) -> torch.Tensor:
        """A device copy of a host array (never a view of it: the host
        arrays change between ticks)."""
        return torch.tensor(np.asarray(array)).to(self.device)

    @torch.no_grad()
    def _admit(self, batch: List[_Pending]) -> None:
        bp = self.prefill_batch
        # Logical prefill width: image tokens + padded prompt (the cursor
        # advances by the padded width; see models/fastvlm.py::prefill).
        prefill_len = self.model.cfg.num_image_tokens + batch[0].bucket
        ids, mask, images = admission_arrays(batch, bp, self.eos_token_id)
        pages = np.zeros((bp, self.pool.pages_per_slot), np.int32)
        for row, req in enumerate(batch):
            self.pool.allocate(req.slot, prefill_len + 1)
            pages[row] = self.pool.page_table[req.slot]

        model = self.model
        cache = init_kv_cache(model.cfg.text, bp, self._max_len, device=self.device)
        last_logits, _, cache, _, _ = model.prefill(
            device_images(self, images), self._to_device(ids), self._to_device(mask), cache,
        )
        tokens = sample_tokens(last_logits, self._generator, self.temperature, self.top_p)
        self._scatter_prefill(cache, self._to_device(pages).long())
        self.admissions += 1
        tokens_host = tokens.cpu().numpy()
        masks_host = cache["mask"].cpu().numpy()

        for row, req in enumerate(batch):
            slot = self._slots[req.slot]
            slot.request_id = req.request_id
            slot.claimed = False
            slot.active = True
            slot.tokens = [int(tokens_host[row])]
            slot.remaining = self.max_new_tokens - 1
            slot.length = prefill_len
            self._slot_mask[req.slot] = masks_host[row]
            self._pending_token[req.slot] = int(tokens_host[row])
            self._finish_if_done(req.slot)

    def _scatter_prefill(self, cache: dict, pages: torch.Tensor) -> None:
        """Write the prefilled (L, bp, max_len, K[, D]) rows into ``pages``
        (bp, pages_per_slot); dummy rows' pages are all the trash page."""
        pool = self.pool
        n_layers, bp = cache["k"].shape[:2]

        def paged(buf):  # -> (L, bp, P_slot, K, page[, D]) pool layout
            split = buf.reshape((n_layers, bp, pool.pages_per_slot, pool.page_size) + tuple(buf.shape[3:]))
            return split.permute(0, 1, 2, 4, 3, 5) if buf.ndim == 5 else split.permute(0, 1, 2, 4, 3)

        for name, buf in pool.pools().items():
            buf[:, pages] = paged(cache[name]).to(buf.dtype)

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

    def _run_window(self, impl: str, tables, masks, lengths, window, write: bool = True) -> torch.Tensor:
        """One forward of a (B, W) token window over all slots -> (B, W, V)
        logits; window position i sits at ``lengths + i``. With ``write``
        the window's K/V rows are scattered into the slots' pages there.

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
            logits, rows = model.verify_step_paged(window, cache)
            new = {"k": rows["k_rows"], "v": rows["v_rows"]}
            if pool.quantized:
                new.update(k_scale=rows["k_scale_rows"], v_scale=rows["v_scale_rows"])
            if w == 1:  # the decoder squeezes a decode tick's window axis
                new = {name: r[:, :, None] for name, r in new.items()}
        else:
            n_layers = pool.pool_k.shape[0]
            tab = tables.long()

            def gather_window(buf):  # (L, P, K, page[, D]) -> (L, B, S, K[, D])
                g = buf[:, tab]  # (L, B, P_slot, K, page[, D])
                g = g.permute(0, 1, 2, 4, 3, 5) if buf.ndim == 5 else g.permute(0, 1, 2, 4, 3)
                return g.reshape((n_layers, b, self._max_len) + tuple(buf.shape[2:3] + buf.shape[4:]))

            cache = {"mask": masks, "index": lengths}
            for name, buf in pool.pools().items():
                cache[name] = gather_window(buf)
            logits, new_cache = model.verify_step(window, cache)
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

    def _run_tick(self, impl: str, tables, masks, lengths, tokens, write: bool = True) -> torch.Tensor:
        """One decode step over all slots -> (B, V) logits. With ``write``
        each slot's new K/V row is scattered into its page at its cursor."""
        return self._run_window(impl, tables, masks, lengths, tokens[:, None], write)[:, 0]

    @torch.no_grad()
    def tick_logits(self, impl: Optional[str] = None) -> torch.Tensor:
        """(num_slots, V) logits of one decode tick over the current state by
        ``impl`` ("kernel" or "gathered", default the server's), without
        writing the pools or advancing a slot: for holding one tick program
        against the other on the same state."""
        return self._run_tick(impl or self.decode_impl, *self._tick_inputs(), write=False)

    @torch.no_grad()
    def step(self) -> Dict[int, List[int]]:
        """Admit pending requests, then one decode tick across all slots."""
        self.flush()
        if any(s.active for s in self._slots):
            for i, slot in enumerate(self._slots):
                if slot.active:
                    # Page for the K/V this tick writes at position length.
                    self.pool.allocate(i, slot.length + 1)
            logits = self._run_tick(self.decode_impl, *self._tick_inputs())
            self.ticks += 1
            next_host = sample_tokens(logits, self._generator, self.temperature, self.top_p).cpu().numpy()
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
        finished = self._finished
        self._finished = {}
        return finished

    @torch.no_grad()
    def step_n(self, n: int) -> Dict[int, List[int]]:
        """Admit pending requests, then up to ``n`` decode ticks on the device
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
            toks = []
            for _ in range(n_eff):
                logits = self._run_tick(self.decode_impl, tables, masks, lengths, tokens)
                self.ticks += 1
                tokens = sample_tokens(logits, self._generator, self.temperature, self.top_p)
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
