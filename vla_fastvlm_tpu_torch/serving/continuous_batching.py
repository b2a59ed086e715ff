"""Continuous-batching generation server over a dense KV cache (counterpart
of ``vla_fastvlm_tpu/serving/continuous_batching.py``).

Requests are admitted any time while decode ticks run across all slots:

- **Batched admission**: ``submit`` only queues; pending requests are
  prefilled ``prefill_batch`` at a time at the next ``step``/``flush``, short
  batches padded with dummy rows that keep one real token.
- **Slot insert**: ``make_slot_insert`` writes each prefilled row into its
  slot of the server cache, in place (the JAX server donates its buffers to
  a jitted insert instead).
- **Trash slot**: the cache carries one extra slot that dummy admission rows
  land in; it rides the decode ticks and is never read back.

Finished slots ride the batch too and their cursors run on; the decoder
clamps their writes at the buffer end (``models/qwen2.py``) and the next
admission overwrites the whole slot row. The prompt-bucket helpers
(``normalize_buckets``, ``pick_bucket``, ``_pad_to``) are shared with the
paged server.

``image_prep`` (every server of the port takes it): a function applied on
the device to each admission batch's images before the prefill, e.g.
``model/fastvlm_adapter.prepare_policy_images`` (letterbox + normalize to
the tower resolution). Callers then submit raw frames of any one size, and
only those cross from the host; a padded batch's dummy rows are zero frames
of that size (the paged server's admissions have none).

``lora`` (every server of the port takes it): adapters (``io/lora.py``)
served over the frozen base. One tree applies to every request; a LIST of
trees is multi-LoRA: they are stacked behind an all-zeros base adapter,
``submit(lora_index=i)`` routes a request to adapter ``i`` (None: the
base), and every program gets each row's adapter index (``batch_lora`` at
admission, ``slots_lora`` in the ticks). The server keeps the adapters on
its device in the model's compute dtype.

``mesh`` (every server of the port takes it): a ("data", "model") mesh
(``parallel/mesh.py``). The model's decoder is placed on it in place
(``parallel/sharding.py::shard_params``): each rank holds its share of the
heads, its cache (or page pools) only its KV heads, and the logits come
whole to every rank, so every rank runs the same host loop and takes the
same decisions (admission order, pages, prefix-cache hits, acceptance,
sampling draws from a generator seeded alike). Adapters and a speculative
draft stay replicated. The ``data`` axis replicates the server: use
``make_mesh(data=1, model=N)``, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..io.lora import lora_with_ids, map_lora, stack_loras
from ..models.fastvlm import FastVLM
from ..models.qwen2 import init_kv_cache
from ..parallel.sharding import rank_text_config, shard_params
from ..utils import tracing
from .sampling import sample_tokens


@dataclasses.dataclass
class _Slot:
    request_id: int = -1
    active: bool = False
    tokens: List[int] = dataclasses.field(default_factory=list)
    remaining: int = 0
    lora_index: int = 0  # internal stacked-adapter index (0 = base)


@dataclasses.dataclass
class _Pending:
    request_id: int
    input_ids: np.ndarray  # (1, bucket)
    attention_mask: np.ndarray  # (1, bucket)
    images: Optional[np.ndarray]  # (1, 3, S, S), raw frames under image_prep | None
    bucket: int = 0  # prompt width this request was padded to
    lora_index: int = 0  # internal stacked-adapter index (0 = base)


def normalize_lora(lora, device=None, dtype=None):
    """Server ``lora=`` argument -> ``(tree, multi, num_adapters)``: None; a
    single adapter tree, applied to every request; or a list of trees
    (multi-LoRA), stacked behind an all-zeros base adapter at index 0. The
    tree comes back on ``device`` in ``dtype`` (the decoder's compute
    dtype, so no call casts it again)."""
    if lora is None:
        return None, False, 0
    multi = isinstance(lora, (list, tuple))
    tree = stack_loras(lora, include_base=True) if multi else lora
    tree = map_lora(lambda t: t.detach().to(device=device, dtype=dtype), tree)
    return tree, multi, len(lora) if multi else 1


def lora_call_arg(server, indices, rows: int):
    """A program's adapter argument on ``server``: None, its single tree, or
    its stacked tree with the ``rows`` rows' adapter indices mounted (the
    first ``len(indices)`` given, the rest the base)."""
    if not server._lora_multi:
        return server._lora
    ids = np.zeros(rows, np.int64)
    ids[: len(indices)] = indices
    return lora_with_ids(server._lora, ids)


def batch_lora(server, batch, rows: int):
    """The adapter argument of an admission program of ``rows`` rows over
    ``batch`` (dummy rows past it, where a server pads: the base)."""
    return lora_call_arg(server, [req.lora_index for req in batch], rows)


def slots_lora(server, rows: int):
    """The adapter argument of a tick over the server's slots (free slots and
    the lanes past them: the base)."""
    return lora_call_arg(server, [s.lora_index if s.active else 0 for s in server._slots], rows)


def resolve_lora_index(multi: bool, num_adapters: int, lora_index) -> int:
    """``submit(lora_index=...)`` -> the internal stacked index: None is the
    zeros base adapter (0), user adapter ``i`` is ``i + 1``."""
    if lora_index is None:
        return 0
    if not multi:
        raise ValueError("lora_index requires the server to be built with a LIST of adapters (multi-LoRA); a "
                         "single adapter applies to all requests")
    idx = int(lora_index)
    if not 0 <= idx < num_adapters:
        raise ValueError(f"lora_index {idx} out of range for {num_adapters} adapters")
    return idx + 1


def normalize_buckets(prompt_len) -> tuple:
    """``prompt_len`` int or sequence -> sorted tuple of prompt widths.

    Requests pad to the smallest bucket at least their width and admission
    batches per bucket.
    """
    if isinstance(prompt_len, (int, np.integer)):
        buckets = (int(prompt_len),)
    else:
        buckets = tuple(sorted({int(p) for p in prompt_len}))
    if not buckets or buckets[0] <= 0:
        raise ValueError(f"invalid prompt_len buckets {buckets}")
    return buckets


def pick_bucket(buckets, width: int) -> int:
    for b in buckets:
        if width <= b:
            return b
    raise ValueError(f"prompt width {width} exceeds the largest compiled bucket {buckets[-1]}")


def make_slot_insert(bp: int):
    """``insert(cache, cache_p, slots)``: write admission row ``r`` of the
    prefilled ``cache_p`` into slot ``slots[r]`` of the server cache, for
    every buffer: (L, B, S, ...) k/v (+ scales), (B, S) mask, (B,) index.
    Writes in place and returns the cache. Dummy rows all name the trash
    slot, which takes one of them. Shared by the dense server, the
    speculative server's draft cache and the paged speculative server's
    draft cache."""

    def insert(cache: dict, cache_p: dict, slots: torch.Tensor) -> dict:
        if slots.shape != (bp,):
            raise ValueError(f"slots must be ({bp},), got {tuple(slots.shape)}")
        idx = slots.long()
        for name, buf in cache.items():
            new = cache_p[name].to(buf.dtype)
            if buf.ndim >= 4:
                buf[:, idx] = new
            else:
                buf[idx] = new
        return cache

    return insert


def admission_arrays(batch, rows: int, eos_token_id: int):
    """Host ``(ids, mask, images)`` of an admission batch of queued requests
    (``input_ids``, ``attention_mask``, ``images``, ``bucket``) on ``rows``
    rows. The dense server and the speculative servers' draft admission
    pass ``prefill_batch`` (their fixed-row slot insert sends the dummy
    rows past the batch to a trash row; each keeps one real token, so
    last-position indexing is in bounds, and a zero frame); the paged
    server's miss programs pass ``len(batch)`` and get no dummy rows."""
    n, width = len(batch), batch[0].bucket
    ids = np.zeros((rows, width), np.int32)
    mask = np.zeros((rows, width), np.int32)
    ids[n:, 0] = max(eos_token_id, 0)
    mask[n:, 0] = 1
    images = None
    if batch[0].images is not None:
        img0 = np.asarray(batch[0].images)
        images = np.zeros((rows,) + img0.shape[1:], img0.dtype)
    for row, req in enumerate(batch):
        ids[row] = req.input_ids[0]
        mask[row] = req.attention_mask[0]
        if images is not None:
            images[row] = req.images[0]
    return ids, mask, images


def device_images(server, images) -> Optional[torch.Tensor]:
    """An admission batch's host images on ``server.device``, through
    ``server.image_prep`` when it is set (raw frames in, tower-size out)."""
    if images is None:
        return None
    with tracing.span("serve.admit.upload"):
        images = server._to_device(images)
    return images if server.image_prep is None else server.image_prep(images)


def _pad_to(ids: np.ndarray, mask: np.ndarray, bucket: int):
    pad = bucket - ids.shape[1]
    if pad == 0:
        return ids, mask
    return np.pad(ids, ((0, 0), (0, pad))), np.pad(mask, ((0, 0), (0, pad)))


class GenerationServer:
    """Admit requests any time; tick decode across all occupied slots.

    ``model`` is the port's ``FastVLM``; its parameters carry the weights and
    the device the server runs on (the JAX server's ``params`` argument has
    no counterpart). The other keywords are the JAX server's; ``cache_slack``
    adds cache positions past image + prompt + new tokens (the speculative
    subclass writes a ``k + 1`` window before rolling back).
    ``admissions`` counts the admission prefills run so far.
    """

    def __init__(
        self,
        model: FastVLM,
        num_slots: int = 8,
        prompt_len=64,
        max_new_tokens: int = 32,
        eos_token_id: int = 2,
        prefill_batch: int = 4,
        mesh=None,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
        lora=None,
        cache_slack: int = 0,
        image_prep=None,
    ) -> None:
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
        self.prefill_batch = max(1, min(prefill_batch, num_slots))
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

        cfg = model.cfg
        self._cache_len = cfg.num_image_tokens + self.prompt_len + max_new_tokens + int(cache_slack)
        # +1 trash slot: dummy admission rows land there (never read back).
        self.cache = init_kv_cache(rank_text_config(model), num_slots + 1, self._cache_len, device=self.device)
        self._insert = make_slot_insert(self.prefill_batch)
        self._slots = [_Slot() for _ in range(num_slots)]
        self._pending: List[_Pending] = []
        self._next_rid = 0
        self._pending_token = np.full(num_slots + 1, eos_token_id, np.int32)
        self._finished_buffer: Dict[int, List[int]] = {}
        # Fixed by the first request and checked at submit, never mid-admit.
        self._multimodal: Optional[bool] = None
        self.admissions = 0

    # ------------------------------------------------------------------

    def has_free_slot(self) -> bool:
        return self._free_slot_count() > 0

    def _free_slot_count(self) -> int:
        return sum(not s.active for s in self._slots) - len(self._pending)

    @property
    def num_active(self) -> int:
        return sum(s.active for s in self._slots) + len(self._pending)

    def submit(self, input_ids: np.ndarray, attention_mask: np.ndarray, images: Optional[np.ndarray] = None,
               lora_index: Optional[int] = None) -> int:
        """Queue a request for admission; returns a request id. It pads to
        the smallest covering prompt bucket; the prefill runs batched per
        bucket at the next ``step``/``flush``. ``lora_index`` picks the
        request's adapter on a multi-LoRA server (None: the base)."""
        lidx = resolve_lora_index(self._lora_multi, self._num_adapters, lora_index)
        if self._free_slot_count() <= 0:
            raise RuntimeError("no free generation slots")
        is_mm = images is not None
        if self._multimodal is None:
            self._multimodal = is_mm
        elif is_mm != self._multimodal:
            raise ValueError("all requests in a server must be consistently multimodal or text-only")
        ids = np.atleast_2d(np.asarray(input_ids, np.int32))
        mask = np.atleast_2d(np.asarray(attention_mask, np.int32))
        bucket = pick_bucket(self.prompt_buckets, ids.shape[1])
        ids, mask = _pad_to(ids, mask, bucket)
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(_Pending(rid, ids, mask, images, bucket, lidx))
        return rid

    def flush(self) -> None:
        """Admit queued requests, ``prefill_batch`` per prefill, grouped by
        prompt bucket (FIFO by the oldest pending request's bucket)."""
        while self._pending:
            bucket = self._pending[0].bucket
            batch = [p for p in self._pending if p.bucket == bucket][: self.prefill_batch]
            taken = {id(p) for p in batch}
            self._pending = [p for p in self._pending if id(p) not in taken]
            self._admit(batch)

    def _to_device(self, array) -> torch.Tensor:
        """A device copy of a host array (never a view of it)."""
        return torch.tensor(np.asarray(array)).to(self.device)

    def _assemble_admission(self, batch: List[_Pending]):
        """Padded host ``(ids, mask, images, slots)`` of an admission batch;
        ``slots`` maps each row to a free slot, dummy rows to the trash slot."""
        ids, mask, images = admission_arrays(batch, self.prefill_batch, self.eos_token_id)
        slots = np.full(self.prefill_batch, self.num_slots, np.int32)
        free = [i for i, s in enumerate(self._slots) if not s.active]
        slots[: len(batch)] = free[: len(batch)]
        return ids, mask, images, slots

    def _prefill(self, model: FastVLM, cache_len: int, images, ids, mask, lora=None):
        """Batched prefill of ``model`` into a fresh cache of ``cache_len``
        positions -> (last logits (bp, V), cache)."""
        cache_p = init_kv_cache(rank_text_config(model), self.prefill_batch, cache_len, device=self.device)
        last_logits, _, cache_p, _, _ = model.prefill(
            device_images(self, images), self._to_device(ids), self._to_device(mask), cache_p, lora=lora,
        )
        return last_logits, cache_p

    def _register_admitted(self, batch: List[_Pending], slots: np.ndarray, first_host: np.ndarray) -> None:
        """Slot bookkeeping after the prefill ran."""
        self.admissions += 1
        for row, req in enumerate(batch):
            slot_idx = int(slots[row])
            slot = self._slots[slot_idx]
            slot.request_id = req.request_id
            slot.active = True
            slot.tokens = [int(first_host[row])]
            slot.remaining = self.max_new_tokens - 1
            slot.lora_index = req.lora_index
            self._pending_token[slot_idx] = int(first_host[row])
            self._finish_if_done(slot_idx)

    @torch.no_grad()
    def _admit(self, batch: List[_Pending]) -> None:
        ids, mask, images, slots = self._assemble_admission(batch)
        last_logits, cache_p = self._prefill(self.model, self._cache_len, images, ids, mask,
                                             batch_lora(self, batch, self.prefill_batch))
        first = sample_tokens(last_logits, self._generator, self.temperature, self.top_p)
        self.cache = self._insert(self.cache, cache_p, self._to_device(slots))
        self._register_admitted(batch, slots, first.cpu().numpy())

    def _finish_if_done(self, slot_idx: int) -> None:
        slot = self._slots[slot_idx]
        if not slot.active:
            return
        if slot.remaining > 0 and not (slot.tokens and slot.tokens[-1] == self.eos_token_id):
            return
        slot.active = False
        self._pending_token[slot_idx] = self.eos_token_id
        self._finished_buffer[slot.request_id] = list(slot.tokens)

    def _decode(self, tokens: torch.Tensor, lora=None) -> torch.Tensor:
        """One decode step over every slot (trash included) -> sampled (B,)."""
        logits, self.cache = self.model.decode_step(tokens[:, None], self.cache, lora=lora)
        return sample_tokens(logits, self._generator, self.temperature, self.top_p)

    def _device_tokens(self) -> torch.Tensor:
        # Inactive slots ride with the eos token (id 0 when eos < 0).
        return self._to_device(np.maximum(self._pending_token, 0))

    @torch.no_grad()
    def step(self) -> Dict[int, List[int]]:
        """Admit pending requests, then one decode tick across all slots;
        returns finished request outputs (including any that finished at
        admission)."""
        self.flush()
        if any(s.active for s in self._slots):
            next_host = self._decode(self._device_tokens(), slots_lora(self, self.num_slots + 1)).cpu().numpy()
            for i, slot in enumerate(self._slots):
                if not slot.active:
                    continue
                token = int(next_host[i])
                slot.tokens.append(token)
                slot.remaining -= 1
                self._pending_token[i] = token
                self._finish_if_done(i)
        finished = self._finished_buffer
        self._finished_buffer = {}
        return finished

    @torch.no_grad()
    def step_n(self, n: int) -> Dict[int, List[int]]:
        """Admit pending requests, then up to ``n`` decode ticks with one host
        fetch at the end: ``min(n, remaining)`` ticks over the active slots,
        so none overruns its budget. ``eos_token_id`` must be < 0 when more
        than one tick runs (the ticks cannot stop at EOS in between)."""
        self.flush()
        active = [i for i, s in enumerate(self._slots) if s.active]
        if active:
            n_eff = min(int(n), min(self._slots[i].remaining for i in active))
            if n_eff <= 1:
                return self.step()
            if self.eos_token_id >= 0:
                raise ValueError("step_n with n > 1 requires eos_token_id < 0 (the ticks cannot stop at "
                                 "EOS in between)")
            tokens = self._device_tokens()
            lora = slots_lora(self, self.num_slots + 1)
            toks = []
            for _ in range(n_eff):
                tokens = self._decode(tokens, lora)
                toks.append(tokens)
            toks_host = torch.stack(toks, dim=1).cpu().numpy()  # (B, n_eff): one fetch
            for i in active:
                slot = self._slots[i]
                slot.tokens.extend(int(t) for t in toks_host[i])
                slot.remaining -= n_eff
                self._pending_token[i] = int(toks_host[i, -1])
                self._finish_if_done(i)
        finished = self._finished_buffer
        self._finished_buffer = {}
        return finished

    def run_to_completion(self, max_ticks: Optional[int] = None) -> Dict[int, List[int]]:
        """Drain all active slots; ``max_ticks`` bounds decode ticks exactly."""
        outputs: Dict[int, List[int]] = {}
        ticks = 0
        while self.num_active and (max_ticks is None or ticks < max_ticks):
            outputs.update(self.step())
            ticks += 1
        return outputs
