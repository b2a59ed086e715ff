"""Speculative decoding over the paged continuous-batching server
(counterpart of ``vla_fastvlm_tpu/serving/speculative_paged.py``).

Paged KV (device memory scales with allocated tokens, ``serving/paged_kv.py``)
and draft-verify decode ticks (each pass over the target's weights pays for
``accepted + 1`` tokens, ``serving/speculative.py``) in one server. A tick:

- the draft, on its own small dense cache (at FastVLM-0.5B-draft /
  7B-target shapes the draft cache is a few percent of the target pool, so
  paging it buys nothing), runs ``k + 1`` decode steps;
- the target verifies the ``[last, d_1 .. d_k]`` window against the page
  pool, which it only reads (``FastVLM.verify_step_paged``: the W = k + 1
  window kernel on the card under ``decode_impl`` "kernel"; "gathered"
  gathers each slot's window and runs the dense ``verify_step``, the plain
  program);
- the window's ``k + 1`` K/V rows are scattered into each slot's pages at
  positions ``length .. length + k``;
- acceptance (greedy prefix match or rejection sampling) picks ``a``; the
  host rolls the rejected suffix back by advancing its slot masks and
  lengths only ``a + 1`` positions. The rejected rows stay in the pages,
  masked, and the next window overwrites them at the same positions, so
  the target side needs no rewind on the device.

The pool-side arrays carry one dead lane after the slots, matching the
draft cache's trash row that dummy admission rows land in. Admission prefills
both models: the target through the parent's paged admission, the draft
through a dense batched prefill and a slot insert, after every kind of
target admission: a miss batch, a whole-prompt prefix hit, a program of
page-level partial hits (the target prefills only the tails; the draft,
with no page sharing, prefills the whole prompts) and a chunked batch's finalize. Under
chunked admission the draft's prefill runs whole at finalize: chunking
bounds the target's admission stall, and the draft's prefill is the cheap
side. ``cache_slack`` is ``k + 1``: reservations and the logical window
cover one whole window past the accepted length. ``step_n`` raises.
LoRA (the parent's ``lora=`` and ``submit(lora_index=...)``) mounts on the
target's admission and verify only; the draft stays the base
(``serving/speculative.py``).

At ``temperature == 0`` the tokens are the target's greedy tokens, the same
as the plain ``PagedGenerationServer`` on the target alone (bf16 caveat in
``serving/speculative.py``); at ``temperature > 0`` they follow the
target's sampling distribution.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models.fastvlm import FastVLM
from ..models.qwen2 import init_kv_cache
from .continuous_batching import admission_arrays, device_images, make_slot_insert, slots_lora
from .paged_kv import PagedGenerationServer, _Pending
from .speculative import _accept, _draft_propose, _emit, _rewind, validate_draft_pair


@torch.no_grad()
def _paged_speculative_round(verify, draft: FastVLM, draft_cache: dict, token: torch.Tensor,
                             active: torch.Tensor, generator, *, k: int, temperature: float = 0.0,
                             top_p: float = 1.0):
    """One draft-verify round against the page pool.

    ``verify`` maps the (B, k + 1) window to the target's (B, k + 1, V)
    logits and scatters the window's K/V rows into the pool. Returns
    ``(packed (B, k + 2), draft_cache)``: the emitted tokens and the per-row
    counts in one int32 tensor (one host fetch). The pool holds the whole
    window per slot; the host masks validity to the accepted prefix.
    """
    dtoks, dlogits, draft_cache = _draft_propose(draft, draft_cache, token, generator, k=k,
                                                 temperature=temperature, top_p=top_p)
    window = torch.cat([token[:, None], dtoks], dim=1)  # (B, k + 1)
    tlogits = verify(window)
    a, correction = _accept(dtoks, dlogits, tlogits, generator, temperature=temperature, top_p=top_p)
    # Draft rollback (dense cache): keep the accepted inputs, clamp dead
    # lanes away from the buffer end.
    return _emit(dtoks, a, correction, active, k), _rewind(draft_cache, a, active, k)


class SpeculativePagedGenerationServer(PagedGenerationServer):
    """Paged continuous batching with speculative decode ticks.

    The ``PagedGenerationServer`` surface (prompt buckets, admission control,
    prefix caching, chunked admission, ``decode_impl``) with a decode tick
    that is one draft-verify round, emitting ``accepted_i + 1`` in
    ``[1, k + 1]`` tokens per active slot.
    ``model`` is the target and ``draft`` the draft; both hold their weights
    and must live on one device. ``paged_kwargs`` are the parent's.
    """

    def __init__(self, model: FastVLM, draft: FastVLM, *, k: int = 4, **paged_kwargs) -> None:
        validate_draft_pair(model, draft, k)
        self.k = int(k)
        # Ticks write a k + 1 window at the slot cursor before the host rolls
        # the rejected suffix back; reservations and the window carry it.
        paged_kwargs["cache_slack"] = self.k + 1
        super().__init__(model, **paged_kwargs)
        self.draft = draft
        dcfg = draft.cfg
        self._draft_cache_len = dcfg.num_image_tokens + self.prompt_len + self.max_new_tokens + self.k + 1
        # num_slots + 1 rows: the last is the draft's trash row (dummy
        # admission rows land there; the round pads a matching dead lane).
        self.draft_cache = init_kv_cache(dcfg.text, self.num_slots + 1, self._draft_cache_len, device=self.device)
        self._draft_insert = make_slot_insert(self.prefill_batch)
        self.spec_tokens_emitted = 0
        self.spec_ticks = 0
        self.spec_slot_rounds = 0  # active slots summed over rounds
        self.draft_admissions = 0  # draft prefills (each runs the draft's vision tower)

    @property
    def tokens_per_tick(self) -> float:
        return self.spec_tokens_emitted / self.spec_ticks if self.spec_ticks else 0.0

    @property
    def tokens_per_slot_round(self) -> float:
        """Tokens an active slot emits a round: 1.0 when every proposal is
        rejected, k + 1 when every one is accepted (``tokens_per_tick``
        sums over the slots)."""
        return self.spec_tokens_emitted / self.spec_slot_rounds if self.spec_slot_rounds else 0.0

    def step_n(self, n: int):
        raise NotImplementedError(
            "speculative servers amortize decode through draft-verify rounds; use step() (step_n's plain "
            "multi-tick decode would desync the draft cache)"
        )

    # -- draft-side admission --------------------------------------------

    @torch.no_grad()
    def _draft_admit(self, batch: List[_Pending]) -> None:
        """Prefill the draft on an admitted batch and insert it per slot,
        after the target's admission, so the draft cache mirrors the prompts
        the target holds (raw frames through the same ``image_prep``)."""
        ids, mask, images = admission_arrays(batch, self.prefill_batch, self.eos_token_id)
        slots = np.full(self.prefill_batch, self.num_slots, np.int32)  # dummy rows: the trash row
        slots[: len(batch)] = [req.slot for req in batch]
        cache_p = init_kv_cache(self.draft.cfg.text, self.prefill_batch, self._draft_cache_len, device=self.device)
        _, _, cache_p, _, _ = self.draft.prefill(
            device_images(self, images), self._to_device(ids), self._to_device(mask), cache_p,
        )
        self.draft_cache = self._draft_insert(self.draft_cache, cache_p, self._to_device(slots))
        self.draft_admissions += 1

    def _admit(self, batch: List[_Pending]) -> None:
        super()._admit(batch)
        self._draft_admit(batch)

    def _admit_from_cache(self, req: _Pending) -> None:
        super()._admit_from_cache(req)
        self._draft_admit([req])

    def _prefill_tails(self, batch: List[_Pending], m: int) -> dict:
        prefilled = super()._prefill_tails(batch, m)
        self._draft_admit(batch)
        return prefilled

    def _finalize_inflight(self, inf) -> None:
        super()._finalize_inflight(inf)
        self._draft_admit(inf.batch)

    # -- the speculative tick ----------------------------------------------

    def _round_inputs(self):
        """Device (tables, masks, lengths, token, active) of a round over the
        slots plus the dead lane. Inactive slots ride with all-trash tables,
        length 1 and a one-hot mask, as in the plain paged tick."""
        n = self.num_slots
        lengths = np.ones(n + 1, np.int32)
        masks = np.zeros((n + 1, self._max_len), bool)
        tables = np.zeros((n + 1, self.pool.pages_per_slot), np.int32)
        active = np.zeros(n + 1, bool)
        token = np.full(n + 1, max(self.eos_token_id, 0), np.int32)
        for i, slot in enumerate(self._slots):
            if slot.active:
                lengths[i] = slot.length
                masks[i] = self._slot_mask[i]
                tables[i] = self.pool.page_table[i]
                active[i] = True
                token[i] = self._pending_token[i]
        masks[~active, 0] = True
        return tuple(self._to_device(a) for a in (tables, masks, lengths, token, active))

    @torch.no_grad()
    def verify_logits(self, impl=None) -> torch.Tensor:
        """(num_slots + 1, k + 1, V) target logits of the next round's verify
        by ``impl`` ("kernel" or "gathered", default the server's), without
        writing the pools or advancing a slot or the draft: for holding one
        verify program against the other on the same state. The draft's
        proposals only scribble its cache past the cursors, which the next
        round overwrites before reading."""
        tables, masks, lengths, token, _ = self._round_inputs()
        dtoks, _, _ = _draft_propose(self.draft, self.draft_cache, token, self._generator, k=self.k,
                                     temperature=0.0, top_p=1.0)
        window = torch.cat([token[:, None], dtoks], dim=1)
        return self._run_window(impl or self.decode_impl, tables, masks, lengths, window, write=False,
                                lora=slots_lora(self, self.num_slots + 1))

    @torch.no_grad()
    def step(self):
        """Admit pending requests (one chunk of work under chunked
        admission), then one draft-verify round across all slots; returns
        finished outputs."""
        self._admit_pending()
        if any(s.active for s in self._slots):
            k = self.k
            for i, slot in enumerate(self._slots):
                if slot.active:
                    # Pages for the window this tick writes at length .. length + k.
                    self.pool.allocate(i, slot.length + k + 1)
            tables, masks, lengths, token, active = self._round_inputs()
            lora = slots_lora(self, self.num_slots + 1)
            verify = lambda window: self._run_window(self.decode_impl, tables, masks, lengths, window, lora=lora)
            packed, self.draft_cache = _paged_speculative_round(
                verify, self.draft, self.draft_cache, token, active, self._generator, k=k,
                temperature=self.temperature, top_p=self.top_p,
            )
            packed_h = packed.cpu().numpy()  # one fetch a tick
            self.spec_ticks += 1
            self.spec_slot_rounds += sum(s.active for s in self._slots)
            for i, slot in enumerate(self._slots):
                if not slot.active:
                    continue
                count = int(packed_h[i, k + 1])
                for j in range(count):
                    tok = int(packed_h[i, j])
                    slot.tokens.append(tok)
                    slot.remaining -= 1
                    self.spec_tokens_emitted += 1
                    if tok == self.eos_token_id or slot.remaining <= 0:
                        break
                self._pending_token[i] = slot.tokens[-1]
                if slot.remaining > 0 and slot.tokens[-1] != self.eos_token_id:
                    # Host-side rollback: only the accepted inputs
                    # [last, d_1 .. d_a] (count rows) become valid; the
                    # rejected tail stays masked until the next window
                    # overwrites it.
                    self._slot_mask[i, slot.length: slot.length + count] = True
                    slot.length += count
                self._finish_if_done(i)
        finished = self._finished
        self._finished = {}
        return finished
