"""Speculative decoding: a small draft model proposes, the target verifies
(counterpart of ``vla_fastvlm_tpu/serving/speculative.py``).

A draft (FastVLM-0.5B against a FastVLM-7B target is the design point)
proposes ``k`` tokens a round; one target forward over the ``k + 1``-token
window verifies them all, so each pass over the target's weights pays for
``accepted + 1`` tokens instead of one.

Two contracts, by sampling mode:

- ``temperature == 0`` (greedy): the emitted tokens are the target's own
  greedy decode. Window position ``i`` attends only the cache and window
  tokens ``<= i`` (``FastVLM.verify_step``), so the target's argmax after each
  accepted prefix is read from one forward. In bf16 the verify window and the
  single-token step are differently shaped programs whose sums run in
  another order, so near-ties of random-weight models can resolve
  differently; in fp32 on the CPU the tokens are the same.
- ``temperature > 0``: rejection-sampling verification
  (``serving/sampling.speculative_accept``): the emitted stream is
  distributed exactly like plain sampling from the target.

One round (``_speculative_round``):

- **draft**: ``k + 1`` single-token decode steps (the last proposal is never
  verified; the extra step keeps the draft cache covering the whole window,
  so a fully accepted round needs no resync);
- **verify**: one ``FastVLM.verify_step`` over ``[last, d_1 .. d_k]``;
- **accept**: greedy takes the leading matches, sampled the rejection rule;
  the round emits ``a + 1`` tokens (the accepted prefix and the correction);
- **rollback**: both caches wrote the whole window; rejected positions are
  masked off and the cursors rewind. Rows that stopped generating clamp
  their cursor to ``cache_len - (k + 1)``, so later rounds' window writes
  stay inside the buffer.

The round returns its emitted tokens and counts in one (B, k + 2) int32
tensor, fetched to the host once per round. The draft runs on the target's
device; a pair split over two devices raises.

LoRA (``lora=`` on the server, single or multi with
``submit(lora_index=...)``) mounts on the TARGET side only, its admission
prefill and its verify: greedy acceptance compares the proposals with the
adapted target's argmax, and rejection sampling needs only the target's
distribution exact, so a base draft moves the acceptance rate, never the
tokens or their distribution.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.fastvlm import FastVLM
from ..models.qwen2 import init_kv_cache
from .continuous_batching import GenerationServer, _Pending, batch_lora, slots_lora
from .generate import build_cache
from .sampling import sample_tokens, speculative_accept


def _device_of(model: FastVLM) -> torch.device:
    return next(model.parameters()).device


def validate_draft_pair(target: FastVLM, draft: FastVLM, k: int) -> None:
    """Shared (target, draft, k) validation for every speculative surface."""
    tv, dv = target.cfg.text.vocab_size, draft.cfg.text.vocab_size
    if tv != dv:
        raise ValueError(f"target/draft vocab mismatch ({tv} vs {dv}): speculative decoding requires a "
                         "shared tokenizer")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    td, dd = _device_of(target), _device_of(draft)
    if td != dd:
        raise ValueError(f"the draft's parameters live on {dd}, the target's on {td}: both must be on one device")


def _rollback(cache: dict, new_index: torch.Tensor) -> dict:
    """Rewind a dense KV cache to per-row cursors ``new_index``.

    Positions at or past the new cursor are masked invalid; their stale K/V
    stay in the buffers (never attended, overwritten by the next writes).
    Prompt-padding holes below the cursor keep their False mask.
    """
    s = cache["mask"].shape[1]
    keep = torch.arange(s, device=new_index.device)[None, :] < new_index[:, None]
    return dict(cache, mask=cache["mask"] & keep, index=new_index.to(torch.int32))


def _draft_propose(draft: FastVLM, draft_cache: dict, token: torch.Tensor, generator, *, k: int,
                   temperature: float, top_p: float):
    """``k + 1`` autoregressive draft steps -> (dtoks (B, k), dlogits, cache).

    ``dlogits`` is ``None`` in greedy mode and the (B, k, V) logits the
    proposals were drawn from under sampling. The ``k + 1``-th proposal is
    never verified: the step only advances the draft cache.
    """
    toks, logits_all = [], []
    tok = token
    for _ in range(k + 1):
        logits, draft_cache = draft.decode_step(tok[:, None], draft_cache)
        tok = sample_tokens(logits, generator, temperature, top_p)
        toks.append(tok)
        logits_all.append(logits)
    dtoks = torch.stack(toks[:k], dim=1)
    dlogits = torch.stack(logits_all[:k], dim=1) if temperature > 0.0 else None
    return dtoks, dlogits, draft_cache


def _accept(dtoks: torch.Tensor, dlogits, tlogits: torch.Tensor, generator, *, temperature: float,
            top_p: float):
    """Acceptance rule -> (a (B,) accepted prefix length, correction (B,))."""
    if temperature > 0.0:
        return speculative_accept(dtoks, dlogits, tlogits, generator, temperature, top_p)
    greedy = tlogits.argmax(dim=-1).to(torch.int32)  # (B, k + 1)
    match = (dtoks == greedy[:, : dtoks.shape[1]]).to(torch.int32)
    a = torch.cumprod(match, dim=1).sum(dim=1)  # (B,) in [0, k]
    correction = torch.gather(greedy, 1, a[:, None].long())[:, 0]
    return a.to(torch.int32), correction


def _emit(dtoks: torch.Tensor, a: torch.Tensor, correction: torch.Tensor, active: torch.Tensor, k: int):
    """Packed (B, k + 2): the accepted draft prefix then the correction, and
    the per-row count (0 for inactive rows) in the last column."""
    idx = torch.arange(k + 1, device=dtoks.device)[None, :]
    padded = torch.cat([dtoks, torch.zeros_like(dtoks[:, :1])], dim=1)
    emitted = torch.where(idx < a[:, None], padded, correction[:, None])
    count = torch.where(active, a + 1, torch.zeros_like(a))
    return torch.cat([emitted, count[:, None]], dim=1).to(torch.int32)


def _rewind(cache: dict, a: torch.Tensor, active: torch.Tensor, k: int) -> dict:
    """Keep the accepted inputs ``[last, d_1 .. d_a]`` of a cache that wrote
    the whole window; inactive rows rewind it all and clamp their cursor to
    ``cache_len - (k + 1)``."""
    adv = torch.where(active, a + 1, torch.zeros_like(a))
    new = cache["index"] - (k + 1) + adv
    s = cache["mask"].shape[1]
    new = torch.where(active, new, new.clamp(max=s - (k + 1)))
    return _rollback(cache, new)


@torch.no_grad()
def _speculative_round(target: FastVLM, draft: FastVLM, target_cache: dict, draft_cache: dict,
                       token: torch.Tensor, active: torch.Tensor, generator, target_lora=None, *, k: int,
                       temperature: float = 0.0, top_p: float = 1.0):
    """One draft-verify round -> (packed (B, k + 2), target_cache,
    draft_cache, next_token). Inactive rows emit nothing (count 0) and their
    caches do not advance. ``target_lora`` mounts on the target's verify
    only (the draft stays the base)."""
    dtoks, dlogits, draft_cache = _draft_propose(draft, draft_cache, token, generator, k=k,
                                                 temperature=temperature, top_p=top_p)
    window = torch.cat([token[:, None], dtoks], dim=1)  # (B, k + 1)
    tlogits, target_cache = target.verify_step(window, target_cache, lora=target_lora)
    a, correction = _accept(dtoks, dlogits, tlogits, generator, temperature=temperature, top_p=top_p)
    packed = _emit(dtoks, a, correction, active, k)
    target_cache = _rewind(target_cache, a, active, k)
    draft_cache = _rewind(draft_cache, a, active, k)
    next_token = torch.where(active, correction, token)
    return packed, target_cache, draft_cache, next_token


class SpeculativeGenerator:
    """Speculative decoding over a (target, draft) FastVLM pair.

    Both models share the vocab and the device; the draft may differ in every
    other dimension. ``k`` is the draft lookahead a round; a round costs
    ``(k + 1)`` draft steps plus one target verify of ``k + 1`` tokens and
    yields ``accepted + 1`` in ``[1, k + 1]`` tokens. ``temperature == 0``
    emits the target's greedy tokens; ``temperature > 0`` tokens distributed
    like plain sampling from the target.
    """

    def __init__(self, target: FastVLM, draft: FastVLM, *, k: int = 4, eos_token_id: int = 2,
                 temperature: float = 0.0, top_p: float = 1.0, seed: int = 0) -> None:
        validate_draft_pair(target, draft, k)
        self.target, self.draft = target, draft
        self.device = _device_of(target)
        self.k = int(k)
        self.eos_token_id = int(eos_token_id)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def generate(self, images, input_ids, attention_mask, *, max_new_tokens: int = 32) -> np.ndarray:
        """Decode -> (B, max_new_tokens) ids, eos-padded after each row
        finishes. Inputs may be numpy or tensors."""
        as_dev = lambda x: None if x is None else torch.as_tensor(x).to(self.device)
        images, input_ids, attention_mask = as_dev(images), as_dev(input_ids), as_dev(attention_mask)
        b, t = input_ids.shape
        k = self.k
        # Each round writes k + 1 positions before rolling the rejected
        # suffix back: the high-water mark is the accepted length plus one window.
        target_cache = build_cache(self.target.cfg, b, t, max_new_tokens + k + 1, device=self.device)
        draft_cache = build_cache(self.draft.cfg, b, t, max_new_tokens + k + 1, device=self.device)
        t_logits, _, target_cache, _, _ = self.target.prefill(images, input_ids, attention_mask, target_cache)
        _, _, draft_cache, _, _ = self.draft.prefill(images, input_ids, attention_mask, draft_cache)
        token = sample_tokens(t_logits, self._generator, self.temperature, self.top_p)

        out = np.full((b, max_new_tokens), self.eos_token_id, np.int64)
        first = token.cpu().numpy()
        out[:, 0] = first  # the prefill's token is the first emission
        lengths = np.ones(b, np.int64)
        done = (first == self.eos_token_id) | (max_new_tokens <= 1)
        while not done.all():
            active = torch.as_tensor(~done, device=self.device)
            packed, target_cache, draft_cache, token = _speculative_round(
                self.target, self.draft, target_cache, draft_cache, token, active, self._generator,
                k=k, temperature=self.temperature, top_p=self.top_p,
            )
            packed_h = packed.cpu().numpy()  # one fetch a round
            for row in range(b):
                if done[row]:
                    continue
                for j in range(int(packed_h[row, k + 1])):
                    tok = int(packed_h[row, j])
                    out[row, lengths[row]] = tok
                    lengths[row] += 1
                    if tok == self.eos_token_id or lengths[row] >= max_new_tokens:
                        done[row] = True
                        break
        return out


class SpeculativeGenerationServer(GenerationServer):
    """Continuous batching with speculative decode ticks.

    The dense slot server with its decode tick replaced by one draft-verify
    round across all slots (``num_slots + 1`` rows with the trash slot, an
    ``active`` mask pinning the others): a tick emits ``accepted_i + 1`` in
    ``[1, k + 1]`` tokens per active slot. Admission prefills both models (raw
    frames through the same ``image_prep`` on both sides) and inserts each
    cache into its slot. A slot that finishes mid-window
    abandons its extra accepted rows; the next admission's insert overwrites
    the whole slot row. ``step_n`` raises: a plain multi-tick decode would
    advance the target cache without the draft's.
    """

    def __init__(self, model: FastVLM, draft: FastVLM, *, k: int = 4, num_slots: int = 8, prompt_len=64,
                 max_new_tokens: int = 32, eos_token_id: int = 2, prefill_batch: int = 4,
                 temperature: float = 0.0, top_p: float = 1.0, seed: int = 0, lora=None, mesh=None,
                 image_prep=None) -> None:
        validate_draft_pair(model, draft, k)
        self.k = int(k)
        # Rounds write a k + 1 window before rolling the rejected suffix
        # back; the high-water mark is the accepted length plus one window.
        super().__init__(model, num_slots=num_slots, prompt_len=prompt_len, max_new_tokens=max_new_tokens,
                         eos_token_id=eos_token_id, prefill_batch=prefill_batch, temperature=temperature,
                         top_p=top_p, seed=seed, lora=lora, mesh=mesh, cache_slack=self.k + 1,
                         image_prep=image_prep)
        self.draft = draft
        dcfg = draft.cfg
        self._draft_cache_len = dcfg.num_image_tokens + self.prompt_len + max_new_tokens + self.k + 1
        self.draft_cache = init_kv_cache(dcfg.text, num_slots + 1, self._draft_cache_len, device=self.device)
        # tokens_per_tick is the live amortization: 1.0 when no draft token
        # is accepted, k + 1 at full acceptance.
        self.spec_tokens_emitted = 0
        self.spec_ticks = 0
        self.spec_slot_rounds = 0  # active slots summed over rounds

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

    @torch.no_grad()
    def _admit(self, batch: List[_Pending]) -> None:
        ids, mask, images, slots = self._assemble_admission(batch)
        last_logits, cache_p = self._prefill(self.model, self._cache_len, images, ids, mask,
                                             batch_lora(self, batch, self.prefill_batch))
        first = sample_tokens(last_logits, self._generator, self.temperature, self.top_p)
        _, dcache_p = self._prefill(self.draft, self._draft_cache_len, images, ids, mask)
        slots_d = self._to_device(slots)
        self.cache = self._insert(self.cache, cache_p, slots_d)
        self.draft_cache = self._insert(self.draft_cache, dcache_p, slots_d)
        self._register_admitted(batch, slots, first.cpu().numpy())

    @torch.no_grad()
    def step(self):
        """Admit pending requests, then one speculative round across all
        slots (up to ``k + 1`` tokens per active slot); returns finished
        request outputs."""
        self.flush()
        if any(s.active for s in self._slots):
            active = np.zeros(self.num_slots + 1, bool)
            active[: self.num_slots] = [s.active for s in self._slots]
            packed, self.cache, self.draft_cache, _ = _speculative_round(
                self.model, self.draft, self.cache, self.draft_cache, self._device_tokens(),
                self._to_device(active), self._generator, slots_lora(self, self.num_slots + 1), k=self.k,
                temperature=self.temperature,
                top_p=self.top_p,
            )
            packed_h = packed.cpu().numpy()  # one fetch a tick
            self.spec_ticks += 1
            self.spec_slot_rounds += sum(s.active for s in self._slots)
            for i, slot in enumerate(self._slots):
                if not slot.active:
                    continue
                for j in range(int(packed_h[i, self.k + 1])):
                    tok = int(packed_h[i, j])
                    slot.tokens.append(tok)
                    slot.remaining -= 1
                    self.spec_tokens_emitted += 1
                    if tok == self.eos_token_id or slot.remaining <= 0:
                        break
                self._pending_token[i] = slot.tokens[-1]
                self._finish_if_done(i)
        finished = self._finished_buffer
        self._finished_buffer = {}
        return finished
