"""Offline bulk serving of image questions on the port's paged server
(``PagedGenerationServer.submit`` / ``step``): every slot busy, a backlog
always waiting, greedy decoding of a fixed number of tokens a request.

Traffic keys: ``slots``, ``max_new_tokens``, ``prefill_batch``,
``page_size``, ``decode_impl``, ``image_size``, ``dtype``; prompts of
``prompt_min`` .. ``prompt_max`` tokens, log-uniform, padded to
``prompt_buckets``; ``frames`` distinct seeded frames, one a request;
``check_requests`` finished requests and ``tick_slots`` busy slots
compared with the reference;
``profile_cycles`` admission cycles in a traced run's profiled segment.

Every seed serves the same prompt lengths (the log-uniform quantiles of
``slots`` requests, repeated) in its own order, with its own token ids and
frames. Set-up admits ``prefill_batch`` requests every
``max_new_tokens * prefill_batch / slots`` ticks until the first request
finishes, so the slots finish in staggered groups and every later step
admits the group that finished before it. The window opens at such an
admission and closes, after ``--seconds``, at the end of a cycle: it holds
whole cycles of admission and decode.

Compared: ``logit_gap``, over a sample of the window's finished requests
drawn from the seed (the one with the longest prompt among them): the
widest gap by which a served token's logit lies below the best logit of
the float32 reference run over the frame, the prompt and the served
tokens; ``tick_err``, the largest gap between the logits of one more tick
of the window's tick program over the state the window left (slots drawn
from the seed, the longest context among them) and the reference's at the
same positions, over the reference logits' RMS; ``token_mismatch``, the
busy slots whose token, appended by the server's own step over that same
state, is not the first maximum of those checked logits (exact: each served
token is the greedy pick of logits held to the reference). ``failed``
counts finished requests with a wrong token count.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from .. import trace
from ..common import Window, rng, sub_seed
from ..reference import bounds, flops
from ..reference import model as R
from ..reference.config import ModelCfg
from ..reference.weights import Weights


class Cell:
    def __init__(self, cfg: ModelCfg, raw_cfg: dict, traffic: dict, seed: int, device, traced: bool) -> None:
        self.cfg, self.raw, self.t, self.seed = cfg, raw_cfg, traffic, seed
        self.device, self.traced = torch.device(device), traced
        self.ranges = trace.Ranges() if traced else None
        self.n_img = cfg.image_tokens(traffic["image_size"])
        self.step_no = 0
        self.requests: Dict[int, dict] = {}  # rid -> prompt, frame, admitted step, tokens, finished step
        self._paged_calls: list = []
        self._window_steps = (0, 0)

    # -- traffic -----------------------------------------------------------

    def _lengths(self) -> List[int]:
        t, n = self.t, self.t["slots"]
        lo, hi = t["prompt_min"], t["prompt_max"]
        return [math.ceil(lo * (hi / lo) ** ((i + 0.5) / n)) for i in range(n)]

    def _stream(self):
        """Requests in the seed's order: (token ids, frame index). Each cycle
        of ``slots`` requests deals the prompt lengths, bucket by bucket and
        each bucket in the seed's order, round the admission groups of
        ``prefill_batch``: every seed's group i holds the same number of
        prompts of each bucket, so every seed admits the same programs."""
        t = self.t
        r = rng(self.seed, "requests")
        by_bucket: Dict[int, List[int]] = {}
        for n in self._lengths():
            by_bucket.setdefault(min(b for b in t["prompt_buckets"] if b >= n), []).append(n)
        groups = t["slots"] // t["prefill_batch"]
        vocab = self.cfg.text.vocab_size
        while True:
            ordered = [int(n) for bucket in sorted(by_bucket) for n in r.permutation(by_bucket[bucket])]
            dealt = [ordered[g::groups] for g in range(groups)]
            for group in dealt:
                for n in r.permutation(group):
                    yield r.integers(3, vocab, size=int(n)).astype(np.int32), int(r.integers(t["frames"]))

    def _frames(self) -> np.ndarray:
        s = self.t["image_size"]
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "frames"))
        return np.stack([torch.rand((1, 3, s, s), generator=gen, device=self.device).cpu().numpy()
                         for _ in range(self.t["frames"])])

    # -- the program -------------------------------------------------------

    def setup(self) -> None:
        from vla_fastvlm_tpu_torch.serving import PagedGenerationServer

        from ..port import build_fastvlm

        t = self.t
        dtype = getattr(torch, t["dtype"])
        self.model = build_fastvlm(self.cfg, self.seed, self.device, t["image_size"], dtype)
        self.server = PagedGenerationServer(
            self.model, num_slots=t["slots"], prompt_len=tuple(t["prompt_buckets"]),
            max_new_tokens=t["max_new_tokens"], eos_token_id=-1, page_size=t["page_size"],
            prefill_batch=t["prefill_batch"], decode_impl=t["decode_impl"], temperature=0.0, seed=0)
        self.frames = self._frames()
        self.stream = self._stream()
        self._warm_admissions(dtype)
        if self.traced:
            self._instrument()
        group, cycle = t["prefill_batch"], t["max_new_tokens"] * t["prefill_batch"] // t["slots"]
        finished = {}
        while not finished:
            if self.step_no % cycle == 0 and self.step_no < cycle * (t["slots"] // group):
                self._submit(group)
            finished = self._step()[0]
        if self.traced:
            self.ranges.host_s.clear()

    def _warm_admissions(self, dtype) -> None:
        """One admission program of every prompt bucket (the tower over a full
        admission batch and the prefill into a dense cache of the server's
        length), so the window builds and tunes nothing."""
        from vla_fastvlm_tpu_torch.models.qwen2 import init_kv_cache

        t = self.t
        page = t["page_size"]
        max_len = -(-(self.n_img + max(t["prompt_buckets"]) + t["max_new_tokens"]) // page) * page
        b = t["prefill_batch"]
        images = torch.from_numpy(self.frames[np.arange(b) % len(self.frames), 0]).to(self.device)
        with torch.no_grad():
            for bucket in t["prompt_buckets"]:
                cache = init_kv_cache(self.model.cfg.text, b, max_len, device=self.device)
                ids = torch.full((b, bucket), 3, dtype=torch.int32, device=self.device)
                self.model.prefill(images, ids, torch.ones_like(ids), cache)

    def _instrument(self) -> None:
        import vla_fastvlm_tpu_torch.models.qwen2 as qwen2

        def record(args, kwargs, out):
            self._paged_calls.append((tuple(args[0].shape), tuple(args[1].shape), args[3], args[4],
                                      args[0].element_size()))
            return 0.0

        self.ranges.wrap(qwen2, "paged_attention", "paged", bound=record)

    def _submit(self, most: int) -> int:
        n = 0
        while n < most and self.server.has_free_slot():
            ids, frame = next(self.stream)
            rid = self.server.submit(ids[None], np.ones((1, len(ids)), np.int32), self.frames[frame])
            self.requests[rid] = {"ids": ids, "frame": frame, "admitted": self.step_no, "tokens": None}
            n += 1
        return n

    def _step(self):
        """One server step; returns (finished, tokens emitted, host seconds, admitted)."""
        admitted = sum(1 for r in self.requests.values() if r["admitted"] == self.step_no)
        t0 = time.perf_counter()
        with trace.span("admit" if admitted else "decode"):
            finished = self.server.step()
        dt = time.perf_counter() - t0
        for rid, tokens in finished.items():
            self.requests[rid]["tokens"] = tokens
            self.requests[rid]["finished"] = self.step_no
        tokens = admitted + self.server.num_active + len(finished)
        self.step_no += 1
        return finished, tokens, dt, admitted

    def window(self, seconds: float) -> Window:
        out = Window(host_s={"admit": [], "decode": []})
        first = self.step_no
        tokens = 0
        t0 = time.perf_counter()
        while True:
            with trace.span("submit"):
                self._submit(self.t["slots"])
            finished, emitted, dt, admitted = self._step()
            tokens += emitted
            out.units += bool(finished)
            out.host_s["admit" if admitted else "decode"].append(dt)
            for rid, toks in finished.items():
                out.attempted += 1
                out.failed += len(toks) != self.t["max_new_tokens"]
            if finished and time.perf_counter() - t0 >= seconds:
                break
        out.seconds = time.perf_counter() - t0
        self._window_steps = (first, self.step_no)
        out.metrics = {"tokens_per_s": tokens / out.seconds}
        return out

    def profile(self) -> trace.Summary:
        self.ranges.bounds_on = True
        self._paged_calls.clear()

        def run():
            cycles = 0
            while cycles < self.t["profile_cycles"]:
                with trace.span("submit"):
                    self._submit(self.t["slots"])
                cycles += bool(self._step()[0])

        summary = trace.profile(run, self.device)
        self.ranges.bounds_on = False
        self.ranges.bound_s["paged"] = self._paged_bound()
        return summary

    def _paged_bound(self) -> float:
        total, seen = 0.0, {}
        for q_shape, pool_shape, tables, mask, elem in self._paged_calls:
            key = (id(tables), id(mask))
            if key not in seen:
                b, p_slot = tables.shape
                page = pool_shape[2]
                reached = tables[mask.reshape(b, p_slot, page).any(-1)].unique().numel()
                seen[key] = (reached, int(mask.sum()), tables.numel(), mask.numel())
            reached, valid, n_tab, n_mask = seen[key]
            rows, window = q_shape[0], q_shape[1]
            total += bounds.paged_seconds(rows, window, q_shape[2], pool_shape[1], q_shape[3], pool_shape[2],
                                          reached, valid, n_tab, n_mask, elem)
        self._paged_calls.clear()
        return total

    def profiled_units(self) -> int:
        return self.t["profile_cycles"]

    def window_flops(self, window: Window) -> float:
        cfg, n_img = self.cfg, self.n_img
        w0, w1 = self._window_steps
        img = flops.image_tokens(cfg, self.t["image_size"])
        pa, pb, pc = flops.quadratic(lambda n: flops.prefill(cfg, n))
        d0, d1 = flops.decode(cfg, 0), flops.decode(cfg, 256)
        da, db = d0, (d1 - d0) / 256
        total = 0.0
        for r in self.requests.values():
            a, n = r["admitted"], n_img + len(r["ids"])
            if w0 <= a < w1:
                total += img + pa + pb * n + pc * n * n
            last = r.get("finished", w1 - 1) if r["tokens"] is not None else w1 - 1
            lo, hi = max(a, w0), min(last, w1 - 1)
            if hi >= lo:  # the step s tick attends n + (s - a) earlier positions
                k = hi - lo + 1
                ctx_sum = k * (n - a) + (lo + hi) * k / 2
                total += da * k + db * ctx_sum
        return total

    def release(self) -> None:
        """Take the tick check's program logits and tokens, then free the
        program."""
        if self.ranges is not None:
            self.ranges.restore()
        self.ticked, self.mismatched = self._capture_tick() if self.server is not None else ([], None)
        self.server = self.model = None

    def _capture_tick(self):
        """After one more step, which admits into the slots the window's last
        requests freed, the logits of one more decode tick over every busy
        slot (``tick_logits``: the window's tick program, its pools only
        read), kept for ``tick_slots`` slots drawn from the seed (the longest
        context among them) with the prompt and tokens each slot holds; then
        one more step, a decode tick over that same state (nothing is
        pending), and the number of busy slots whose appended token is not
        the first maximum of their checked logits."""
        self._submit(self.t["slots"])
        self._step()
        busy = [(i, s) for i, s in enumerate(self.server._slots) if s.active]
        if not busy:
            return [], None
        r = rng(self.seed, "tick")
        size = lambda k: len(self.requests[busy[k][1].request_id]["ids"]) + len(busy[k][1].tokens)  # noqa: E731
        longest = max(range(len(busy)), key=size)
        rest = [k for k in range(len(busy)) if k != longest]
        picks = [longest] + r.choice(rest, size=min(self.t["tick_slots"] - 1, len(rest)), replace=False).tolist()
        logits = self.server.tick_logits()
        out = []
        for k in picks:
            slot_index, slot = busy[k]
            req = self.requests[slot.request_id]
            out.append({"ids": req["ids"], "frame": req["frame"], "tokens": list(slot.tokens),
                        "logits": logits[slot_index].float().cpu()})
        best = logits.argmax(dim=-1).cpu().tolist()
        held = [(i, len(s.tokens)) for i, s in busy]
        self._step()
        slots = self.server._slots
        mismatched = sum(len(slots[i].tokens) != n + 1 or slots[i].tokens[n] != best[i] for i, n in held)
        return out, mismatched

    # -- the comparison ----------------------------------------------------

    def _checked(self) -> List[dict]:
        w0, w1 = self._window_steps
        done = [r for r in self.requests.values() if r["tokens"] is not None and w0 <= r["finished"] < w1]
        if not done:
            return []
        longest = max(range(len(done)), key=lambda i: len(done[i]["ids"]))
        r = rng(self.seed, "check")
        rest = [i for i in range(len(done)) if i != longest]
        picks = [longest] + r.choice(rest, size=min(self.t["check_requests"] - 1, len(rest)), replace=False).tolist()
        return [done[i] for i in picks]

    def _reference_logits(self, seqs: List[tuple], P=None) -> List[torch.Tensor]:
        """Float32 logits of the reference run over each ``(frame, prompt
        ids, tokens)`` at the positions ``start .. start + count``: layer by
        layer over the sequences, so a 7B layer's weights are made once."""
        cfg, dev, n_img = self.cfg, self.device, self.n_img
        W = Weights(cfg, self.seed, dev)
        with torch.no_grad(), R.exact_fp32():
            frames = torch.from_numpy(np.concatenate([self.frames[f] for f, _, _, _, _ in seqs])).to(dev)
            img = R.projector(W, R.tower(W, cfg, frames, P), P)
            W.drop("vision_tower")
            W.drop("mm_projector")
            xs = [torch.cat([img[i: i + 1], R.embed(W, torch.from_numpy(np.concatenate(
                [ids, np.asarray(tokens, np.int64)])).to(dev)[None])], dim=1)
                  for i, (_, ids, tokens, _, _) in enumerate(seqs)]
            del img
            for layer in range(cfg.text.num_hidden_layers):
                for i, x in enumerate(xs):
                    pos = torch.arange(x.shape[1], device=dev)[None]
                    xs[i] = R.decoder_layer(W, layer, cfg, x, pos, torch.ones_like(pos), P)
                W.drop(f"language_model.layers.{layer}")
            return [R.lm_logits(W, cfg, R.final_norm(W, cfg, x[0, start: start + count]), P)
                    for (_, _, _, start, count), x in zip(seqs, xs)]

    def _sequences(self, reqs: List[dict], ticked: List[dict]) -> List[tuple]:
        """Finished requests: logits where each served token was chosen;
        slots of the tick check: logits at the slot's next position."""
        n = self.n_img
        return ([(r["frame"], r["ids"], r["tokens"][:-1], n + len(r["ids"]) - 1, len(r["tokens"])) for r in reqs]
                + [(c["frame"], c["ids"], c["tokens"], n + len(c["ids"]) + len(c["tokens"]) - 1, 1) for c in ticked])

    @staticmethod
    def _gap(ref: List[torch.Tensor], chosen: List[torch.Tensor]) -> float:
        worst = 0.0
        for logits, tokens in zip(ref, chosen):
            served = logits.gather(1, tokens.to(logits.device)[:, None])[:, 0]
            worst = max(worst, float((logits.max(dim=1).values - served).max()))
        return worst

    @staticmethod
    def _tick_err(ref: List[torch.Tensor], got: List[torch.Tensor]) -> float:
        ref = torch.cat([r.reshape(-1).cpu() for r in ref])
        got = torch.cat([g.reshape(-1).cpu() for g in got])
        return float((got - ref).abs().max() / ref.square().mean().sqrt())

    def compare(self) -> Dict[str, float]:
        """``logit_gap`` over finished requests; ``tick_err``, the largest
        |program - reference| logit of the tick check over the reference
        logits' RMS; ``token_mismatch``, the tick check's busy slots whose
        served token is not the greedy pick of the checked logits."""
        reqs = self._checked()
        if not reqs or not self.ticked:
            return {}
        ref = self._reference_logits(self._sequences(reqs, self.ticked))
        return {"logit_gap": self._gap(ref[: len(reqs)], [torch.tensor(r["tokens"]) for r in reqs]),
                "tick_err": self._tick_err(ref[len(reqs):], [c["logits"] for c in self.ticked]),
                "token_mismatch": float(self.mismatched)}

    def control(self) -> Dict[str, float]:
        """The float8 reference in the program's place: the token it puts
        first at each position of the same requests, and its logits at the
        tick check's positions, read against the float32 reference."""
        reqs = self._checked()
        seqs = self._sequences(reqs, self.ticked)
        low, ref = self._reference_logits(seqs, R.FP8()), self._reference_logits(seqs)
        k = len(reqs)
        return {"logit_gap": self._gap(ref[:k], [lg.argmax(dim=1) for lg in low[:k]]),
                "tick_err": self._tick_err(ref[k:], low[k:])}
