"""Closed-loop control over the generation servers (counterpart of
``vla_fastvlm_tpu/serving/token_policy_server.py``).

Every control tick, each environment's observation becomes ONE generation
request to a dense, paged or speculative server: the prompt is
``[task][state tokens]``, the request emits exactly ``chunk_size x
action_dim`` tokens (``eos_token_id=-1``), and the tokens de-bin to the
action. ``TokenPolicyServer.forward(images, states, tasks)`` has the
policies' signature, so ``ActionQueuePolicy`` / ``BatchedEnvRunner``
(``serving/policy_runtime.py``) drive it unchanged.

The ``B`` requests of a tick drain in ``ceil(B / free slots)`` waves. A
wave submits every free slot before the card is touched, so the next call
admits the whole wave in ``prefill_batch``-sized prefills; plain servers
then run the wave's fixed-length decode tail in one ``step_n(budget)`` call
with one host fetch, speculative servers one draft-verify round per
``step()``. Requests are submitted afresh every tick: a KV cache has no
value once the observation changes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..device import DeviceLike, same_device
from ..model.fastvlm_adapter import prepare_policy_images


class TokenPolicyServer:
    """Serve a ``FastVLMTokenPolicy``'s control ticks through a generation server.

    ``server``: a ``GenerationServer``, ``PagedGenerationServer``,
    ``SpeculativeGenerationServer`` or ``SpeculativePagedGenerationServer``
    over ``policy.backbone.model``, with ``max_new_tokens == chunk_size x
    action_dim`` and ``eos_token_id=-1``. Where the server has an
    ``image_prep`` (``prepare_policy_images``), raw frames are submitted and
    letterboxed inside admission; otherwise the whole tick's frames are
    letterboxed on the card at once and submitted at the tower's size.

    Counters: ``control_ticks``; ``server_ticks``, the decode ticks (a plain
    wave's ``budget - 1``, one per speculative round); ``server_programs``,
    the server calls that decode (one ``step_n`` or ``step`` call each: the
    port runs a call's ticks eagerly, where JAX runs one scanned program).
    ``last_tokens`` holds the last tick's (B, chunk_size x action_dim) tokens.
    """

    def __init__(self, policy, server) -> None:
        self.policy = policy
        self.server = server
        self.config = policy.config
        self.device = server.device
        if server.max_new_tokens != policy.num_action_tokens:
            raise ValueError(
                f"server.max_new_tokens ({server.max_new_tokens}) must equal chunk_size * action_dim "
                f"({policy.num_action_tokens})"
            )
        if server.eos_token_id >= 0:
            raise ValueError("build the server with eos_token_id=-1: action tokens must never terminate "
                             "generation early")
        self._multimodal = policy.backbone.model_config.num_image_tokens > 0
        self._speculative = hasattr(server, "draft")
        self.control_ticks = 0
        self.server_ticks = 0
        self.server_programs = 0
        self.last_tokens = None

    def _host_images(self, images) -> np.ndarray:
        """The tick's frames as the server takes them: raw under
        ``image_prep``, else letterboxed on the card in one batch."""
        if self.server.image_prep is not None:
            return np.asarray(images.detach().cpu() if isinstance(images, torch.Tensor) else images, np.float32)
        backbone = self.policy.backbone
        prepared = prepare_policy_images(backbone.to_device(images), backbone.model_config, backbone.config)
        return prepared.float().cpu().numpy()

    def forward(self, images, states, tasks: List[str] | str, device: DeviceLike = None) -> np.ndarray:
        """One control tick: B observations -> (B, action_dim) actions, or
        (B, chunk_size, action_dim)."""
        if device is not None and not same_device(self.device, torch.device(device)):
            raise ValueError(f"the server lives on {self.device}, forward was asked for {device}")
        policy, server = self.policy, self.server
        images = policy.processor.prepare_images(images)
        states = policy.processor.prepare_states(states)
        b = images.shape[0]
        tasks = policy.processor.prepare_tasks(tasks, batch_size=b)
        ids, mask = policy.prompt_arrays(tasks, states)
        imgs_host = self._host_images(images) if self._multimodal else None

        outputs: Dict[int, List[int]] = {}
        rid_to_row: Dict[int, int] = {}
        row = 0
        budget = server.max_new_tokens
        while len(outputs) < b:
            # Fill every free slot before the card is touched: submit only
            # queues; the next call admits the wave in batched prefills.
            while row < b and server.has_free_slot():
                rid = server.submit(ids[row: row + 1], mask[row: row + 1],
                                    None if imgs_host is None else imgs_host[row: row + 1])
                rid_to_row[rid] = row
                row += 1
            if self._speculative:
                outputs.update(server.step())  # one round: 1..k + 1 tokens a slot
                self.server_ticks += 1
            else:
                before = len(outputs)
                outputs.update(server.step_n(budget))  # the wave's decode tail, one fetch
                self.server_ticks += budget - 1 if len(outputs) > before else 1
            self.server_programs += 1
        self.control_ticks += 1

        d = policy.num_action_tokens
        tokens = np.zeros((b, d), np.int64)
        for rid, toks in outputs.items():
            if len(toks) != d:
                raise RuntimeError(f"request {rid} returned {len(toks)} tokens, expected {d}")
            tokens[rid_to_row[rid]] = toks
        self.last_tokens = tokens
        actions = policy.tokenizer.decode(tokens)  # (B, chunk * D) float32
        if policy.config.chunk_size > 1:
            return actions.reshape(b, policy.config.chunk_size, policy.config.action_dim)
        return actions

    def reset(self) -> None:
        return
