"""Autoregressive action-token policy (counterpart of
``vla_fastvlm_tpu/fastvla/token_policy.py``).

Actions and the robot state are discretized onto the tail of the language
model's vocabulary (``models/action_tokens.py``), and the policy decodes
``chunk_size x action_dim`` tokens through the VLM's own lm_head: it has no
head parameters, and it trains LoRA adapters (``lora_rank > 0``,
``io/lora.py``: the adapters alone are trainable, over the frozen base) or
the full backbone (``train_backbone``). Every control tick is a short generation, so closed-loop control rides
the serving stack (``serving/token_policy_server.py``).

Sequence layout, packed on the host and right-padded (no padding inside a
row, so the prefill's last-position logits apply unchanged)::

    [image tokens] [prompt tokens] [state tokens (D_s)]
        -> teacher forcing appends [action tokens (chunk x D_a)]

``loss_fn`` follows the port's ``Trainer`` protocol:
``loss_fn(arrays, train, generator) -> (loss, {"loss", "mse",
"token_accuracy"})``, cross-entropy at the action positions in an fp32
log-softmax. The LM head runs on the predictor positions only (JAX applies
``FastVLM.forward_logits`` to every position and picks them; the numbers are
the same). ``mse`` decodes the argmax tokens to bin centers against the
continuous targets. ``forward`` decodes through ``serving/generate.py`` with
``eos_token_id=-1``, so exactly ``chunk_size x action_dim`` tokens come out.
The loss and the decode mount the adapters when there are some.
Entry points run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..io.bridge import flatten_params, torch_lora_to_jax, torch_params_to_jax
from ..io.lora import load_lora_params
from ..model.fastvlm_adapter import FastVLMBackbone, as_float32, prepare_policy_images
from ..models.action_tokens import ActionTokenizer
from ..serving.generate import generate
from .configuration_fastvla import FastVLAConfig
from .fastvlm_with_expert import build_lora, check_lora
from .modeling_fastvla import FastVLAPolicy
from .processor_fastvla import FastVLAProcessor


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class FastVLMTokenPolicy:
    """FastVLM + discretized autoregressive action decoding."""

    config_class = FastVLAConfig
    name = "fastvla-token"

    def __init__(self, config: Optional[FastVLAConfig] = None, device: DeviceLike = None) -> None:
        self.config = config or FastVLAConfig(action_head="token")
        cfg = self.config
        if cfg.action_head != "token":
            raise ValueError(f"FastVLMTokenPolicy requires action_head='token', got {cfg.action_head!r}")
        check_lora(cfg)
        self.backbone = FastVLMBackbone(cfg.to_backbone_config(), device=device)
        self.device = self.backbone.device
        self.processor = FastVLAProcessor(cfg, self.backbone)
        self.tokenizer = ActionTokenizer(
            vocab_size=self.backbone.model_config.text.vocab_size,
            num_bins=cfg.action_bins,
            low=cfg.action_token_low,
            high=cfg.action_token_high,
        )
        # Inference-only construction is fine with nothing trainable; the
        # training-time guard lives in trainable_params.
        self.lora = build_lora(cfg, self.backbone)

    @property
    def num_action_tokens(self) -> int:
        """Tokens decoded per observation: ``chunk_size x action_dim``."""
        return self.config.chunk_size * self.config.action_dim

    # ------------------------------------------------------------------
    # parameters (the FastVLAPolicy split, with no head)

    @property
    def params(self) -> Dict[str, Dict[str, torch.nn.Parameter]]:
        out = {"backbone": dict(self.backbone.model.named_parameters())}
        if self.lora is not None:
            out["lora"] = flatten_params(self.lora)
        return out

    def load_jax_params(self, params: Mapping) -> None:
        """Load ``{"backbone": ...[, "lora": ...]}`` from the JAX package (numpy leaves)."""
        self.backbone.load_jax_params(params["backbone"])
        if "lora" in params:
            self.lora = load_lora_params(self.lora, params["lora"], self.device)

    def jax_params(self, as_numpy: bool = True) -> Dict:
        """The JAX package's ``{"backbone": ...[, "lora": ...]}`` tree of these parameters."""
        scanned = self.backbone.model_config.text.scan_layers
        out = {"backbone": torch_params_to_jax(self.backbone.model, scanned, as_numpy)}
        if self.lora is not None:
            out["lora"] = torch_lora_to_jax(self.lora, scanned, as_numpy)
        return out

    def trainable_params(self) -> Dict[str, Dict[str, torch.nn.Parameter]]:
        """The adapters when mounted, else the backbone with ``train_backbone``."""
        if self.lora is not None:
            return {"lora": flatten_params(self.lora)}
        if not self.config.train_backbone:
            raise ValueError(
                "the token policy has no head parameters: train with lora_rank > 0 (QLoRA when quantized) "
                "or train_backbone=True"
            )
        return self.params

    def merge_trainable(self, trainable: Mapping) -> Dict:
        return {**self.params, **trainable}

    def frozen_params(self) -> Dict:
        trainable = self.trainable_params()
        return {k: v for k, v in self.params.items() if k not in trainable}

    # ------------------------------------------------------------------
    # host-side batch prep

    def _pack(self, ids: np.ndarray, mask: np.ndarray, state_tokens: np.ndarray,
              action_tokens: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Append state (and action) tokens at each row's TRUE prompt end,
        keeping the result right-padded at static width L + D_s [+ D_a]."""
        b, width = ids.shape
        extra = state_tokens.shape[1] + (action_tokens.shape[1] if action_tokens is not None else 0)
        out_ids = np.zeros((b, width + extra), np.int32)
        out_mask = np.zeros((b, width + extra), np.int32)
        lengths = mask.astype(np.int32).sum(axis=1)
        for i in range(b):
            n = int(lengths[i])
            row = [ids[i, :n], state_tokens[i]]
            if action_tokens is not None:
                row.append(action_tokens[i])
            packed = np.concatenate(row)
            out_ids[i, : packed.shape[0]] = packed
            out_mask[i, : packed.shape[0]] = 1
        return out_ids, out_mask

    def prompt_arrays(self, tasks: List[str], states, action_tokens: Optional[np.ndarray] = None):
        """Prepared tasks and states -> the packed host ``(ids, mask)``."""
        ids, mask = self.backbone._prep_text(tasks)
        state_tokens = self.tokenizer.encode(_numpy(states))
        return self._pack(np.asarray(ids), np.asarray(mask), state_tokens, action_tokens)

    def prepare_batch(self, batch: Mapping) -> Dict[str, np.ndarray]:
        """Collated batch -> ``images``, packed ``input_ids`` /
        ``attention_mask`` and, with targets, ``actions`` (the first
        ``chunk_size`` steps) and their ``action_tokens``."""
        images = self.processor.prepare_images(batch["images"])
        states = self.processor.prepare_states(batch["states"])
        tasks = self.processor.prepare_tasks(batch["tasks"], batch_size=images.shape[0])
        actions = action_tokens = None
        if "actions" in batch:
            actions = _numpy(batch["actions"]).astype(np.float32)
            chunk = self.config.chunk_size
            if chunk == 1:
                if actions.ndim == 3:  # (B, T, D) time-major -> step 0
                    actions = actions[:, 0]
            else:
                if actions.ndim != 3 or actions.shape[1] < chunk:
                    raise ValueError(
                        f"chunk_size={chunk} needs time-major actions (B, T >= {chunk}, D); got {actions.shape}"
                    )
                actions = actions[:, :chunk]
            action_tokens = self.tokenizer.encode(actions).reshape(actions.shape[0], -1)
        ids, mask = self.prompt_arrays(tasks, states, action_tokens)
        out = {"images": images, "input_ids": ids, "attention_mask": mask}
        if actions is not None:
            out["actions"] = actions
            out["action_tokens"] = action_tokens
        return out

    to_device = FastVLAPolicy.to_device

    # ------------------------------------------------------------------
    # compute

    def loss_fn(self, arrays: Mapping[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Teacher-forced cross-entropy over the action-token positions:
        ``(loss, {"loss", "mse", "token_accuracy"})``. ``train`` records the
        graph (there is no dropout, so ``generator`` is unused); without it
        the step runs under ``torch.inference_mode()``."""
        del generator
        model = self.backbone.model
        with contextlib.nullcontext() if train else torch.inference_mode():
            images = prepare_policy_images(arrays["images"], self.backbone.model_config, self.backbone.config)
            hidden, seq_mask, _ = model(images, arrays["input_ids"], arrays["attention_mask"], lora=self.lora)
            targets = arrays["action_tokens"].long()  # (B, chunk * D)
            d_a = targets.shape[1]
            # The action token for dim j sits at index true_len - D_a + j of
            # the right-packed sequence; the position before it predicts it.
            lengths = seq_mask.long().sum(dim=1)
            pred_idx = lengths[:, None] - d_a + torch.arange(d_a, device=lengths.device)[None, :] - 1
            picked = model._logits(torch.gather(hidden, 1, pred_idx[..., None].expand(-1, -1, hidden.shape[-1])))
            logp = torch.log_softmax(picked.float(), dim=-1)
            loss = -logp.gather(-1, targets[..., None])[..., 0].mean()
            argmax = picked.argmax(dim=-1)
            pred_actions = self.tokenizer.decode_torch(argmax).reshape(arrays["actions"].shape)
            mse = torch.mean(torch.square(pred_actions - arrays["actions"].float()))
            acc = (argmax == targets).float().mean()
        return loss, {"loss": loss, "mse": mse, "token_accuracy": acc}

    def compute_loss(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """The loss and metrics of a collated batch (no gradient)."""
        _, metrics = self.loss_fn(self.to_device(self.prepare_batch(batch)))
        return metrics

    def tokens(self, images, states, tasks: List[str] | str, device: DeviceLike = None) -> torch.Tensor:
        """Greedy action tokens, (B, chunk_size * action_dim) int32 on the
        policy's device (not waited for)."""
        self.backbone.check_device(device)
        images = self.processor.prepare_images(images)
        states = self.processor.prepare_states(states)
        tasks = self.processor.prepare_tasks(tasks, batch_size=images.shape[0])
        ids, mask = self.prompt_arrays(tasks, states)
        to = self.backbone.to_device
        with torch.inference_mode():
            prepared = prepare_policy_images(to(images), self.backbone.model_config, self.backbone.config)
            return generate(self.backbone.model, prepared, to(ids), to(mask),
                            max_new_tokens=self.num_action_tokens, eos_token_id=-1, lora=self.lora)

    def forward(self, images, states, tasks: List[str] | str, device: DeviceLike = None) -> torch.Tensor:
        """Actions for a batch of observations: (B, action_dim), or
        (B, chunk, action_dim), on the policy's device."""
        actions = self.tokenizer.decode_torch(self.tokens(images, states, tasks, device))
        if self.config.chunk_size > 1:
            return actions.reshape(actions.shape[0], self.config.chunk_size, self.config.action_dim)
        return actions

    def select_action(self, image, state, task: str, device: DeviceLike = None) -> torch.Tensor:
        return self.forward(as_float32(image)[None], as_float32(state)[None], task, device=device)[0]

    def reset(self) -> None:
        return
