"""KV-cached autoregressive generation for the FastVLM VLM (counterpart of
``vla_fastvlm_tpu/serving/generate.py``): one prefill into a dense cache,
then one decode step per new token. It is the sequential reference the
paged server is held to.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.fastvlm import FastVLM, FastVLMConfig
from ..models.qwen2 import init_kv_cache
from ..parallel.sharding import rank_text_config
from .sampling import sample_tokens


def build_cache(cfg: FastVLMConfig, batch: int, prompt_len: int, max_new_tokens: int, device=None) -> dict:
    max_len = cfg.num_image_tokens + prompt_len + max_new_tokens
    return init_kv_cache(cfg.text, batch, max_len, device=device)


@torch.inference_mode()
def generate(
    model: FastVLM,
    images: Optional[torch.Tensor],
    input_ids: torch.Tensor,  # (B, T) right-padded
    attention_mask: torch.Tensor,  # (B, T)
    *,
    max_new_tokens: int = 32,
    eos_token_id: int = 2,
    temperature: float = 0.0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    return_last_logits: bool = False,
    lora=None,
):
    """Greedy (or temperature) decoding on the model's device. Returns
    (B, max_new_tokens) int32 ids, padded with ``eos_token_id`` after each
    sequence finishes; with ``return_last_logits`` also the (B, V) logits of
    the last decode step. Inputs may be numpy or tensors; ``model`` carries
    the weights and the device (the JAX function's ``params``). ``lora``: an
    adapter tree (``io/lora.py``), single or ``stack_loras`` +
    ``lora_with_ids`` with one adapter a batch row, on the model's device.
    A model placed on a mesh runs its rank's heads into a cache of its
    rank's KV heads (``serving/sharded.py::sharded_generate``)."""
    device = next(model.parameters()).device
    as_dev = lambda x: None if x is None else torch.as_tensor(x).to(device)
    images, input_ids, attention_mask = as_dev(images), as_dev(input_ids), as_dev(attention_mask)
    b, t = input_ids.shape
    cache = init_kv_cache(rank_text_config(model), b, model.cfg.num_image_tokens + t + max_new_tokens, device=device)
    last_logits, _, cache, _, _ = model.prefill(images, input_ids, attention_mask, cache, lora=lora)
    token = sample_tokens(last_logits, generator, temperature, top_p)
    done = token == eos_token_id
    tokens = [token]
    logits = torch.zeros_like(last_logits)
    # The JAX scan runs max_new_tokens decode steps; the last one only feeds
    # return_last_logits.
    steps = max_new_tokens if return_last_logits else max_new_tokens - 1
    for i in range(steps):
        logits, cache = model.decode_step(token[:, None], cache, lora=lora)
        nxt = sample_tokens(logits, generator, temperature, top_p)
        nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
        done = done | (nxt == eos_token_id)
        token = nxt
        if i < max_new_tokens - 1:
            tokens.append(token)
    out = torch.stack(tokens, dim=1)
    return (out, logits) if return_last_logits else out
