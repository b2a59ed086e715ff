"""I/O of the port: tokenizer, presets, LoRA adapters, and the JAX -> torch weight bridge."""

from .bridge import flatten_params, jax_lora_to_torch, jax_params_to_torch, torch_lora_to_jax, torch_params_to_jax
from .lora import (
    DEFAULT_LORA_TARGETS,
    init_lora,
    load_lora,
    lora_num_params,
    lora_with_ids,
    merge_lora,
    stack_loras,
)
from .presets import resolve_fastvlm_config
from .tokenizer import ByteTokenizer, TokenBatch, load_tokenizer

__all__ = [
    "DEFAULT_LORA_TARGETS",
    "ByteTokenizer",
    "TokenBatch",
    "flatten_params",
    "init_lora",
    "jax_lora_to_torch",
    "jax_params_to_torch",
    "torch_params_to_jax",
    "load_lora",
    "load_tokenizer",
    "lora_num_params",
    "lora_with_ids",
    "merge_lora",
    "resolve_fastvlm_config",
    "stack_loras",
    "torch_lora_to_jax",
]
