"""I/O of the port: tokenizer, presets, LoRA adapters, HF checkpoint conversion, and the JAX -> torch weight bridge."""

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
from .model_loader import load_fastvlm_params
from .presets import infer_size_from_tower_name, resolve_fastvlm_config
from .tokenizer import ByteTokenizer, HFTokenizerAdapter, TokenBatch, load_tokenizer
from .vision_convert import convert_vision_tower
from .weights import convert_qwen2_state_dict, fold_conv_bn

__all__ = [
    "DEFAULT_LORA_TARGETS",
    "ByteTokenizer",
    "HFTokenizerAdapter",
    "TokenBatch",
    "convert_qwen2_state_dict",
    "convert_vision_tower",
    "flatten_params",
    "fold_conv_bn",
    "infer_size_from_tower_name",
    "init_lora",
    "jax_lora_to_torch",
    "jax_params_to_torch",
    "torch_params_to_jax",
    "load_fastvlm_params",
    "load_lora",
    "load_tokenizer",
    "lora_num_params",
    "lora_with_ids",
    "merge_lora",
    "resolve_fastvlm_config",
    "stack_loras",
    "torch_lora_to_jax",
]
