"""I/O of the port: tokenizer, presets, and the JAX -> torch weight bridge."""

from .bridge import flatten_params, jax_params_to_torch
from .presets import resolve_fastvlm_config
from .tokenizer import ByteTokenizer, TokenBatch, load_tokenizer

__all__ = [
    "ByteTokenizer",
    "TokenBatch",
    "flatten_params",
    "jax_params_to_torch",
    "load_tokenizer",
    "resolve_fastvlm_config",
]
