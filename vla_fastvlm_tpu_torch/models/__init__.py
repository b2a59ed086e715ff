"""Models of the port: Qwen2 (prefill), FastViTHD, FastVLM, action heads."""

from .action_head import ActionChunkHead, ActionExpertHead
from .fastvit import FastViTHD, FastViTHDConfig, fastvithd, fastvithd_tiny
from .fastvlm import (
    FastVLM,
    FastVLMConfig,
    MMProjector,
    fastvlm_0_5b,
    fastvlm_1_5b,
    fastvlm_7b,
    fastvlm_tiny,
    pool_hidden,
    pool_last_text_token,
)
from .layers import init_weights
from .qwen2 import (
    Qwen2Config,
    Qwen2ForCausalLM,
    Qwen2Model,
    qwen2_0_5b,
    qwen2_1_5b,
    qwen2_7b,
    qwen2_tiny,
)

__all__ = [
    "ActionChunkHead",
    "ActionExpertHead",
    "FastVLM",
    "FastVLMConfig",
    "FastViTHD",
    "FastViTHDConfig",
    "MMProjector",
    "Qwen2Config",
    "Qwen2ForCausalLM",
    "Qwen2Model",
    "fastvithd",
    "fastvithd_tiny",
    "fastvlm_0_5b",
    "fastvlm_1_5b",
    "fastvlm_7b",
    "fastvlm_tiny",
    "init_weights",
    "pool_hidden",
    "pool_last_text_token",
    "qwen2_0_5b",
    "qwen2_1_5b",
    "qwen2_7b",
    "qwen2_tiny",
]
