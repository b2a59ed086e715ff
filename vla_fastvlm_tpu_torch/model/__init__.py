"""Backbone adapter of the port and the legacy policy."""

from .fastvlm_adapter import FastVLMBackbone, FastVLMBackboneConfig, prepare_policy_images, resize_with_pad
from .policy import FastVLMPolicy, FastVLMPolicyConfig

__all__ = [
    "FastVLMBackbone",
    "FastVLMBackboneConfig",
    "FastVLMPolicy",
    "FastVLMPolicyConfig",
    "prepare_policy_images",
    "resize_with_pad",
]
