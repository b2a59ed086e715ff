"""Backbone adapter of the port."""

from .fastvlm_adapter import FastVLMBackbone, FastVLMBackboneConfig, prepare_policy_images

__all__ = ["FastVLMBackbone", "FastVLMBackboneConfig", "prepare_policy_images"]
