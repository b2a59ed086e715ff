"""FastVLA policies of the port (MLP head and action-token head): serving forward, loss and training surface."""

from .configuration_fastvla import FastVLAConfig
from .fastvlm_with_expert import FastVLMWithExpert
from .modeling_fastvla import FastVLAPolicy
from .processor_fastvla import FastVLAProcessor
from .token_policy import FastVLMTokenPolicy

__all__ = ["FastVLAConfig", "FastVLAPolicy", "FastVLAProcessor", "FastVLMTokenPolicy", "FastVLMWithExpert"]
