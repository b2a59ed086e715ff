"""FastVLA policy of the port (serving forward)."""

from .configuration_fastvla import FastVLAConfig
from .fastvlm_with_expert import FastVLMWithExpert
from .modeling_fastvla import FastVLAPolicy
from .processor_fastvla import FastVLAProcessor

__all__ = ["FastVLAConfig", "FastVLAPolicy", "FastVLAProcessor", "FastVLMWithExpert"]
