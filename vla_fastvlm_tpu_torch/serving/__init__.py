"""Serving of the port: sequential generation, the dense and paged
continuous-batching servers, speculative decoding over both, and closed-loop
control (the policy runtime and the token-policy server) (counterpart of
``vla_fastvlm_tpu/serving``; the sharded server is not ported yet).
"""

from .continuous_batching import GenerationServer, make_slot_insert
from .generate import build_cache, generate
from .paged_kv import PagedGenerationServer, PagedKVPool
from .policy_runtime import ActionQueuePolicy, BatchedEnvRunner
from .sampling import sample_tokens, speculative_accept, warp_logits
from .speculative import SpeculativeGenerationServer, SpeculativeGenerator, validate_draft_pair
from .speculative_paged import SpeculativePagedGenerationServer
from .token_policy_server import TokenPolicyServer

__all__ = [
    "ActionQueuePolicy",
    "BatchedEnvRunner",
    "GenerationServer",
    "PagedGenerationServer",
    "PagedKVPool",
    "SpeculativeGenerationServer",
    "SpeculativeGenerator",
    "SpeculativePagedGenerationServer",
    "TokenPolicyServer",
    "build_cache",
    "generate",
    "make_slot_insert",
    "sample_tokens",
    "speculative_accept",
    "validate_draft_pair",
    "warp_logits",
]
