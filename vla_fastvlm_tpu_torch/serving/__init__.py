"""Serving of the port: sequential generation, the dense and paged
continuous-batching servers, speculative decoding over both, closed-loop
control (the policy runtime and the token-policy server), and the
mesh-sharded policy step and generation (counterpart of
``vla_fastvlm_tpu/serving``).
"""

from .continuous_batching import GenerationServer, make_slot_insert
from .generate import build_cache, generate
from .paged_kv import PagedGenerationServer, PagedKVPool
from .policy_runtime import ActionQueuePolicy, BatchedEnvRunner
from .sampling import sample_tokens, speculative_accept, warp_logits
from .sharded import ShardedPolicyRuntime, sharded_generate
from .speculative import SpeculativeGenerationServer, SpeculativeGenerator, validate_draft_pair
from .speculative_paged import SpeculativePagedGenerationServer
from .token_policy_server import TokenPolicyServer

__all__ = [
    "ActionQueuePolicy",
    "BatchedEnvRunner",
    "GenerationServer",
    "PagedGenerationServer",
    "PagedKVPool",
    "ShardedPolicyRuntime",
    "SpeculativeGenerationServer",
    "SpeculativeGenerator",
    "SpeculativePagedGenerationServer",
    "TokenPolicyServer",
    "build_cache",
    "generate",
    "make_slot_insert",
    "sample_tokens",
    "sharded_generate",
    "speculative_accept",
    "validate_draft_pair",
    "warp_logits",
]
