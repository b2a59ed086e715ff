"""Serving of the port: sequential generation, the dense and paged
continuous-batching servers, and speculative decoding over both
(counterpart of ``vla_fastvlm_tpu/serving``; the policy runtime, the token
server and the sharded server are not ported yet).
"""

from .continuous_batching import GenerationServer, make_slot_insert
from .generate import build_cache, generate
from .paged_kv import PagedGenerationServer, PagedKVPool
from .sampling import sample_tokens, speculative_accept, warp_logits
from .speculative import SpeculativeGenerationServer, SpeculativeGenerator, validate_draft_pair
from .speculative_paged import SpeculativePagedGenerationServer

__all__ = [
    "GenerationServer",
    "PagedGenerationServer",
    "PagedKVPool",
    "SpeculativeGenerationServer",
    "SpeculativeGenerator",
    "SpeculativePagedGenerationServer",
    "build_cache",
    "generate",
    "make_slot_insert",
    "sample_tokens",
    "speculative_accept",
    "validate_draft_pair",
    "warp_logits",
]
