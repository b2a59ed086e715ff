"""Serving of the port: sequential generation and the paged continuous-batching
server (counterpart of ``vla_fastvlm_tpu/serving``; the dense
``GenerationServer``, speculative decoding, the policy runtime and the token
server are not ported yet).
"""

from .generate import build_cache, generate
from .paged_kv import PagedGenerationServer, PagedKVPool
from .sampling import sample_tokens, warp_logits

__all__ = [
    "PagedGenerationServer",
    "PagedKVPool",
    "build_cache",
    "generate",
    "sample_tokens",
    "warp_logits",
]
