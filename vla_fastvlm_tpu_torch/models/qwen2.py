"""Qwen2 decoder (counterpart of ``vla_fastvlm_tpu/models/qwen2.py``).

Same config fields and presets as the JAX module. Differences in form, not
in numbers:

- The JAX ``nn.scan`` over layers is an ``nn.ModuleList`` loop here, and
  ``nn.remat(Qwen2Block)`` (``cfg.remat``) is
  ``torch.utils.checkpoint.checkpoint`` around each block of that loop,
  taken when autograd records the prefill (training): the block's forward,
  flash launches included, runs again in the backward pass.
- q/k/v are stored as one fused ``qkv_proj`` (q, k, v order) and gate/up as
  one ``gate_up_proj`` (gate, up order): the JAX package concatenates them
  at apply time when ``fused_projections`` is on (``qwen2.py:224-228,368-371``);
  the weight bridge concatenates them once instead.
- A dense KV cache (``init_kv_cache``) is written in place: the forward
  returns the same ``k``/``v`` (and scale) buffers with a new mask and
  cursor, where JAX returns new buffers.
- Weight quantization ("int8", "int4", "w8a8") is a transform of the built
  model, ``io/quantize.py::quantize_params``, which swaps the projections'
  ``Dense`` for ``QuantDense``; with ``quantization == "w8a8"`` they take
  the int8 x int8 product (``ops/quant.py``). The LoRA deltas add to the
  quantized product's output, from the same float input.
  ``kv_cache_quantization`` "int8" stores the KV cache in int8.
- LoRA adapters (``io/lora.py``) mount through ``lora=`` on every forward,
  on all three attention paths and under remat: the tree holds each site's
  ``(L, ...)`` tensors, cast to the compute dtype (and, for multi-LoRA,
  gathered by the rows' ids) once a call for all layers, and each block
  gets its layer's views. The q/k/v and gate/up deltas add after the fused
  output is split, the bias staying in the base output as in JAX. With
  ``lora=None`` nothing of it runs.

Three attention paths, as in JAX: prefill without a cache takes the
structured mask (``ops.attention.attention``, the flash kernel on the card);
a dense cache takes the additive-bias plain path; a paged pool
(``cache["pool_k"]``) takes ``ops.attention.paged_attention``, the paged
decode kernel on the card, and returns the new rows instead of writing the
pool.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention, make_attention_bias, paged_attention
from ..ops.norms import rms_norm
from ..ops.quant import dequantize_kv, quantize_kv
from ..ops.rope import apply_rope, rope_cos_sin
from ..parallel.sharding import copy_to_model, gather_from_model, reduce_from_model, tp_lora_site
from .layers import Dense, Embed

# The decoder layer's seven LoRA sites (io/lora.py), JAX's projection names,
# by the sub-module that holds them.
LORA_SITE_PARENTS = {"q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn", "o_proj": "self_attn",
                     "gate_proj": "mlp", "up_proj": "mlp", "down_proj": "mlp"}


def layer_loras(lora: Optional[dict], num_layers: int, dtype: torch.dtype) -> list:
    """A decoder's adapter tree (``{"layers": {"self_attn": {site: {"a",
    "b"[, "ids"]}}, "mlp": {...}}}``) -> one ``{site: (a, b)}`` per layer, or
    ``None`` each without adapters. Per call and site: one cast of the
    ``(L, ...)`` tensors to ``dtype`` (a no-op when a server stored them in
    it) and, with ``ids``, one gather of each row's adapter over the
    adapter axis, ``(L, N, in, r)`` -> ``(L, B, in, r)``; the layers take
    views of those."""
    if lora is None:
        return [None] * num_layers
    sites = {}
    for parent, node in lora.get("layers", {}).items():
        for name, site in node.items():
            if LORA_SITE_PARENTS.get(name) != parent:
                raise ValueError(f"unknown LoRA site {parent}.{name}")
            a, b = site["a"], site["b"]
            if "ids" in site:
                a, b = a.index_select(1, site["ids"]), b.index_select(1, site["ids"])
            sites[name] = (a.to(dtype), b.to(dtype))
    return [{name: (a[i], b[i]) for name, (a, b) in sites.items()} for i in range(num_layers)]


def lora_delta(y: torch.Tensor, x: torch.Tensor, site) -> torch.Tensor:
    """``y + (x @ A) @ B`` in ``y``'s dtype (JAX ``models/qwen2.py::_lora_delta``):
    ``x @ A`` is rounded there, then ``y + h @ B``. ``site`` is ``(A, B)``,
    ``(in, r)``/``(r, out)`` for one adapter or ``(B, in, r)``/``(B, r, out)``
    with each batch row's own (multi-LoRA); ``None`` leaves ``y``."""
    if site is None:
        return y
    a, b = site
    x = x.to(y.dtype)
    if a.ndim == 3:
        return y + torch.bmm(torch.bmm(x, a), b)
    return y + (x @ a) @ b


def lm_head_logits(lm_head: nn.Module, hidden: torch.Tensor) -> torch.Tensor:
    """An untied LM head's logits; split by vocabulary on a mesh
    (``lm_head.tp_group``), each rank's piece all-gathered."""
    group = getattr(lm_head, "tp_group", None)
    return gather_from_model(lm_head(copy_to_model(hidden, group)), group)


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151936
    hidden_size: int = 896
    num_hidden_layers: int = 24
    num_attention_heads: int = 14
    num_key_value_heads: int = 2
    intermediate_size: int = 4864
    head_dim: Optional[int] = None
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 32768
    # runtime knobs (not part of the checkpoint contract)
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    # JAX-only layout knobs, kept for config parity: the port always loops
    # an nn.ModuleList and always stores fused projections.
    scan_layers: bool = True
    remat: bool = False
    attention_impl: str = "auto"  # "auto" | "xla" | "flash"
    fused_projections: bool = True
    quantization: str = "none"  # "none" | "int8" | "int4" | "w8a8" (io/quantize.py)
    kv_cache_quantization: str = "none"  # "none" | "int8"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    def replace(self, **kw) -> "Qwen2Config":
        return dataclasses.replace(self, **kw)


def lora_site_fans(cfg: Qwen2Config) -> dict:
    """Fan-in and fan-out of each LoRA site's projection (JAX's unfused ``kernel`` shapes)."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_attention_heads * cfg.resolved_head_dim, cfg.num_key_value_heads * cfg.resolved_head_dim
    return {"q_proj": (h, q), "k_proj": (h, kv), "v_proj": (h, kv), "o_proj": (q, h), "gate_proj": (h, i),
            "up_proj": (h, i), "down_proj": (i, h)}


def qwen2_0_5b(**kw) -> Qwen2Config:
    return Qwen2Config(**kw)


def qwen2_1_5b(**kw) -> Qwen2Config:
    return Qwen2Config(
        hidden_size=1536, num_hidden_layers=28, num_attention_heads=12,
        num_key_value_heads=2, intermediate_size=8960, **kw,
    )


def qwen2_7b(**kw) -> Qwen2Config:
    return Qwen2Config(
        vocab_size=152064, hidden_size=3584, num_hidden_layers=28,
        num_attention_heads=28, num_key_value_heads=4, intermediate_size=18944,
        tie_word_embeddings=False, **kw,
    )


def qwen2_tiny(**kw) -> Qwen2Config:
    """Small config for tests."""
    return Qwen2Config(
        vocab_size=512, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        **kw,
    )


def _check_supported(cfg: Qwen2Config) -> None:
    if cfg.quantization not in ("none", "int8", "int4", "w8a8"):
        raise ValueError(f"unknown quantization {cfg.quantization!r}")
    if cfg.kv_cache_quantization not in ("none", "int8"):
        raise ValueError(f"unknown kv_cache_quantization {cfg.kv_cache_quantization!r}")


def init_kv_cache(cfg: Qwen2Config, batch_size: int, max_len: int, dtype: Optional[torch.dtype] = None,
                  device=None) -> dict:
    """Dense KV cache: stacked per-layer key/value buffers (L, B, S, K, D),
    the (B, S) valid-position mask and the (B,) per-example write cursors.

    With ``cfg.kv_cache_quantization == "int8"`` the K/V buffers are int8
    with per-(position, kv-head) float32 scales ``k_scale``/``v_scale``
    (L, B, S, K), quantized at write and dequantized at read
    (``ops/quant.py``).
    """
    dtype = dtype or cfg.dtype
    shape = (cfg.num_hidden_layers, batch_size, max_len, cfg.num_key_value_heads, cfg.resolved_head_dim)
    quantized = cfg.kv_cache_quantization == "int8"
    if not quantized and cfg.kv_cache_quantization != "none":
        raise ValueError(f"unknown kv_cache_quantization {cfg.kv_cache_quantization!r}")
    kv_dtype = torch.int8 if quantized else dtype
    cache = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
        "mask": torch.zeros((batch_size, max_len), dtype=torch.bool, device=device),
        "index": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }
    if quantized:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return cache


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=param_dtype))

    def init_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class Qwen2Attention(nn.Module):
    """Self-attention over ``num_heads`` query and ``num_kv_heads`` KV heads:
    the config's, or one rank's share of them once ``parallel/sharding.py``
    placed the module on a mesh (``tp_group``: the ``model`` group, None
    unsharded)."""

    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        n, k, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.resolved_head_dim
        self.num_heads, self.num_kv_heads, self.tp_group = n, k, None
        self.qkv_proj = Dense(cfg.hidden_size, (n + 2 * k) * d, True, cfg.dtype, cfg.param_dtype)
        self.o_proj = Dense(n * d, cfg.hidden_size, False, cfg.dtype, cfg.param_dtype)

    def forward(self, x, kv_mask, cos, sin, causal: bool = True, bias=None, cache=None, lora=None):
        """-> ``(out, new)``. ``lora`` is this layer's ``{site: (A, B)}`` or
        None. ``cache`` is None (prefill), one layer of a dense
        cache (``k``/``v`` (B, S, K, D), ``rows``/``cols`` write positions, int8
        scales) or of a paged pool (``pool_k``/``pool_v`` (P, K, page, D),
        ``tables``, ``mask``, ``index``, int8 scale pools). ``new`` is the
        paged path's new rows ``(k, v, k_scale, v_scale)`` at t == 1 (the
        window axis squeezed), else None."""
        cfg, group = self.cfg, self.tp_group
        b, t, _ = x.shape
        n, kh, d = self.num_heads, self.num_kv_heads, cfg.resolved_head_dim
        x = copy_to_model(x, group)
        q, k, v = self.qkv_proj(x).split([n * d, kh * d, kh * d], dim=-1)
        if lora is not None:
            q, k, v = (lora_delta(y, x, tp_lora_site(lora.get(name), "col", group))
                       for y, name in ((q, "q_proj"), (k, "k_proj"), (v, "v_proj")))
        q, k = apply_rope(q.reshape(b, t, n, d), k.reshape(b, t, kh, d), cos, sin)
        q = q.contiguous()
        v = v.reshape(b, t, kh, d).contiguous()
        new = None
        if cache is None:
            out = attention(
                q, k.to(q.dtype).contiguous(), v.to(q.dtype),
                kv_mask=kv_mask, causal=causal, impl=cfg.attention_impl,
            )
        elif "tables" in cache:
            scales = {}
            if cache.get("pool_k_scale") is not None:
                # int8 pool: quantize the new rows for the server's scatter and
                # attend with their dequant-roundtrip (what the pool will hold).
                k_q, k_s = quantize_kv(k)
                v_q, v_s = quantize_kv(v)
                k, v = dequantize_kv(k_q, k_s, q.dtype), dequantize_kv(v_q, v_s, q.dtype)
                scales = dict(pool_k_scale=cache["pool_k_scale"], pool_v_scale=cache["pool_v_scale"])
                rows = (k_q, v_q, k_s, v_s)
            else:
                rows = (k, v, None, None)
            out = paged_attention(
                q, cache["pool_k"], cache["pool_v"], cache["tables"], cache["mask"], cache["index"],
                k.to(q.dtype).contiguous(), v.to(q.dtype).contiguous(), impl=cfg.attention_impl, **scales,
            )
            new = tuple(r[:, 0] if r is not None and t == 1 else r for r in rows)
        else:
            at = (cache["rows"], cache["cols"])
            if cache["k"].dtype == torch.int8:
                # int8 cache: quantize at write, dequantize the whole window at read.
                k_q, k_s = quantize_kv(k)
                v_q, v_s = quantize_kv(v)
                cache["k"][at], cache["v"][at] = k_q, v_q
                cache["k_scale"][at], cache["v_scale"][at] = k_s, v_s
                k = dequantize_kv(cache["k"], cache["k_scale"], q.dtype)
                v = dequantize_kv(cache["v"], cache["v_scale"], q.dtype)
            else:
                cache["k"][at] = k.to(cache["k"].dtype)
                cache["v"][at] = v.to(cache["v"].dtype)
                k, v = cache["k"], cache["v"]
            out = attention(q, k.to(q.dtype), v.to(q.dtype), bias=bias, causal=causal, impl=cfg.attention_impl)
        out = out.reshape(b, t, n * d)
        proj = self.o_proj(out)
        if lora is not None:
            proj = lora_delta(proj, out, tp_lora_site(lora.get("o_proj"), "row", group))
        return reduce_from_model(proj, group), new


class Qwen2MLP(nn.Module):
    """SwiGLU MLP; on a mesh each rank holds its share of the intermediate
    width and ``tp_group`` sums the down products."""

    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        self.tp_group = None
        self.gate_up_proj = Dense(cfg.hidden_size, 2 * cfg.intermediate_size, False, cfg.dtype, cfg.param_dtype)
        self.down_proj = Dense(cfg.intermediate_size, cfg.hidden_size, False, cfg.dtype, cfg.param_dtype)

    def forward(self, x, lora=None):
        group = self.tp_group
        x = copy_to_model(x, group)
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        if lora is None:
            return reduce_from_model(self.down_proj(F.silu(gate) * up), group)
        site = lambda name, kind: tp_lora_site(lora.get(name), kind, group)  # noqa: E731
        h = F.silu(lora_delta(gate, x, site("gate_proj", "col"))) * lora_delta(up, x, site("up_proj", "col"))
        return reduce_from_model(lora_delta(self.down_proj(h), h, site("down_proj", "row")), group)


class Qwen2Block(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype)
        self.self_attn = Qwen2Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype)
        self.mlp = Qwen2MLP(cfg)

    def forward(self, x, kv_mask, cos, sin, causal: bool = True, bias=None, cache=None, lora=None):
        attn_out, new = self.self_attn(self.input_layernorm(x), kv_mask, cos, sin, causal, bias, cache, lora)
        x = x + attn_out
        return x + self.mlp(self.post_attention_layernorm(x), lora), new


class Qwen2Model(nn.Module):
    """Decoder stack: embeddings + blocks + final norm.

    ``forward`` returns ``(hidden, new_cache, logits)`` like the JAX module;
    logits are the tied-embedding logits when ``compute_tied_logits`` is set,
    else None. ``new_cache`` is None without a cache; for a dense cache it is
    the cache with its buffers written in place, the updated mask and the
    cursors advanced by t; for a paged pool it is the new rows
    ``{"k_rows", "v_rows"}`` (L, B, K, D) (+ ``{"k_scale_rows",
    "v_scale_rows"}`` (L, B, K) for int8 pools) for the caller to scatter.
    """

    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype, cfg.param_dtype)
        self.layers = nn.ModuleList(Qwen2Block(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,  # (B, T)
        inputs_embeds: Optional[torch.Tensor] = None,  # (B, T, H)
        attention_mask: Optional[torch.Tensor] = None,  # (B, T) 1 = real token
        positions: Optional[torch.Tensor] = None,  # (B, T)
        cache: Optional[dict] = None,
        causal: bool = True,
        compute_tied_logits: bool = False,
        lora: Optional[dict] = None,
    ):
        """``lora``: this decoder's adapter tree (``io/lora.py``, the
        ``language_model`` sub-tree of a ``FastVLM``'s), or None."""
        cfg = self.cfg
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        x = inputs_embeds.to(cfg.dtype)
        b, t, _ = x.shape
        dev = x.device
        if attention_mask is None:
            attention_mask = torch.ones((b, t), dtype=torch.int32, device=dev)
        steps = torch.arange(t, device=dev)[None, :]
        if positions is None:
            if cache is not None:
                # Two position systems: RoPE continues each example's TRUE length
                # (valid cache entries); causality runs on SLOT indices.
                positions = cache["mask"].to(torch.int32).sum(dim=1)[:, None] + steps
            else:
                positions = steps.expand(b, t)
        cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta, cfg.dtype)

        paged = cache is not None and "pool_k" in cache
        bias = None
        layer_caches = [None] * cfg.num_hidden_layers
        if paged:
            kv_mask = cache["mask"].to(torch.int32)
            for i in range(cfg.num_hidden_layers):
                layer_caches[i] = {
                    "pool_k": cache["pool_k"][i], "pool_v": cache["pool_v"][i],
                    "tables": cache["tables"], "mask": kv_mask, "index": cache["index"],
                    "pool_k_scale": cache["pool_k_scale"][i] if "pool_k_scale" in cache else None,
                    "pool_v_scale": cache["pool_v_scale"][i] if "pool_v_scale" in cache else None,
                }
        elif cache is not None:
            s = cache["k"].shape[2]
            slots = cache["index"].long()[:, None] + steps  # (B, t) slot of each new token
            # Writes start at most at s - t, as JAX's dynamic_update_slice
            # clamps them: only rows that stopped generating (cursors pinned
            # or running on) ever reach the end, and their outputs are dropped.
            cols = cache["index"].long().clamp(max=s - t)[:, None] + steps
            rows = torch.arange(b, device=dev)[:, None].expand(b, t)
            kv_mask = cache["mask"].to(torch.int32).clone()
            kv_mask[rows, cols] = attention_mask.to(torch.int32)
            kv_positions = torch.arange(s, device=dev)[None, :].expand(b, s)
            bias = make_attention_bias(slots, kv_positions, kv_mask, causal=causal)
            for i in range(cfg.num_hidden_layers):
                layer_caches[i] = {"k": cache["k"][i], "v": cache["v"][i], "rows": rows, "cols": cols}
                if "k_scale" in cache:
                    layer_caches[i].update(k_scale=cache["k_scale"][i], v_scale=cache["v_scale"][i])
        else:
            kv_mask = attention_mask.to(torch.int32)

        # The decoder draws no random numbers, so remat need not restore the RNG.
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        news = []
        loras = layer_loras(lora, cfg.num_hidden_layers, cfg.dtype)
        for layer, layer_cache, layer_lora in zip(self.layers, layer_caches, loras):
            if remat:
                x, new = checkpoint(layer, x, kv_mask, cos, sin, causal, bias, layer_cache, layer_lora,
                                    use_reentrant=False, preserve_rng_state=False)
            else:
                x, new = layer(x, kv_mask, cos, sin, causal, bias, layer_cache, layer_lora)
            news.append(new)
        x = self.norm(x)

        new_cache = None
        if paged:
            new_cache = {"k_rows": torch.stack([n[0] for n in news]), "v_rows": torch.stack([n[1] for n in news])}
            if news[0][2] is not None:
                new_cache["k_scale_rows"] = torch.stack([n[2] for n in news])
                new_cache["v_scale_rows"] = torch.stack([n[3] for n in news])
        elif cache is not None:
            new_cache = dict(cache, mask=kv_mask.bool(), index=cache["index"] + t)
        logits = self.embed_tokens.attend(x) if compute_tied_logits else None
        return x, new_cache, logits


class Qwen2ForCausalLM(nn.Module):
    """LM head on top of Qwen2Model (tied embeddings for 0.5B/1.5B)."""

    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        self.model = Qwen2Model(cfg)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, False, cfg.dtype, cfg.param_dtype)

    def forward(self, input_ids=None, inputs_embeds=None, attention_mask=None,
                positions=None, cache=None, causal: bool = True, lora=None):
        """``lora``: an adapter tree of this model (``{"model": {"layers": ...}}``) or None."""
        hidden, new_cache, tied_logits = self.model(
            input_ids=input_ids, inputs_embeds=inputs_embeds,
            attention_mask=attention_mask, positions=positions, cache=cache, causal=causal,
            compute_tied_logits=self.cfg.tie_word_embeddings, lora=lora["model"] if lora else None,
        )
        logits = tied_logits if self.cfg.tie_word_embeddings else lm_head_logits(self.lm_head, hidden)
        return logits, hidden, new_cache
