"""Plain float32 FastVLM / FastVLA: FastViTHD, the mlp2x_gelu projector,
Qwen2, the MLP action head, and a dense KV decode step.

Functions of a weight mapping ``W`` (``reference/weights.py::Weights``, or
any mapping of the same names to float32 tensors) and inputs. No kernels, no
paged cache, no batching tricks: every product is ``x @ w.T`` or
``F.conv2d`` on float32 operands. Run it under ``exact_fp32()`` on the card,
where a float32 product would otherwise take TF32.

``P`` (``Products``) decides how a product's operands are rounded: ``None``
keeps float32; ``FP8()`` rounds both operands to float8 e4m3 with a scale
(per output row for weights, per tensor for activations): the precision
below the configuration's bfloat16, which the control computes in.

Layouts and conventions (the FastVLM checkpoints' and the JAX package's):
NHWC activations in the tower; XLA "SAME" padding; tanh GELU; RMSNorm and
LayerNorm with epsilon 1e-6 (the config's for RMSNorm); RoPE by rotate-half
over the head dimension; causal attention with key padding.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelCfg

FP8_MAX = 448.0


class FP8:
    """Both operands of a product rounded to float8 e4m3, scaled into range
    (straight through for gradients)."""

    @staticmethod
    def _round(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
        scale = amax.clamp_min(1e-30) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (q - x).detach()

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return self._round(w, w.detach().abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True))

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return self._round(x, x.detach().abs().amax())


Products = Optional[FP8]


@contextlib.contextmanager
def exact_fp32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def dense(x, w, b=None, P: Products = None):
    if P is not None:
        x, w = P.act(x), P.weight(w)
    y = x @ w.t()
    return y if b is None else y + b


def gelu(x):
    return F.gelu(x, approximate="tanh")


def _same(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride: int = 1, groups: int = 1, P: Products = None):
    """NHWC conv with XLA "SAME" padding; ``w`` OIHW."""
    if P is not None:
        x, w = P.act(x), P.weight(w)
    k = w.shape[-1]
    xc = x.permute(0, 3, 1, 2)
    ph, pw = _same(xc.shape[2], k, stride), _same(xc.shape[3], k, stride)
    xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(xc, w, b, stride, 0, 1, groups).permute(0, 2, 3, 1)


def layer_norm(x, w, b, eps: float = 1e-6):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


# ---------------------------------------------------------------------------
# FastViTHD


def letterbox(frames, size: int):
    """(B, C, H, W) in [0, 1] -> (B, 3, size, size): scale by the longer side
    (bilinear, half-pixel centres, no antialias), pad at the top and left
    with 0."""
    b, c, h, w = frames.shape
    if c == 1:
        frames = frames.expand(b, 3, h, w)
    frames = frames[:, :3]
    if (h, w) == (size, size):
        return frames
    ratio = max(w / size, h / size)
    rh, rw = int(h / ratio), int(w / ratio)
    resized = F.interpolate(frames, size=(rh, rw), mode="bilinear", align_corners=False, antialias=False)
    return F.pad(resized, (size - rw, 0, size - rh, 0), value=0.0)


def _convffn(W, q, x, P):
    y = conv(x, W[q + "convffn.dw.conv.weight"], W[q + "convffn.dw.conv.bias"], 1, x.shape[-1], P)
    y = gelu(dense(y, W[q + "convffn.fc1.conv.weight"], W[q + "convffn.fc1.conv.bias"], P))
    return dense(y, W[q + "convffn.fc2.conv.weight"], W[q + "convffn.fc2.conv.bias"], P)


def repmixer_block(W, q, x, P: Products = None):
    x = conv(x, W[q + "token_mixer.conv.weight"], W[q + "token_mixer.conv.bias"], 1, x.shape[-1], P)
    return x + W[q + "layer_scale.gamma"] * _convffn(W, q, x, P)


def attention_block(W, q, x, head_dim: int, P: Products = None):
    b, h, w, c = x.shape
    xn = x * W[q + "norm.weight"] + W[q + "norm.bias"]
    qkv = dense(xn.reshape(b, h * w, c), W[q + "token_mixer.qkv.weight"], None, P)
    heads = c // head_dim
    qh, kh, vh = (t.reshape(b, h * w, heads, head_dim) for t in qkv.chunk(3, dim=-1))
    att = torch.softmax(torch.einsum("btnd,bsnd->bnts", qh, kh) * head_dim ** -0.5, dim=-1)
    out = torch.einsum("bnts,bsnd->btnd", att, vh).reshape(b, h * w, c)
    out = dense(out, W[q + "token_mixer.proj.weight"], W[q + "token_mixer.proj.bias"], P).reshape(b, h, w, c)
    x = x + W[q + "layer_scale_1.gamma"] * out
    return x + W[q + "layer_scale_2.gamma"] * _convffn(W, q, x, P)


def tower(W, cfg: ModelCfg, images, P: Products = None):
    """(B, 3, S, S) -> (B, (S / 64)^2, mm_hidden_size) tokens, row-major."""
    v = cfg.vision
    p = "vision_tower."
    x = images.permute(0, 2, 3, 1)
    x = gelu(conv(x, W[p + "stem_0.conv.weight"], W[p + "stem_0.conv.bias"], 2, 1, P))
    x = gelu(conv(x, W[p + "stem_1.conv.weight"], W[p + "stem_1.conv.bias"], 2, x.shape[-1], P))
    x = gelu(dense(x, W[p + "stem_2.conv.weight"], W[p + "stem_2.conv.bias"], P))
    prev = v.embed_dims[0]
    for s, (c, depth, mixer, cpe) in enumerate(zip(v.embed_dims, v.depths, v.token_mixers, v.pos_embs)):
        if s > 0:
            q = f"{p}patch_embed_{s}."
            x = gelu(conv(x, W[q + "large_kernel.conv.weight"], W[q + "large_kernel.conv.bias"], 2,
                          math.gcd(prev, c), P))
            x = gelu(dense(x, W[q + "pointwise.conv.weight"], W[q + "pointwise.conv.bias"], P))
        if cpe:
            q = f"{p}pos_emb_{s}."
            x = conv(x, W[q + "conv.weight"], W[q + "conv.bias"], 1, c, P)
        for i in range(depth):
            q = f"{p}stage{s}_block{i}."
            x = repmixer_block(W, q, x, P) if mixer == "repmixer" else attention_block(W, q, x, v.attn_head_dim, P)
        prev = c
    x = gelu(conv(x, W[p + "conv_exp.conv.weight"], W[p + "conv_exp.conv.bias"], 1, prev, P))
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c)


def projector(W, x, P: Products = None):
    x = gelu(dense(x, W["mm_projector.fc1.weight"], W["mm_projector.fc1.bias"], P))
    return dense(x, W["mm_projector.fc2.weight"], W["mm_projector.fc2.bias"], P)


# ---------------------------------------------------------------------------
# Qwen2


def rope(x, positions, theta: float):
    """x (B, T, heads, D), positions (B, T)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    f = positions.float()[..., None] * inv
    emb = torch.cat([f, f], dim=-1)[:, :, None, :]
    half = d // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * emb.cos() + rotated * emb.sin()


def _qkv(W, q, cfg: ModelCfg, x, positions, P):
    t = cfg.text
    b, n = x.shape[0], x.shape[1]
    d = t.head_dim
    qh = dense(x, W[q + "self_attn.q_proj.weight"], W[q + "self_attn.q_proj.bias"], P).reshape(b, n, -1, d)
    kh = dense(x, W[q + "self_attn.k_proj.weight"], W[q + "self_attn.k_proj.bias"], P).reshape(b, n, -1, d)
    vh = dense(x, W[q + "self_attn.v_proj.weight"], W[q + "self_attn.v_proj.bias"], P).reshape(b, n, -1, d)
    return rope(qh, positions, t.rope_theta), rope(kh, positions, t.rope_theta), vh


def _attend(qh, kh, vh, allowed):
    """qh (B, T, N, D), kh / vh (B, S, K, D), allowed (B, T, S) -> (B, T, N * D)."""
    rep = qh.shape[2] // kh.shape[2]
    kh, vh = kh.repeat_interleave(rep, dim=2), vh.repeat_interleave(rep, dim=2)
    logits = torch.einsum("btnd,bsnd->bnts", qh, kh) * qh.shape[-1] ** -0.5
    logits = logits.masked_fill(~allowed[:, None], float("-inf"))
    out = torch.einsum("bnts,bsnd->btnd", torch.softmax(logits, dim=-1), vh)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _mlp(W, q, x, P):
    g = dense(x, W[q + "mlp.gate_proj.weight"], None, P)
    u = dense(x, W[q + "mlp.up_proj.weight"], None, P)
    return dense(F.silu(g) * u, W[q + "mlp.down_proj.weight"], None, P)


def decoder_layer(W, layer: int, cfg: ModelCfg, x, positions, key_mask, P: Products = None):
    """One Qwen2 block over the whole sequence: causal, keys masked by
    ``key_mask`` (B, T) where 0."""
    q = f"language_model.layers.{layer}."
    eps = cfg.text.rms_norm_eps
    qh, kh, vh = _qkv(W, q, cfg, rms_norm(x, W[q + "input_layernorm.weight"], eps), positions, P)
    t = x.shape[1]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    allowed = causal[None] & key_mask.bool()[:, None, :]
    x = x + dense(_attend(qh, kh, vh, allowed), W[q + "self_attn.o_proj.weight"], None, P)
    return x + _mlp(W, q, rms_norm(x, W[q + "post_attention_layernorm.weight"], eps), P)


def decode_layer(W, layer: int, cfg: ModelCfg, x, position, cache_k, cache_v, P: Products = None):
    """One Qwen2 block for one new token per row against a dense cache:
    ``x`` (B, 1, H), ``position`` (B, 1), ``cache_k`` / ``cache_v`` (B, S, K, D)
    of the S earlier positions. Returns the new hidden state and the new
    row's (k, v)."""
    q = f"language_model.layers.{layer}."
    eps = cfg.text.rms_norm_eps
    qh, kh, vh = _qkv(W, q, cfg, rms_norm(x, W[q + "input_layernorm.weight"], eps), position, P)
    keys, values = torch.cat([cache_k, kh], dim=1), torch.cat([cache_v, vh], dim=1)
    allowed = torch.ones(x.shape[0], 1, keys.shape[1], dtype=torch.bool, device=x.device)
    x = x + dense(_attend(qh, keys, values, allowed), W[q + "self_attn.o_proj.weight"], None, P)
    return x + _mlp(W, q, rms_norm(x, W[q + "post_attention_layernorm.weight"], eps), P), (kh, vh)


def embed(W, ids):
    return W["language_model.embed_tokens.weight"][ids.long()]


def final_norm(W, cfg: ModelCfg, x):
    return rms_norm(x, W["language_model.norm.weight"], cfg.text.rms_norm_eps)


def lm_logits(W, cfg: ModelCfg, h, P: Products = None):
    name = "language_model.embed_tokens.weight" if cfg.text.tie_word_embeddings else "lm_head.weight"
    return dense(h, W[name], None, P)


# ---------------------------------------------------------------------------
# the policy


def action_head(W, feats, states, P: Products = None):
    s = layer_norm(states, W["head.state_norm.weight"], W["head.state_norm.bias"])
    s = F.silu(dense(s, W["head.state_proj.weight"], W["head.state_proj.bias"], P))
    f = dense(torch.cat([feats, s], dim=-1), W["head.fusion_fc1.weight"], W["head.fusion_fc1.bias"], P)
    f = F.silu(layer_norm(f, W["head.fusion_norm.weight"], W["head.fusion_norm.bias"]))
    f = F.silu(dense(f, W["head.fusion_fc2.weight"], W["head.fusion_fc2.bias"], P))
    return dense(f, W["head.action_head.weight"], W["head.action_head.bias"], P)


def policy_actions(W, cfg: ModelCfg, frames, ids, mask, states, image_size: int, P: Products = None):
    """FastVLA with the MLP head: frames (B, 3, H, W) in [0, 1], task ids and
    mask (B, T) right-padded, states (B, state_dim) -> (B, action_dim).
    Features are the final-norm hidden state at the last text token."""
    img = projector(W, tower(W, cfg, letterbox(frames, image_size), P), P)
    n_img = img.shape[1]
    x = torch.cat([img, embed(W, ids)], dim=1)
    b, t = x.shape[:2]
    key_mask = torch.cat([torch.ones(b, n_img, dtype=mask.dtype, device=mask.device), mask], dim=1)
    positions = torch.arange(t, device=x.device)[None].expand(b, t)
    for layer in range(cfg.text.num_hidden_layers):
        x = decoder_layer(W, layer, cfg, x, positions, key_mask, P)
    x = final_norm(W, cfg, x)
    last = n_img + mask.long().sum(dim=1) - 1
    feats = x[torch.arange(b, device=x.device), last]
    return action_head(W, feats, states, P)
