"""Model FLOPs of the benchmark's own reference, counted by
``torch.utils.flop_counter.FlopCounterMode`` over calls on the ``meta``
device: a function of the configuration and the shapes alone, whatever
the program under test computes. Products count 2 FLOPs a multiply-add
(matmuls, convolutions, the attention einsums); elementwise work is not
counted."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from . import model as R
from .config import ModelCfg
from .weights import Weights

META = torch.device("meta")


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                        _output_padding, _groups, output_mask, out_shape, **kwargs) -> int:
    """A convolution's backward costs the forward's products once for each
    gradient it computes (torch's own formula counts a depthwise weight
    gradient C times over)."""
    from torch.utils.flop_counter import conv_flop_count

    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed=transposed)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def counted(fn: Callable) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False,
                              custom_mapping={torch.ops.aten.convolution_backward: _conv_backward_flop})
    with counter:
        fn()
    return float(counter.get_total_flops())


def _meta_weights(cfg: ModelCfg, requires_grad: bool = False) -> dict:
    w = Weights(cfg, 0, META)
    out = {}
    for name in w.names():
        t = torch.empty(w[name].shape, device=META)
        out[name] = t.requires_grad_(requires_grad)
    return out


def policy_forward(cfg: ModelCfg, batch: int, frame_hw: Sequence[int], image_size: int, text_len: int) -> float:
    """One policy step: letterbox, tower, projector, decoder, head."""
    W = _meta_weights(cfg)
    frames = torch.empty(batch, 3, *frame_hw, device=META)
    ids = torch.zeros(batch, text_len, dtype=torch.long, device=META)
    mask = torch.ones(batch, text_len, dtype=torch.long, device=META)
    states = torch.empty(batch, cfg.head.state_dim, device=META)
    return counted(lambda: R.policy_actions(W, cfg, frames, ids, mask, states, image_size))


def policy_train(cfg: ModelCfg, batch: int, frame_hw: Sequence[int], image_size: int, text_len: int) -> float:
    """One training step's forward and backward into every weight (no
    recompute, no optimizer)."""
    W = _meta_weights(cfg, requires_grad=True)
    frames = torch.empty(batch, 3, *frame_hw, device=META)
    ids = torch.zeros(batch, text_len, dtype=torch.long, device=META)
    mask = torch.ones(batch, text_len, dtype=torch.long, device=META)
    states = torch.empty(batch, cfg.head.state_dim, device=META)
    actions = torch.empty(batch, cfg.head.action_dim, device=META)

    def step():
        preds = R.policy_actions(W, cfg, frames, ids, mask, states, image_size)
        loss = (preds - actions).square().mean()
        torch.autograd.grad(loss, list(W.values()))

    return counted(step)


def image_tokens(cfg: ModelCfg, image_size: int) -> float:
    """Tower and projector over one frame at ``image_size``."""
    W = _meta_weights(cfg)
    img = torch.empty(1, 3, image_size, image_size, device=META)
    return counted(lambda: R.projector(W, R.tower(W, cfg, img)))


def prefill(cfg: ModelCfg, length: int) -> float:
    """The decoder over one sequence of ``length`` positions and the LM head
    at its last position."""
    W = _meta_weights(cfg)
    x = torch.empty(1, length, cfg.text.hidden_size, device=META)
    pos = torch.zeros(1, length, dtype=torch.long, device=META)
    key = torch.ones(1, length, dtype=torch.long, device=META)

    def run():
        h = x
        for layer in range(cfg.text.num_hidden_layers):
            h = R.decoder_layer(W, layer, cfg, h, pos, key)
        R.lm_logits(W, cfg, R.final_norm(W, cfg, h[:, -1:]))

    return counted(run)


def decode(cfg: ModelCfg, context: int) -> float:
    """One decoded token attending ``context`` earlier positions, and the LM head."""
    W = _meta_weights(cfg)
    t = cfg.text
    x = torch.empty(1, 1, t.hidden_size, device=META)
    pos = torch.zeros(1, 1, dtype=torch.long, device=META)
    ck = torch.empty(1, context, t.num_key_value_heads, t.head_dim, device=META)

    def run():
        h = x
        for layer in range(t.num_hidden_layers):
            h, _ = R.decode_layer(W, layer, cfg, h, pos, ck, ck)
        R.lm_logits(W, cfg, R.final_norm(W, cfg, h))

    return counted(run)


def quadratic(fn: Callable[[int], float], points=(64, 320, 576)):
    """``(a, b, c)`` with fn(n) = a + b n + c n^2 through three counts (the
    counts are exact polynomials of the length: products linear in it,
    attention's quadratic)."""
    import numpy as np

    xs = np.array(points, dtype=np.float64)
    ys = np.array([fn(int(n)) for n in points])
    c, b, a = np.polyfit(xs, ys, 2)
    return float(a), float(b), float(c)
