"""Model-FLOPs accounting and MFU (counterpart of
``vla_fastvlm_tpu/utils/flops.py``).

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over one
call of a *counting twin* of the policy step on the ``meta`` device: the
same modules and shapes, no weights, no execution, no device traffic, so a
count is a function of shapes only. JAX reads XLA's cost model of a
compiled program instead, which counts a scanned layer stack once (hence
its unrolled twin); eager PyTorch runs every layer, so nothing is
undercounted here. ``FlopCounterMode`` counts the products (matmuls,
convolutions, attention) at 2 FLOPs a multiply-add, where XLA also counts
elementwise work; the port's counts are the products alone.

The twin takes the plain paths (``attention_impl="xla"``, the plain
RepMixer) and strips quantization: the hand-written kernels are ``ctypes``
launches that the counter cannot see and the ``meta`` device cannot run,
and model FLOPs are float FLOPs by definition. Each function raises on a
failure: there is no backend without a count.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..device import DeviceLike

# Dense bf16 tensor-core peak by card name, FLOP/s. NVIDIA H100 SXM5 ("NVIDIA
# H100 80GB HBM3"): 989.4 TFLOP/s dense bf16, NVIDIA's H100 datasheet and
# Hopper architecture whitepaper (1,979 TFLOP/s with sparsity).
_PEAK_BF16 = {
    "h100 80gb hbm3": 989.4e12,
}


def device_peak_flops(device: DeviceLike = None) -> Optional[float]:
    """Dense bf16 FLOP/s of ``device`` (the current CUDA card by default), or
    None for the CPU, no card, or a card the table does not know."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in _PEAK_BF16.items():
        if key in name:
            return peak
    return None


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                        _output_padding, _groups, output_mask, out_shape, **kwargs) -> int:
    """Each gradient a convolution's backward computes (input, weight) costs
    the forward's products. torch's own formula leaves ``groups`` out of the
    weight gradient and counts a depthwise one C times over."""
    from torch.utils.flop_counter import conv_flop_count

    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed=transposed)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def counted_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call ``fn(*args, **kwargs)``, counted by ``FlopCounterMode``
    (the counterpart of JAX's ``compiled_flops``)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False,
                              custom_mapping={torch.ops.aten.convolution_backward: _conv_backward_flop})
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def _counting_twin(model):
    """``(FastVLM twin, head twin)`` of a ``FastVLMWithExpert`` on the meta
    device: plain paths, no quantization, no remat, frozen."""
    from ..fastvla.fastvlm_with_expert import build_head
    from ..models.fastvlm import FastVLM

    mcfg = model.backbone.model_config
    mcfg = mcfg.replace(
        text=mcfg.text.replace(attention_impl="xla", quantization="none", remat=False),
        vision=mcfg.vision.replace(block_impl="xla"),
    )
    with torch.device("meta"):
        twin = FastVLM(mcfg)
    head = build_head(model.config, mcfg.text.hidden_size, "meta")
    return twin.eval().requires_grad_(False), head.requires_grad_(False)


def _inputs(model, batch: int, prompt_len: int):
    mcfg = model.backbone.model_config
    if mcfg.num_cameras > 1:
        img_shape = (batch, mcfg.num_cameras, 3, mcfg.image_size, mcfg.image_size)
    else:
        img_shape = (batch, 3, mcfg.image_size, mcfg.image_size)
    dtype = mcfg.text.dtype
    meta = dict(device="meta")
    return (torch.empty(img_shape, dtype=dtype, **meta), torch.empty((batch, prompt_len), dtype=torch.int64, **meta),
            torch.empty((batch, prompt_len), dtype=torch.int32, **meta),
            torch.empty((batch, model.config.state_dim), dtype=dtype, **meta))


def _features(model, twin, images, ids, mask, lora=None):
    from ..models.fastvlm import pool_hidden, pool_last_text_token

    hidden, _seq_mask, text_mask = twin(images, ids, mask, lora=lora)
    if model.backbone.config.image_feature_pool == "mean_pool":
        return pool_hidden(hidden, text_mask, "mean_pool")
    return pool_last_text_token(hidden, text_mask)


def fastvlm_serve_flops(model, batch: int, prompt_len: int) -> float:
    """Model FLOPs of one policy serving step of ``model`` (a
    ``FastVLMWithExpert``) at ``batch`` rows and ``prompt_len`` text tokens:
    the tower, projector, decoder (every layer), pooling and head, counted
    on the meta twin."""
    twin, head = _counting_twin(model)
    images, ids, mask, states = _inputs(model, batch, prompt_len)

    def step():
        with torch.no_grad():
            return head(_features(model, twin, images, ids, mask), states, train=False)

    return counted_flops(step)


def fastvlm_train_flops(model, batch: int, prompt_len: int, train_backbone: bool = False,
                        lora_rank: int = 0) -> float:
    """Model FLOPs of one train step of ``model`` (a ``FastVLMWithExpert``):
    the policy forward, the MSE loss and the gradients of the trainable
    leaves, counted on the meta twin.

    The backbone is frozen (the reference's semantics), so the backward
    touches only the head; ``train_backbone=True`` also differentiates the
    backbone; ``lora_rank > 0`` mounts rank-r adapters on the decoder's
    projections and differentiates head and adapters over the frozen base
    (the backward crosses every frozen decoder product, not the tower). The
    twin has no remat, so the count is *useful* model FLOPs (MFU's
    convention excludes recompute); the optimizer update is left out.
    """
    if lora_rank > 0 and train_backbone:
        raise ValueError("lora_rank > 0 with train_backbone is contradictory")
    twin, head = _counting_twin(model)
    images, ids, mask, states = _inputs(model, batch, prompt_len)
    actions = torch.empty((batch, model.config.action_dim), dtype=torch.float32, device="meta")
    trainable = list(head.requires_grad_(True).parameters())
    lora = None
    if lora_rank > 0:
        from ..io.bridge import flatten_params
        from ..io.lora import init_lora, lora_parameters

        lora = lora_parameters(init_lora(twin, lora_rank, device="meta"))
        trainable += list(flatten_params(lora).values())
    if train_backbone:
        trainable += list(twin.requires_grad_(True).parameters())

    def step():
        preds = head(_features(model, twin, images, ids, mask, lora=lora), states, train=False)
        loss = torch.mean(torch.square(preds - actions.to(preds.dtype)))
        return torch.autograd.grad(loss, trainable)

    return counted_flops(step)


def mfu(flops_per_step: Optional[float], step_time_s: float, n_chips: int = 1,
        device: DeviceLike = None) -> Optional[float]:
    """Fraction of aggregate peak: model FLOPs / (time * chips * peak); None
    without a count, a time or a known peak."""
    peak = device_peak_flops(device)
    if flops_per_step is None or peak is None or step_time_s <= 0:
        return None
    return flops_per_step / (step_time_s * n_chips * peak)
