"""End-task quality of weight quantization, the port's twin of the
repository's ``scripts/eval_quant_quality.py``.

    python -m vla_fastvlm_tpu_torch.scripts.eval_quant_quality --device cpu --model-id fastvlm-tiny
    python -m vla_fastvlm_tpu_torch.scripts.eval_quant_quality --model-id fastvlm-0.5b --image-size 256

The JAX script's steps and JSON keys, on random weights from ``seed``:

1. Pooled backbone features of a synthetic set (``num_samples`` random
   frames at ``image_size``, one prompt) from the same backbone in float,
   int8, int4 and w8a8 (its token gate lowered to 0, so the int8 x int8
   product is what is measured at any size), and, with ``smooth_alpha >
   0``, w8a8 after SmoothQuant calibrated on the same batch
   (``io/smooth.py``).
2. The action head trained to convergence on the float features
   (full-batch Adam, ``train_steps`` steps).
3. That head's action MSE on each set of features, the relative action and
   feature deltas against float.
4. Generation, the int8 KV cache's surface: greedy tokens and last logits of
   ``gen_batch`` prompts with int8 KV, and with int8 weights and int8 KV,
   against float.

Prints one JSON line and returns it as a dict. ``--device`` is the card
unless ``--device cpu`` is given; without CUDA the script raises.
``--fabricate`` is accepted for the JAX script's flags; the port makes its
weights on the device in every case.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..fastvla import FastVLAConfig, FastVLMWithExpert
from ..io.quantize import quantize_params
from ..io.smooth import collect_norm_absmax, smooth_params_w8a8
from ..ops import quant
from ..serving import generate
from ..utils import configure_logging, parse_cli


@dataclass
class Args:
    model_id: str = "fastvlm-tiny"
    image_size: int = 64
    num_samples: int = 64
    state_dim: int = 8
    action_dim: int = 8
    train_steps: int = 600
    lr: float = 1e-3
    dtype: str = "bfloat16"
    # The card unless "cpu" is asked for.
    device: Optional[str] = "cuda"
    fabricate: bool = False
    # Generation check (the int8 KV cache's end-task surface).
    gen_batch: int = 4
    gen_new_tokens: int = 32
    # SmoothQuant migration strength of the w8a8_smooth column; <= 0 disables.
    smooth_alpha: float = 0.5
    seed: int = 0


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


def main(args: Args) -> dict:
    device = resolve_device(args.device)
    configure_logging()
    rng = np.random.default_rng(args.seed)

    def build(quantization: str, kv: str = "none") -> FastVLMWithExpert:
        return FastVLMWithExpert(FastVLAConfig(
            vlm_model_name=args.model_id, bootstrap_model_name=args.model_id, image_size=args.image_size,
            state_dim=args.state_dim, action_dim=args.action_dim, dtype=args.dtype, param_dtype=args.dtype,
            quantization=quantization, kv_cache_quantization=kv, fabricate_params=args.fabricate, dropout=0.0,
            seed=args.seed,
        ), device=device)

    model_f = build("none")
    models = {"float": model_f, "int8": build("int8"), "int4": build("int4")}
    # A quality probe, not a speed probe: the int8 x int8 product at any size.
    quant.W8A8_MIN_TOKENS = 0
    models["w8a8"] = build("w8a8")

    images = rng.random((args.num_samples, 3, args.image_size, args.image_size), dtype=np.float32)
    states = rng.standard_normal((args.num_samples, args.state_dim)).astype(np.float32)
    actions = rng.standard_normal((args.num_samples, args.action_dim)).astype(np.float32)
    ids, mask = model_f.backbone._prep_text(["insert the peg\n"] * args.num_samples)
    to = model_f.backbone.to_device
    ids, mask = to(np.asarray(ids, np.int32)), to(np.asarray(mask, np.int32))
    imgs = to(images).to(model_f.backbone.model_config.text.dtype)

    t0 = time.perf_counter()
    feats = {}
    with torch.inference_mode():
        for name, m in models.items():
            feats[name] = m.backbone.features_fn(imgs, ids, mask).float().cpu().numpy()
        if args.smooth_alpha > 0:
            # SmoothQuant: calibrate on this batch, fold the outliers into a
            # float copy's weights, then quantize it.
            smoothed = build("none")
            calib = collect_norm_absmax(model_f.backbone.model, imgs, ids, mask)
            smooth_params_w8a8(smoothed.backbone.model, calib, alpha=args.smooth_alpha)
            quantize_params(smoothed.backbone.model, mode="w8a8")
            feats["w8a8_smooth"] = smoothed.backbone.features_fn(imgs, ids, mask).float().cpu().numpy()
            del smoothed
    print(f"[quant-eval] features extracted in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # ---- the head, trained on the FLOAT features (full-batch Adam) ----
    head = model_f.head
    head.requires_grad_(True)
    opt = torch.optim.Adam(head.parameters(), lr=args.lr)
    st, act = to(states), to(actions)
    f32 = to(feats["float"])
    t0 = time.perf_counter()
    loss = None
    for _ in range(args.train_steps):
        opt.zero_grad(set_to_none=True)
        loss = (head(f32, st, train=False).float() - act).square().mean()
        loss.backward()
        opt.step()
    final_loss = float(loss.detach())
    print(f"[quant-eval] head trained {args.train_steps} steps in {time.perf_counter() - t0:.1f}s, "
          f"final train MSE {final_loss:.5f}", file=sys.stderr)

    mse, preds = {}, {}
    with torch.inference_mode():
        for name, f in feats.items():
            p = head(to(f), st, train=False).float()
            mse[name] = float((p - act).square().mean())
            preds[name] = p.cpu().numpy()
    smooth_stats = {}
    if "w8a8_smooth" in feats:
        smooth_stats = {
            "eval_mse_w8a8_smooth": round(mse["w8a8_smooth"], 6),
            "action_rel_delta_w8a8_smooth": round(_rel(preds["w8a8_smooth"], preds["float"]), 6),
            "feature_rel_delta_w8a8_smooth": round(_rel(feats["w8a8_smooth"], feats["float"]), 6),
            "smooth_alpha": args.smooth_alpha,
        }

    # ---- generation: int8 KV, and int8 weights + int8 KV ----
    gb = args.gen_batch
    gen, logits_last = {}, {}
    for name, m in (("float", model_f), ("int8kv", build("none", kv="int8")),
                    ("int8w+int8kv", build("int8", kv="int8"))):
        tokens, logits = generate(m.backbone.model, imgs[:gb], ids[:gb], mask[:gb],
                                  max_new_tokens=args.gen_new_tokens, eos_token_id=-1, return_last_logits=True)
        gen[name] = tokens.cpu().numpy()
        logits_last[name] = logits.float().cpu().numpy()
    summary = {
        "metric": f"int8 end-task quality ({args.model_id}, {args.image_size}px, {args.num_samples} samples)",
        "train_mse_float": round(final_loss, 6),
        "eval_mse_float": round(mse["float"], 6),
        "eval_mse_int8": round(mse["int8"], 6),
        "eval_mse_int4": round(mse["int4"], 6),
        "eval_mse_w8a8": round(mse["w8a8"], 6),
        "action_rel_delta_int8": round(_rel(preds["int8"], preds["float"]), 6),
        "action_rel_delta_int4": round(_rel(preds["int4"], preds["float"]), 6),
        "action_rel_delta_w8a8": round(_rel(preds["w8a8"], preds["float"]), 6),
        "feature_rel_delta_int8": round(_rel(feats["int8"], feats["float"]), 6),
        "feature_rel_delta_int4": round(_rel(feats["int4"], feats["float"]), 6),
        "feature_rel_delta_w8a8": round(_rel(feats["w8a8"], feats["float"]), 6),
        "gen_token_agreement_int8kv": round(float((gen["int8kv"] == gen["float"]).mean()), 4),
        "gen_token_agreement_int8w_int8kv": round(float((gen["int8w+int8kv"] == gen["float"]).mean()), 4),
        "gen_last_logit_mse_int8kv": round(float(np.mean(np.square(logits_last["int8kv"] - logits_last["float"]))),
                                           6),
        **smooth_stats,
        "note": "kv int8 cannot affect the policy step (no KV cache in the serving forward); its surface is generation",
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(parse_cli(Args, prog="python -m vla_fastvlm_tpu_torch.scripts.eval_quant_quality"))
