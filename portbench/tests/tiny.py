"""A checkout-like folder holding a tiny benchmark: the real cells' mixes
and configurations cut to test size and computed in float32, for runs of
the harness on the CPU."""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ACT, SERVE, TRAIN = "act.tiny", "serve.tiny", "train.tiny"
# The real cells' compared numbers, at limits for float32 at test size.
LIMITS = {ACT: {"act_err": 1e-3}, SERVE: {"tick_err": 1e-3, "token_mismatch": 0}, TRAIN: {"grad_err": 1e-3, "delta_err": 5e-2}}


def tiny_config() -> dict:
    base = json.loads((HERE / "configs" / "fastvla-0.5b.json").read_text())
    cfg = dict(base, name="tiny", vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, intermediate_size=128, mm_hidden_size=96, port_preset="fastvlm-tiny")
    cfg["vision_config"] = dict(base["vision_config"], embed_dims=[8, 16, 24, 32, 48], depths=[1, 1, 1, 1, 1],
                                attn_head_dim=16, image_size=64)
    cfg["action_head"] = dict(base["action_head"], hidden_dim=32, fusion_dim=32)
    return cfg


def tiny_traffic() -> dict:
    def real(name):
        return json.loads((HERE / "traffic" / f"{name}.json").read_text())

    f32 = {"dtype": "float32"}
    act = dict(real("act.b128-256px"), robots=4, frame_hw=[48, 64], image_size=64, param_dtype="float32",
               observation_batches=2, check_ticks=2, profile_ticks=2, **f32)
    serve = dict(real("serve.slots256-img1024"), slots=4, max_new_tokens=8, prefill_batch=2, image_size=64,
                 prompt_min=4, prompt_max=16, prompt_buckets=[8, 16], frames=3, check_requests=2, tick_slots=4,
                 profile_cycles=1,
                 **f32)
    train = dict(real("train.full-b64-512px"), batch=4, frame_hw=[48, 64], image_size=64, param_dtype="float32",
                 learning_rate=1e-3, max_steps=1000, prefetch_batches=1, batches=3, reference_rows=2,
                 profile_steps=1, **f32)
    return {ACT: act, SERVE: serve, TRAIN: train}


def tiny_root(root: Path) -> dict:
    """Write the tiny benchmark under ``root``; returns its spec."""
    real = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    (root / "portbench" / "configs").mkdir(parents=True, exist_ok=True)
    (root / "portbench" / "traffic").mkdir(exist_ok=True)
    (root / "portbench" / "limits").mkdir(exist_ok=True)
    (root / "portbench" / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    for name, traffic in tiny_traffic().items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        (root / "portbench" / "limits" / f"{name}.json").write_text(json.dumps(LIMITS[name]))
    renamed = {"act.fastvla-0.5b.b128-256px": ACT, "serve.fastvlm-7b.slots256-img1024": SERVE,
               "train.fastvla-0.5b.full-b64-512px": TRAIN}
    spec = dict(real, configs=[{"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                                "reduced": [], "why": "test"}])
    spec["workloads"] = [dict(w, name=renamed[w["name"]], config="tiny", traffic=renamed[w["name"]])
                         for w in real["workloads"]]
    for group in ("end_to_end", "per_layer"):
        spec[group] = [dict(m, workloads=[renamed[w] for w in m["workloads"]]) if "workloads" in m else m
                       for m in real[group]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec
