#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py                 # the full check, about a minute
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler table of one step

Phases, in order; any failure raises and the script exits non-zero:

1. build: both CUDA kernels of ``vla_fastvlm_tpu_torch/csrc`` with ``nvcc``
   for sm_90a, all sources at once.
2. kernels: each kernel against its plain PyTorch version on the same inputs,
   in bf16 at the policy step's shapes (flash with right-padded masks and
   fully padded rows) and in fp32 at a small batch with a tight tolerance;
   flash also at head_dim 128 (the 7B decoder's shape).
3. policy: FastVLA-0.5B at batch 128, 256 px, ``tokenizer_max_length`` 64,
   bf16, full depth, random weights from a seed, driven through
   ``FastVLAPolicy.forward``; outputs (128, 14) and finite; launch counts of
   one step (24 flash, 38 RepMixer); the same observations as tensors
   already on the card give the same actions; the same weights through the plain path
   (``attention_impl="xla"``, ``vision_block_impl="xla"``) agree with it.
4. timing: p50 step time and actions/sec of the kernel path and the plain
   path (in turns), each kernel's time per launch beside its plain version,
   one PyTorch library call where one computes the same function, and the
   least time the card could take for the same work.

Prints the card's name and power limit, a JSON line of the kernels, and as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published dense peaks of one H100 SXM at its 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

BATCH, IMAGE, TEXT_LEN, SEED = 128, 256, 64, 0
# The policy step's kernel shapes at 0.5B (T = 16 image + 64 text tokens).
FLASH_MAIN = dict(b=BATCH, t=80, n=14, kh=2, d=64)
FLASH_7B = dict(b=16, t=80, n=28, kh=4, d=128)
# (B, H, W, C, F) per FastViTHD RepMixer stage at 256 px, with launches per step.
REPMIXER_STAGES = [((BATCH, 64, 64, 96, 384), 2), ((BATCH, 32, 32, 192, 768), 12),
                   ((BATCH, 16, 16, 384, 1536), 24)]

# Kernel against plain version, |kernel - plain| <= ATOL + RTOL * |plain| per element.
# bf16: both sides round at the same points but in another order, so outputs
# of magnitude up to ~4 may differ by a few bf16 ulps (2**-7 at 2..4).
# fp32: only the summation order differs.
TOL = {
    ("flash", "bf16"): (2e-2, 2e-2),
    ("flash", "fp32"): (1e-5, 1e-5),
    ("repmixer", "bf16"): (5e-2, 5e-2),
    ("repmixer", "fp32"): (1e-4, 1e-4),
}
# Kernel path against plain path over the whole bf16 policy: relative L2 error
# of the pooled features and of the actions (bf16 roundings in another order
# through 24 decoder layers and 44 vision blocks).
POLICY_REL_L2 = 3e-2
# Card-resident and numpy observations run the same kernels on the same
# values; only library algorithm choices could differ.
DEVICE_INPUT_REL_L2 = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph and replayed between CUDA events, so the host's launch cost (the
    wrappers' Python, ctypes) does not hide or pad the device time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture (builds, caches)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_close(what: str, out, ref, tol) -> float:
    import torch

    atol, rtol = tol
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape:
        fail(f"{what}: shape {tuple(out.shape)} != plain {tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        fail(f"{what}: non-finite output")
    err = (out - ref).abs()
    bad = err > atol + rtol * ref.abs()
    max_err = float(err.max())
    log(f"  {what}: max_abs_err={max_err:.3e} (atol={atol:g}, rtol={rtol:g}) "
        f"max|plain|={float(ref.abs().max()):.3f}")
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} elements outside tolerance, max_abs_err={max_err:.3e}")
    return max_err


# ---------------------------------------------------------------------------
# inputs

def flash_inputs(b, t, n, kh, d, dtype, seed=0):
    """q/k/v ~ N(0, 1); right-padded key masks of varied length, one row in
    eight entirely padded, as the decoder's prefill mask would never be but
    the kernel must take."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, t, n, d, generator=g).to("cuda", dtype)
    k = torch.randn(b, t, kh, d, generator=g).to("cuda", dtype)
    v = torch.randn(b, t, kh, d, generator=g).to("cuda", dtype)
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[::8] = 0
    mask = (torch.arange(t)[None, :] < lengths[:, None]).to(torch.int32).to("cuda")
    return q, k, v, mask


def repmixer_inputs(b, h, w, c, f, dtype, seed=0):
    """x ~ N(0, 1); dirac-plus-noise depthwise kernels (the init's form, with
    noise so every tap counts), lecun-scaled fc weights, biases and a layer
    scale of 0.5-scale noise so the FFN branch shows in the output."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g) * scale
    w3 = rnd(3, 3, 1, c, scale=0.1)
    w3[1, 1] += 1.0
    w7 = rnd(7, 7, 1, c, scale=0.05)
    w7[3, 3] += 1.0
    args = [rnd(b, h, w, c), w3, rnd(c, scale=0.5), w7, rnd(c, scale=0.5),
            rnd(c, f, scale=c ** -0.5), rnd(f, scale=0.5), rnd(f, c, scale=f ** -0.5),
            rnd(c, scale=0.5), rnd(c, scale=0.5)]
    return [a.to("cuda", dtype) for a in args]


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work

def flash_bound_ms(q, k, v, mask, out, causal=True):
    import torch

    b, t, n, d = q.shape
    s = k.shape[1]
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, mask, out))
    allowed = mask.bool()[:, None, :].expand(b, t, s)
    if causal:
        allowed = allowed & torch.ones(t, s, dtype=torch.bool, device=q.device).tril()[None]
    # Each allowed (query, key) pair costs a dot of D for the logit and D for P.V.
    pairs = int(allowed.sum()) * n
    flops = 4 * d * pairs
    return _bound(nbytes, flops)


def repmixer_bound_ms(args, out):
    x, w1 = args[0], args[5]
    bsz, h, w, c = x.shape
    f = w1.shape[1]
    nbytes = sum(a.numel() * a.element_size() for a in args) + out.numel() * out.element_size()
    flops = bsz * h * w * (2 * c * (9 + 49) + 4 * c * f)
    return _bound(nbytes, flops)


def _bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases

def phase_build():
    from vla_fastvlm_tpu_torch.ops.kernels import _build

    log("[1/4] build")
    t0 = time.perf_counter()
    logs = _build.build(["flash_attention", "repmixer"])
    for name, text in logs.items():
        usage = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: " + (" | ".join(usage) if usage else "built"))
    log(f"  built in {time.perf_counter() - t0:.1f} s")


def phase_kernels():
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import (
        flash_attention, flash_attention_reference, repmixer_block, repmixer_block_reference,
    )

    log("[2/4] kernels against their plain versions")
    errs = {"flash_attention": 0.0, "repmixer_block": 0.0}
    cases = [
        ("flash bf16 main", FLASH_MAIN, torch.bfloat16, "bf16"),
        ("flash bf16 d128", FLASH_7B, torch.bfloat16, "bf16"),
        ("flash fp32 d64", dict(FLASH_MAIN, b=4), torch.float32, "fp32"),
        ("flash fp32 d128", dict(FLASH_7B, b=2), torch.float32, "fp32"),
    ]
    for what, shape, dtype, kind in cases:
        q, k, v, mask = flash_inputs(**shape, dtype=dtype)
        out = flash_attention(q, k, v, mask, True)
        torch.cuda.synchronize()
        err = check_close(what, out, flash_attention_reference(q, k, v, mask, True), TOL[("flash", kind)])
        if kind == "bf16" and shape is FLASH_MAIN:
            errs["flash_attention"] = err
    for (shape, _), small_c in zip(REPMIXER_STAGES, (True, True, False)):
        b, h, w, c, f = shape
        args = repmixer_inputs(*shape, torch.bfloat16)
        out = repmixer_block(*args)
        torch.cuda.synchronize()
        err = check_close(f"repmixer bf16 {shape}", out, repmixer_block_reference(*args),
                          TOL[("repmixer", "bf16")])
        errs["repmixer_block"] = max(errs["repmixer_block"], err)
        if small_c:  # fp32 tiles of C=384 exceed one block's shared memory
            args = repmixer_inputs(2, h, w, c, f, torch.float32)
            out = repmixer_block(*args)
            torch.cuda.synchronize()
            check_close(f"repmixer fp32 {(2, h, w, c, f)}", out, repmixer_block_reference(*args),
                        TOL[("repmixer", "fp32")])
    # An odd size exercises the ragged edge tiles of the 8x8 pixel grid.
    args = repmixer_inputs(3, 12, 20, 96, 384, torch.float32)
    check_close("repmixer fp32 ragged (3, 12, 20, 96, 384)", repmixer_block(*args),
                repmixer_block_reference(*args), TOL[("repmixer", "fp32")])
    return errs


def policy_inputs():
    import numpy as np

    rng = np.random.default_rng(SEED)
    images = rng.random((BATCH, 3, IMAGE, IMAGE), dtype=np.float32)
    states = rng.standard_normal((BATCH, 14)).astype(np.float32)
    verbs = ["pick up", "push", "open", "close", "stack", "insert", "fold", "wipe"]
    objects = ["the red block", "the drawer", "the blue cup on the left plate",
               "the towel", "the peg into the hole", "the lid of the box"]
    tasks = [f"{verbs[i % len(verbs)]} {objects[i % len(objects)]}" for i in range(BATCH)]
    return images, states, tasks


def build_policy(attention_impl: str, vision_block_impl: str):
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy

    cfg = FastVLAConfig(
        vlm_model_name="fastvlm-0.5b", bootstrap_model_name="fastvlm-0.5b",
        image_size=IMAGE, tokenizer_max_length=TEXT_LEN, dtype="bfloat16",
        param_dtype="bfloat16", dropout=0.0, attention_impl=attention_impl,
        vision_block_impl=vision_block_impl, seed=SEED,
    )
    return FastVLAPolicy(cfg)


def phase_policy():
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    log("[3/4] FastVLA-0.5B policy, batch 128, 256 px, bf16, full depth")
    t0 = time.perf_counter()
    policy = build_policy("auto", "auto")
    plain = build_policy("xla", "xla")
    plain.model.backbone.model.load_state_dict(policy.model.backbone.model.state_dict())
    plain.model.head.load_state_dict(policy.model.head.state_dict())
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in policy.model.backbone.model.parameters())
    log(f"  built both paths in {time.perf_counter() - t0:.1f} s ({n_params / 1e6:.1f} M backbone parameters)")

    images, states, tasks = policy_inputs()
    reset_launch_counts()
    actions = policy.forward(images, states, tasks)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  launches in one step: {counts}")
    if tuple(actions.shape) != (BATCH, 14) or not torch.isfinite(actions).all():
        fail(f"actions {tuple(actions.shape)} finite={bool(torch.isfinite(actions).all())}")
    expect = {"flash_attention": 24, "repmixer_block": 38}
    if counts != expect:
        fail(f"launch counts {counts} != {expect}")

    # The same observations already on the card: no host round trip, same actions.
    dev_actions = policy.forward(torch.from_numpy(images).cuda(), torch.from_numpy(states).cuda(), tasks)
    rel = float((dev_actions.float() - actions.float()).norm() / actions.float().norm())
    log(f"  card-resident inputs vs numpy inputs: actions rel_l2={rel:.3e} (limit {DEVICE_INPUT_REL_L2:g})")
    if dev_actions.device.type != "cuda" or not rel <= DEVICE_INPUT_REL_L2:
        fail(f"card-resident inputs: actions on {dev_actions.device}, rel_l2={rel:.3e}")

    reset_launch_counts()
    plain_actions = plain.forward(images, states, tasks)
    torch.cuda.synchronize()
    if any(launch_counts().values()):
        fail(f"the plain path launched kernels: {launch_counts()}")

    bb, pbb = policy.model.backbone, plain.model.backbone
    img = bb.to_device(bb._as_bchw(images))
    ids, mask = (bb.to_device(a) for a in bb._prep_text(policy.processor.prepare_tasks(tasks, BATCH)))
    feats = bb.features_fn(img, ids, mask)
    plain_feats = pbb.features_fn(img, ids, mask)
    for what, a, b in (("pooled features", feats, plain_feats), ("actions", actions, plain_actions)):
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        log(f"  kernel vs plain {what}: rel_l2={rel:.3e} (limit {POLICY_REL_L2:g}) "
            f"max_abs_err={float((a.float() - b.float()).abs().max()):.3e}")
        if not rel <= POLICY_REL_L2:
            fail(f"{what}: kernel path differs from the plain path, rel_l2={rel:.3e}")
    states_dev = bb.to_device(states)
    step = lambda p: p.model.apply_fn(img, ids, mask, states_dev)
    return policy, plain, step, counts


def phase_timing(policy, plain, step):
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import (
        flash_attention, flash_attention_reference, repmixer_block, repmixer_block_reference,
    )
    from vla_fastvlm_tpu_torch.ops.kernels.repmixer import _dw_weight

    log("[4/4] timing (kernels: CUDA graph replay between CUDA events; steps: host clock around synchronized steps)")

    def step_times(p, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(p)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    for p in (policy, plain):
        step_times(p, 2)  # warm-up
    kernel_ms, plain_ms = [], []
    for p, sink in ((policy, kernel_ms), (plain, plain_ms), (plain, plain_ms), (policy, kernel_ms)):
        sink.extend(step_times(p, 5))
    for what, ms in (("kernel path", kernel_ms), ("plain path", plain_ms)):
        p50 = statistics.median(ms)
        log(f"  step {what}: p50 {p50:.2f} ms, {BATCH / p50 * 1e3:.1f} actions/s "
            f"(min {min(ms):.2f}, max {max(ms):.2f}, n={len(ms)})")

    import torch.nn.functional as F

    results = {}
    # flash: main-path shape
    q, k, v, mask = flash_inputs(**FLASH_MAIN, dtype=torch.bfloat16)
    out = flash_attention(q, k, v, mask, True)
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    t = q.shape[1]
    bool_mask = (mask.bool()[:, None, None, :] & torch.ones(t, t, dtype=torch.bool, device="cuda").tril())
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bool_mask, enable_gqa=True)
    bound, by = flash_bound_ms(q, k, v, mask, out)
    results["flash_attention"] = dict(
        ms=time_ms(lambda: flash_attention(q, k, v, mask, True), 50),
        plain_ms=time_ms(lambda: flash_attention_reference(q, k, v, mask, True), 20),
        library_ms=time_ms(lib, 50), bound_ms=bound, bound_by=by,
    )
    r = results["flash_attention"]
    log(f"  flash_attention {tuple(q.shape)}x{tuple(k.shape)}: kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound {bound:.4f} ms ({by}); x24 per step")

    # repmixer: per stage, weighted by launches per step into one per-launch mean
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    launches = sum(n for _, n in REPMIXER_STAGES)
    for shape, n in REPMIXER_STAGES:
        args = repmixer_inputs(*shape, torch.bfloat16)
        args[1], args[3] = _dw_weight(args[1]).contiguous(), _dw_weight(args[3]).contiguous()
        out = repmixer_block(*args)
        ms = time_ms(lambda: repmixer_block(*args), 20)
        pms = time_ms(lambda: repmixer_block_reference(*args), 10)
        bound, by = repmixer_bound_ms(args, out)
        total["ms"] += n * ms
        total["plain_ms"] += n * pms
        total["bound_ms"] += n * bound
        total["ops_ms" if by == "operations" else "bytes_ms"] += n * bound
        log(f"  repmixer_block {shape}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bound:.4f} ms "
            f"({by}); x{n} per step")
    results["repmixer_block"] = dict(
        ms=total["ms"] / launches, plain_ms=total["plain_ms"] / launches, library_ms=None,
        bound_ms=total["bound_ms"] / launches,
        bound_by="operations" if total["ops_ms"] >= total["bytes_ms"] else "bytes",
    )
    log(f"  repmixer_block per step: kernel {total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, "
        f"bound {total['bound_ms']:.3f} ms over {launches} launches")
    return results


def profile_step(policy, step, out_dir: Path) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    step(policy)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(policy)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out_dir / "step_profile.txt").write_text(table)
    log(f"  profile of 3 steps written to {out_dir / 'step_profile.txt'}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", type=Path, default=None,
                        help="directory for a torch.profiler table of three policy steps")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "vla_fastvlm_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no vla_fastvlm_tpu_torch package", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from vla_fastvlm_tpu_torch.device import strict_fp32

    strict_fp32()  # fp32 plain versions in full fp32: no TF32 in cuDNN or matmuls

    t_start = time.perf_counter()
    phase_build()
    errs = phase_kernels()
    policy, plain, step, counts = phase_policy()
    timings = phase_timing(policy, plain, step)
    if args.profile is not None:
        profile_step(policy, step, args.profile)

    meta = {
        "flash_attention": ("vla_fastvlm_tpu_torch/csrc/flash_attention.cu",
                            "vla_fastvlm_tpu/ops/pallas/flash_attention.py:51"),
        "repmixer_block": ("vla_fastvlm_tpu_torch/csrc/repmixer.cu",
                           "vla_fastvlm_tpu/ops/pallas/repmixer.py:67"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
