#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py                 # the full check, about eighteen minutes
    python3 chip_smoke.py --profile DIR   # also write torch.profiler tables of policy steps, decode ticks and verify rounds
    python3 chip_smoke.py --only flash    # the flash-attention kernel alone: build, checks, times (about a minute)
    python3 chip_smoke.py --only repmixer # the RepMixer kernel alone: build, checks, per-width times (about a minute)
    python3 chip_smoke.py --only paged    # the two paged-attention kernels alone: build, checks, times (about a minute)
    python3 chip_smoke.py --only train    # the training phase alone, with the flash and RepMixer builds
    python3 chip_smoke.py --only closed_loop  # the closed-loop phase, after the four builds and their checks
    python3 chip_smoke.py --only serve    # the serving-CLI phase, after the RepMixer and paged builds and checks
    python3 chip_smoke.py --only surfaces # eval_dataset, the legacy policy, the LeRobot plugin, a config.json directory
    python3 chip_smoke.py --only lora     # LoRA training (0.5B both heads, 7B), multi-LoRA serving, merge_lora
    python3 chip_smoke.py --only quant    # int8 / int4 / w8a8 weights: ops, policy, serving, 7B target, QLoRA, quality
    python3 chip_smoke.py --only hf       # an Apple FastVLM-0.5B HF directory: load, folds, policy, convert, serve
    python3 chip_smoke.py --only parallel # the device mesh and the pipeline: one rank and two ranks sharing the card

Phases, in order; any failure raises and the script exits non-zero:

1. build: the four CUDA sources of ``vla_fastvlm_tpu_torch/csrc`` with
   ``nvcc`` for sm_90a, all at once.
2. kernels: each kernel against its plain PyTorch version on the same inputs,
   in bf16 at the main paths' shapes and in fp32 at a small batch with a
   tight tolerance: flash at the policy step's shapes (right-padded masks,
   fully padded rows; causal and not), at the train step's (T = 128, right-
   and left-padded, bf16 and fp32), at the closed loop's MLP tick (T = 320
   at batch 64 and at a staggered group of 16 in bf16, batch 4 in fp32), at
   head_dim 128 (the 7B decoder's shape), with left-padded masks, at T = 1,
   17 and 100 (rows that do not fill a block) and at S = 2048 / 1024 (the
   streamed instance); RepMixer per stage of the policy step, of the train
   step (512 px) and of the closed loop (1024 px, batch 64 and 16), fp32 at
   batch 2 of each grid, and ragged pixel grids at each width in
   both dtypes; paged decode attention at the serving shape in bf16 and over
   int8 pools, at head_dim 128, and in fp32 with trash pages and an empty
   stored mask; the verify window kernel (W > 1) in bf16 and over int8
   pools at the 7B verify shape and with the 0.5B heads, and in fp32 at
   W = 2, 5 and 9 with an empty stored mask and inactive slots; then both
   paged kernels with the stored window forced into 1, 2 and the most
   parts (one tile each), in fp32, bf16 and over int8 pools, at W = 1, 2, 5
   and 9, with an empty stored mask, inactive slots and one slot whose
   tile 1 is masked whole (an all-masked part), against the plain version
   and against the split twin ``paged_attention_split_reference``.
3. policy: FastVLA-0.5B at batch 128, 256 px, ``tokenizer_max_length`` 64,
   bf16, full depth, random weights from a seed, driven through
   ``FastVLAPolicy.forward``; outputs (128, 14) and finite; launch counts of
   one step (24 flash, 38 RepMixer, 0 paged); the same observations as
   tensors already on the card give the same actions; the same weights
   through the plain path (``attention_impl="xla"``, ``vision_block_impl="xla"``)
   agree with it.
4. training: FastVLA-0.5B at ``configs/train_aloha.yaml``'s settings (batch 8,
   512 px, ``tokenizer_max_length`` 64, bf16 compute over fp32 parameters,
   dropout 0.1, lr 1e-4, weight decay 1e-4), full depth, random weights from a
   seed, driven through ``Trainer`` over ``create_aloha_dataloader`` of
   ``SyntheticAlohaSource`` records with ALOHA's 480 x 640 camera frames.
   Frozen backbone: ``fit()`` for 12 steps saving at step 10
   (``keep_last_n`` 1), one ``evaluate()``, a fresh policy resumed from
   step-10 for the last 2 steps (counters restored, step-10 pruned by the
   step-12 save), the step-12 weights reloaded by
   ``load_policy_from_checkpoint`` into a fresh policy with bit-equal
   actions; launch counts 24 flash and 38 RepMixer a forward. Full backbone
   (``train_backbone``, decoder blocks rematerialized): 3 steps, 2 x 24 flash
   and 38 RepMixer launches a step, the peak memory. Kernel path against the
   plain path on the same weights and batch, one step: bf16 both backbone
   modes (loss, gradient norm, head gradients within the policy's limit, the
   backbone's gradients within ``TRAIN_BACKBONE_REL_L2``), fp32 at batch 2
   and 256 px (every gradient leaf within 1e-4); every trainable gradient
   finite. Then the p50 train step and samples/s of both paths in turns
   (20 steps a path and turn): frozen at the yaml shape and at the policy
   step's (batch 128, 256 px), full backbone at the yaml shape; each path's
   first ``Trainer`` step there gives its loss and gradient norm, held
   kernel path against plain path within the policy's limit. The batch-128
   step's model FLOPs (``utils/flops.py::fastvlm_train_flops``, counted on
   the meta device) and each path's MFU at its p50 against the card's
   dense bf16 peak (``device_peak_flops``), beside the card line.
5. serving: the paged server (``PagedGenerationServer``) of FastVLM-0.5B at
   its 1024 px, bf16, random weights from a seed, on the synthetic stream of
   ``scripts/serve.py``: 128 requests arriving 16 a tick, 64 slots, admission
   batches of 16, prompts of 4..64 tokens, 64 new tokens each, greedy, pages
   of 16. Three runs: ``decode_impl="kernel"``, ``"gathered"`` (the plain
   program) and ``"kernel"`` over int8 pools. Each answers every request
   with 64 tokens and returns every page; launch counts (paged = 24 x ticks,
   RepMixer = 38 x admissions, flash = 0); kernel and gathered tick logits
   from one admitted state agree; serve.py's summary and the device's idle
   share over a few decode ticks.
6. speculative serving: ``SpeculativePagedGenerationServer`` with a
   FastVLM-7B target (28 layers, hidden 3584, untied LM head, vocab 152064)
   and a FastVLM-0.5B draft (vocab padded to 152064), 1024 px, bf16, random
   weights from seeds 0 and 1, k = 4, pages of 16, 16 slots, admission
   batches of 8, 32 requests of the same stream with 32 new tokens each.
   Three runs: ``decode_impl="kernel"`` (the W = 5 verify window kernel),
   ``"gathered"`` and ``"kernel"`` over int8 pools; each answers every
   request with 32 tokens and returns every page; launch counts (window =
   28 x rounds, RepMixer = 76 x admissions: the target's tower and the
   draft's); kernel and gathered verify logits from one admitted state
   agree; greedy agreement with the plain paged server on the same target
   (printed), and for each request the first position where the two
   differ, with the target's top-2 logit gap there (recomputed on the common
   prefix by the dense cache path) set against the kernel-vs-gathered logit
   difference. Then FastVLM-0.5B as its own draft on 16 requests: at least
   2.0 tokens per active slot and round.
7. serving CLI: ``python -m vla_fastvlm_tpu_torch.scripts.serve``'s ``main``
   called in-process (the kernels are built once) on FastVLM-0.5B at its
   1024 px, bf16, seed 0, the stream and shape of phase 5: ``--paged``
   (whole-prompt admission), ``--prefix-cache 16 --repeat-fraction 0.5``,
   ``--prefill-chunk-tokens 16``, both together over int8 pools, and the
   speculative paged server with a FastVLM-0.5B draft (k = 4, prefix cache
   8, repeat fraction 0.5, chunks of 16) at the shape of phase 6; then
   ``... .generate`` once with the zero frame. Checks: every request
   answered in full; free + cache-pinned pages make the pool, and every
   page is free once the cache is emptied; hits and misses above zero and
   summing to the requests; launch counts (paged = 24 x ticks, window =
   24 x rounds, RepMixer = 38 x tower passes: miss admission batches,
   image chunks and draft prefills; 38 for generate). Then, on the server
   directly: 16 requests on one frame sharing a 48-token template, the
   first a miss and 15 page-level partial hits (19 shared pages, a 16-token
   tail each, the 15 tails one program), over bf16 and over int8 pools; 16 requests of the stream
   admitted in chunks; a whole-prompt hit on a 56-token prompt, whose rows
   end 8 positions into its 20th page. First-token logits of the partial
   hits and of the chunked admission against the same requests'
   whole-prompt prefill (``SERVE_LOGITS_REL_L2``); the hit's first token is
   its entry's argmax, its tail page a private copy of the entry's, and the
   entry's logits and pages are unchanged after it decodes.
   Printed per run: tokens/s, p50 and max tick, ticks, the share of ticks
   that ran admission work and their p50 against the decode ticks', hits,
   partial hits and misses, the host time of ``submit`` (the hashes of the
   raw frame), and with ``--profile`` the device time by part and the idle
   share.
8. closed loop: FastVLA-0.5B at full width and depth, its 1024 px, bf16,
   random weights from the seed, 64 ``DummyEnv``s of
   ``python -m vla_fastvlm_tpu_torch.scripts.eval_closed_loop`` with 256-px
   frames (letterboxed on the card), state and action widths 14, the CLI's
   default task, through ``BatchedEnvRunner`` over the CLI's build functions, 8
   control ticks a run (4 on the speculative server): the MLP policy
   (``stagger`` 1 and 4: groups of 16),
   and the token head as one batched generation, on the dense server and
   on the paged server (64 slots, admissions of 16, pages of 16, raw frames
   letterboxed in admission, bf16 and int8 pools), and on the speculative
   paged server with the model as its own draft (k = 4, 16 slots,
   admissions of 8). Checks: one finite action per env and tick, token
   actions on the codebook's bin centers, every request's 14 tokens, every
   page back, the launch counts of each run (24 flash + 38 RepMixer an MLP
   forward; 38 RepMixer a tower pass, 24 paged a decode tick, 24 window a
   round), at least 2.0 tokens per slot and round with the self-draft,
   staggered against serial first-tick actions and the MLP kernel path
   against its plain path on the first tick's observations (both
   ``POLICY_REL_L2``), and the
   paged server's tokens with ``image_prep`` equal to its tokens from the
   host-letterboxed frames. Printed: each run's actions/s, p50 control tick
   of the CLI's summary, the first tick apart and the p50 of the rest (min,
   max), server calls and decode ticks a control tick, the host time
   of ``dispatch_chunk`` against one forward between CUDA events (with
   ``--profile``: the device time of a tick and the idle share), and the
   servers' greedy agreement with the batched generation, with the
   divergence report of phase 6 for the paged server.
9. surfaces: the reference's other policy surfaces at FastVLA-0.5B's full
   width and depth, ``configs/train_aloha.yaml``'s settings (512 px, bf16
   compute over fp32 parameters, ``tokenizer_max_length`` 64, hidden and
   fusion 1024, batch 8) and random weights from the seed, on
   ``SyntheticAlohaSource`` records of 480 x 640 frames. A FastVLA MLP
   checkpoint and a legacy ``FastVLMPolicy`` checkpoint written by
   ``save_policy_checkpoint`` and reloaded through the top-level
   ``vla_fastvlm_tpu_torch.load_policy_from_checkpoint``: bit-equal
   actions. ``python -m vla_fastvlm_tpu_torch.scripts.eval_dataset``'s
   ``main`` in-process on each, 64 records in batches of 8: the printed MSE
   is the mean of ``compute_loss`` over the same batches; 24 flash and 38
   RepMixer launches a batch; the plain path (``attention_impl="xla"``,
   ``vision_block_impl="xla"``, same weights) within ``POLICY_REL_L2`` on the
   MSE and on a batch's actions. The LeRobot plugin
   (``vla_fastvlm_tpu_torch.lerobot_fastvla``, LeRobot's API from
   ``tests/lerobot_stub``): state (14,), one camera (3, 480, 640), action
   (14,), ``device="cuda"``, ``jax_dtype="bfloat16"``, ``image_size=512``;
   the pre-processor with the records' stats feeds 5 LeRobot-style steps
   (``forward``, ``backward``, ``clip_grad_norm_`` at the preset's 1.0,
   ``torch.optim.AdamW`` over ``get_optim_params()`` with the preset):
   finite losses, the head moved, every backbone parameter bit-equal, the
   first loss against the plain path within ``POLICY_REL_L2``, 24 + 38
   launches a forward, ``select_action`` popping its queue. A FastVLM-0.5B
   ``config.json`` directory (``llava_qwen2``, ``mobileclip_l_1024``)
   resolves to the preset's config at 1024 px, warns that its weights are
   random and runs one FastVLA forward of 16 frames through the kernels.
   Printed: eval samples/s, the plugin's p50 train step and
   ``select_action``, its losses and gradient norms.
10. LoRA: rank-16 adapters on the decoder's seven projections over a frozen
   base (``io/lora.py``). ``python -m vla_fastvlm_tpu_torch.scripts.train
   --lora-rank 16`` in-process at ``configs/train_aloha.yaml``'s settings
   (FastVLA-0.5B, batch 8, 512 px, bf16 over fp32), the MLP and the token
   head, 10 steps saving at the last: 48 flash launches a step (forward and
   remat recompute), 24 flash backward calls (plain recompute), 38 RepMixer
   and no RepMixer backward. On fresh adapters step 1 moves B, step 2 A,
   and the base stays bit-equal; the CLI's checkpoint against the plain
   path (bf16 loss, gradient norm, adapter and head gradients within 3e-2;
   fp32 at batch 2 / 256 px, every leaf within 1e-4); both paths' p50
   step, device time by part with ``--profile``. FastVLA-7B: bf16 base,
   fp32 adapters (40.37 M), 3 steps, peak memory. ``scripts.merge_lora``
   on the MLP checkpoint and on it with seeded B: merged against adapted
   actions in fp32 (1e-4) and bf16. The serve CLI with ``--lora-dir`` over
   the trained adapter and two seeded ones on phase 7's stream, with and
   without ``--prefix-cache 16 --repeat-fraction 0.5``, against the same
   runs without adapters; on the paged server, adapted tick logits kernel
   against gathered, launches and device time a tick with and without
   adapters, each row's first-token logits against a single-adapter server
   (2e-2), a repeat under another adapter a miss; the speculative-paged
   server with target adapters at the self-draft shape (its acceptance,
   the window kernel against gathered verify logits).
11. weight quantization (``io/quantize.py``, ``ops/quant.py``): the int8,
   int4 (groups of 128) and w8a8 products at one FastVLM-7B layer's
   projections (fused q/k/v 4608 x 3584, fused gate/up 37888 x 3584, down
   3584 x 18944), bf16, at 16 tokens (int8, int4) and 2048 (all three),
   against x @ dequant(W)^T in fp32 (QUANT_OP_REL_L2) and timed beside
   ``F.linear`` on the bf16 weight; phase 3's policy step for float, int8,
   int4 and w8a8 (24 flash and 38 RepMixer launches, the kernel path
   against the plain path within ``POLICY_REL_L2``, w8a8 within
   QUANT_W8A8_REL_L2, the actions against
   float within QUANT_ACTION_REL_L2, the p50 step); the serve CLI of phase 7
   with ``--quantization int8``, ``int4`` and int8 over int8 pools (every
   request in full, every page back, paged = 24 x ticks), then the paged
   server on phase 5's stream in float, int8 and int4 (tokens/s, the device
   time of a decode tick, greedy agreement with float and phase 6's
   divergence report against the first-token logit difference); the
   speculative cell's shape with the FastVLM-7B target in bf16 and then
   quantized to int8 in place behind the 0.5B draft (tokens per slot and
   round, 28 window launches a round, the target's weight bytes, peak
   memory); ``scripts.train --quantization int8 --lora-rank 16`` at the
   yaml's settings for 10 steps (48 flash launches a step, every B moved,
   the int8 base bit-equal to a fresh build's) and FastVLA-7B QLoRA over an
   int8 base for 3 steps (peak memory against PR 12's bf16 base); then
   ``python -m vla_fastvlm_tpu_torch.scripts.eval_quant_quality`` at
   FastVLM-0.5B, 256 px, and its JSON line.
12. Apple FastVLM checkpoints (``io/model_loader.py``, ``io/weights.py``,
   ``io/reparam.py``, ``io/vision_convert.py``): a FastVLM-0.5B HF
   directory (``FASTVLM_05B_CONFIG``, full width and depth) written from
   seeds, the decoder and projector of a seeded port model under HF names
   in two bf16 shards, the FastViTHD tower in Apple's train-mode layout
   (every branch kind, random BatchNorm statistics) in an fp32 shard.
   ``FastVLAPolicy(vlm_model_name=dir)`` on the card with no fallback
   warning (load seconds by part: read, decoder, fold, copy), decoder and
   projector bit-equal to the source; one module of each kind (the three
   stem blocks, RepMixer at C = 96, 192, 384, a large-kernel patch embed,
   RepCPE, the ConvFFN's conv + BN, ``conv_exp``) fused against its branch
   sum in fp32 (``HF_FOLD_REL_L2``); the policy at phase 9's directory
   shape (16 frames, 1024 px): 24 flash + 38 RepMixer launches, the plain
   path within ``POLICY_REL_L2``, the p50 step; the same fused weights
   under inference-mode names (``reparam_conv``, ``lkb_reparam``): the
   state_dict and the actions bit-equal; ``python -m
   vla_fastvlm_tpu_torch.scripts.convert_checkpoint`` on the directory and
   ``load_policy_from_checkpoint`` of its output: actions bit-equal; the
   serve CLI with ``--model-id DIR --paged`` on 16 requests of 16 new tokens
   (paged = 24 x ticks, every page back, tokens/s); the native letterbox
   (``vla_fastvlm_tpu_torch/native``, built with ``g++``) against its numpy
   plain version and the card's letterbox, ms a frame.
13. timing: p50 step time and actions/sec of the kernel path and the plain
   path (in turns), with the step's model FLOPs
   (``utils/flops.py::fastvlm_serve_flops``, counted on the meta device)
   and each path's MFU at its p50 beside the card line; each kernel's time
   per launch beside its plain version,
   one PyTorch library call where one computes the same function, and the
   least time the card could take for the same work; for RepMixer each
   width's time split into a part per hidden chunk and a fixed part.
14. parallel: the device mesh of ``vla_fastvlm_tpu_torch/parallel`` on the
   card. (a) One rank (nccl), mesh (1, 1): ``ShardedPolicyRuntime`` at
   phase 3's batch bit-equal to the unsharded policy, a full-backbone
   ``Trainer`` step with ``fsdp=True`` at phase 4's settings (dropout 0),
   and the one-rank tokens of ``sharded_generate`` and of a paged server
   (decode "gathered") over 16 requests of phase 5's stream, 16 new tokens.
   (b) Two ranks sharing the card (gloo on CUDA tensors, the backend rule
   of ``parallel/mesh.py``), started by ``spawn_ranks``: each collective of
   the phase once on CUDA tensors; the policy at (2, 1) and (1, 2), actions
   within ``POLICY_REL_L2`` of (a)'s, 24 flash and 38 RepMixer launches a
   rank-forward; generation and the paged server at TP 2: prefill logits
   within ``SERVE_LOGITS_REL_L2`` of (a)'s, the share of greedy tokens equal
   to (a)'s, and every first divergence a near-tie (the two tokens' logits
   within the largest prefill logit difference); the FSDP step at (2, 1),
   its loss within ``TRAIN_REL_L2`` of (a)'s. The p50 of each layout beside
   the card's name and power limit (two ranks share the card: not scaling).
   (c) The GPipe pipeline (``parallel/pipeline.py``) of the Qwen2-0.5B
   decoder at full width and depth, batch 16 at T = 320, bf16, on one rank
   (in (a)'s nccl group) and on two stages (in (b)'s gloo ranks): the flash
   kernel against its plain version at the microbatch shapes; the pipelined
   hidden states at 2 and 4 microbatches against the unpipelined forward
   (``SERVE_LOGITS_REL_L2``); (24 / P) x microbatches flash launches a
   rank-forward, twice that a remat train step; 3 AdamW steps of
   ``make_pipeline_train_step`` whose first gradients match the unpipelined
   step's (bf16 jointly within ``TRAIN_REL_L2``; fp32 at batch 4, every
   leaf within ``TRAIN_FP32_REL_L2``), the loss falling, ``embed_tokens``
   and ``norm`` bit-equal across ranks after each step; the p50 forward and
   train step of each layout.

``--only quant`` runs phases 1 and 2 and phase 11, then the card line and
the last line; ``--only hf`` phases 1 and 2 and phase 12; ``--only
parallel`` phase 1 for the flash-attention and RepMixer sources, their
checks of phase 2 and phase 14. ``--only train`` runs phase 1 for the flash-attention and RepMixer sources,
their checks of phase 2 and phase 4, then the card line and the last line.
``--only closed_loop`` runs phases 1 and 2 and phase 8, then the card line
and the last line. ``--only surfaces`` runs phase 1 for the flash-attention
and RepMixer sources, their checks of phase 2 (which hold the phase's
shapes: flash at T = 128 and 320, RepMixer on the 512- and 1024-px grids)
and phase 9, then the card line and the last line. ``--only lora`` runs phases 1 and 2 and phase 10,
then the card line and the last line. ``--only serve`` runs phase 1 for the RepMixer and the
two paged-attention sources, their checks of phase 2 and phase 7 (on a
FastVLM-0.5B built as in phase 5), then the card line and the last line.
``--profile`` adds each
timed train step's device time by part (STEP_PARTS, and the kernels'
backward recomputes apart). ``--only flash`` runs phase 1 for the
flash-attention source alone, the
flash checks of phase 2 and, at the policy's shape, the 7B heads' and the
two streamed shapes, the wrapper call (``ms``), the kernel's launch alone
(``kernel_ms``), the plain version, ``scaled_dot_product_attention``, the
bound and the launch alone with the L2 emptied first; at the policy's shape
also with every key valid, and at the first two shapes by block shape (tiles
of 16 packed rows and warps a block, with the blocks an SM holds); then the
card line and a JSON line of the numbers. ``--only repmixer`` does the same
for the RepMixer source: its checks of phase 2 and its timing of phase 13.
``--only paged`` does the same for the two paged-attention sources: their
checks of phase 2, then at each of the 8 paged shapes of phase 13 the wrapper
call (``ms``), the kernel's launch alone (``kernel_ms``: mask and tables
already int32), the plain version, the bound, the planned parts, the launch
alone with the L2 emptied first, and the launch alone at 1, 2, 3 and 6
parts.

Prints the card's name and power limit, a JSON line of the kernels, and as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
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
# Flash above what a block's shared memory holds: the streamed instance.
FLASH_LONG = [dict(b=2, t=2048, n=14, kh=2, d=64), dict(b=2, t=1024, n=28, kh=4, d=128)]
# (B, H, W, C, F) per FastViTHD RepMixer stage at 256 px, with launches per step.
REPMIXER_STAGES = [((BATCH, 64, 64, 96, 384), 2), ((BATCH, 32, 32, 192, 768), 12),
                   ((BATCH, 16, 16, 384, 1536), 24)]
# Pixel grids that the image's edge cuts (H, W not multiples of 8 or 16).
REPMIXER_RAGGED = [(3, 12, 20, 96, 384), (2, 20, 12, 192, 768), (2, 12, 20, 384, 1536)]
# configs/train_aloha.yaml's batch and image size, and the train step's kernel
# shapes there: T = 64 image + 64 text tokens; RepMixer's stages at 512 px.
TRAIN_BATCH, TRAIN_IMAGE = 8, 512
FLASH_TRAIN = dict(b=TRAIN_BATCH, t=(TRAIN_IMAGE // 64) ** 2 + TEXT_LEN, n=14, kh=2, d=64)
REPMIXER_TRAIN = [(TRAIN_BATCH, TRAIN_IMAGE // 4, TRAIN_IMAGE // 4, 96, 384),
                  (TRAIN_BATCH, TRAIN_IMAGE // 8, TRAIN_IMAGE // 8, 192, 768),
                  (TRAIN_BATCH, TRAIN_IMAGE // 16, TRAIN_IMAGE // 16, 384, 1536)]
# The LoRA train steps' flash shapes (phase 10): the token head's sequence
# (64 image + 64 prompt + 14 state + 14 action tokens; 16 image tokens at
# the fp32 comparison's 256 px) and the 7B decoder's heads at the MLP head's.
ALOHA_DIM = 14
FLASH_TOKEN_TRAIN = dict(FLASH_TRAIN, t=FLASH_TRAIN["t"] + 2 * ALOHA_DIM)
FLASH_TOKEN_FP32 = dict(FLASH_TRAIN, b=2, t=(256 // 64) ** 2 + TEXT_LEN + 2 * ALOHA_DIM)
FLASH_7B_TRAIN = dict(FLASH_TRAIN, n=28, kh=4, d=128)

# FastVLM-0.5B serving on the synthetic stream of scripts/serve.py, at the
# preset's own 1024 px (256 image tokens): windows of 256 + 64 + 64 = 384
# positions, 24 pages of 16, a pool of 64 x 24 + 1 = 1,537 pages.
SERVE = dict(num_slots=64, prefill_batch=16, prompt_len=64, max_new_tokens=64, page_size=16)
SERVE_REQUESTS, SERVE_ARRIVALS, N_IMG, DECODER_LAYERS = 128, 16, 256, 24
# The closed loop's kernel shapes at the preset's 1024 px: the MLP tick's
# prefill (T = 256 image + 64 text tokens) at its 64 envs and at a staggered
# group of 16; RepMixer's three stage grids at the tick's batch of 64 and at
# an admission (or staggered group) of 16.
LOOP_IMAGE, LOOP_ENVS, LOOP_GROUP = 1024, 64, 16
FLASH_LOOP = dict(b=LOOP_ENVS, t=N_IMG + TEXT_LEN, n=14, kh=2, d=64)
REPMIXER_LOOP = [(b, LOOP_IMAGE // s, LOOP_IMAGE // s, c, 4 * c) for b in (LOOP_ENVS, LOOP_GROUP)
                 for s, c in ((4, 96), (8, 192), (16, 384))]
# The paged kernel at the serving shape (one launch per layer and tick) and
# with the 7B decoder's heads.
PAGED_MAIN = dict(b=64, n=14, kh=2, d=64)
PAGED_7B = dict(b=16, n=28, kh=4, d=128)
# Decode ticks whose device time the profiler adds up for the idle share.
IDLE_TICKS = 5

# Speculative decoding on the paged server, the repo's design point
# (scripts/bench_speculative.py, scripts/serve.py --draft-model-id): a
# FastVLM-7B target verifying k = 4 proposals of a FastVLM-0.5B draft whose
# vocab is padded to the target's 152064, 1024 px, bf16. 32 requests of the
# stream above, 32 new tokens each, 16 slots, admission batches of 8: windows
# of 256 + 64 + 32 + k + 1 = 357 positions, 23 pages of 16.
SPEC = dict(k=4, num_slots=16, prefill_batch=8, prompt_len=64, max_new_tokens=32, page_size=16)
SPEC_REQUESTS, SPEC_ARRIVALS, TARGET_LAYERS, TARGET_VOCAB = 32, 16, 28, 152064
SPEC_PAGES = -(-(N_IMG + SPEC["prompt_len"] + SPEC["max_new_tokens"] + SPEC["k"] + 1) // SPEC["page_size"])
# The self-draft run (FastVLM-0.5B as its own draft): tokens per active slot
# and round. A draft that the target always rejects gives 1.0; k + 1 = 5 is
# every proposal accepted.
SELF_DRAFT_REQUESTS, SELF_DRAFT_MIN_TOKENS_PER_SLOT_ROUND = 16, 2.0
# The verify window kernel at the 7B verify shape (16 slots and the dead
# lane, 28 query heads over 4 KV heads, D = 128, W = k + 1) and with the
# 0.5B draft's heads at 64 slots.
WINDOW_7B = dict(b=SPEC["num_slots"] + 1, w=SPEC["k"] + 1, n=28, kh=4, d=128)
WINDOW_MAIN = dict(b=65, w=SPEC["k"] + 1, n=14, kh=2, d=64)

# Kernel against plain version, |kernel - plain| <= ATOL + RTOL * |plain| per element.
# bf16: both sides round at the same points but in another order, so outputs
# of magnitude up to ~4 may differ by a few bf16 ulps (2**-7 at 2..4).
# fp32: only the summation order differs.
TOL = {
    ("flash", "bf16"): (2e-2, 2e-2),
    ("flash", "fp32"): (1e-5, 1e-5),
    ("repmixer", "bf16"): (5e-2, 5e-2),
    ("repmixer", "fp32"): (1e-4, 1e-4),
    # P rounded to bf16 relative to the running maximum (kernel) or after
    # normalization (plain): a few bf16 ulps of outputs up to ~3.
    ("paged", "bf16"): (2e-2, 2e-2),
    ("paged", "fp32"): (1e-5, 1e-5),
}
# Kernel path against plain path over the whole bf16 policy: relative L2 error
# of the pooled features and of the actions (bf16 roundings in another order
# through 24 decoder layers and 44 vision blocks).
POLICY_REL_L2 = 3e-2
# Card-resident and numpy observations run the same kernels on the same
# values; only library algorithm choices could differ.
DEVICE_INPUT_REL_L2 = 1e-3
# Kernel tick against gathered tick from one admitted state, bf16: only the
# 24 decode attentions differ (order of sums, where P is rounded). The same
# limit holds the 7B verify window (28 window attentions).
SERVE_LOGITS_REL_L2 = 2e-2


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

def flash_inputs(b, t, n, kh, d, dtype, seed=0, pad="right"):
    """q/k/v ~ N(0, 1); key masks of varied length, one row in eight
    entirely padded, as the decoder's prefill mask would never be but the
    kernel must take. ``pad``: "right" (the policy's: valid keys first),
    "left" (valid keys last, as a left-padding tokenizer gives them: the
    first positions of a row see no allowed key under causal masking) or
    "none" (every key valid)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, t, n, d, generator=g).to("cuda", dtype)
    k = torch.randn(b, t, kh, d, generator=g).to("cuda", dtype)
    v = torch.randn(b, t, kh, d, generator=g).to("cuda", dtype)
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[::8] = 0
    idx = torch.arange(t)[None, :]
    mask = {"right": idx < lengths[:, None], "left": idx >= t - lengths[:, None],
            "none": torch.ones(b, t, dtype=torch.bool)}[pad]
    return q, k, v, mask.to(torch.int32).to("cuda")


def paged_inputs(b, n, kh, d, dtype, int8, seed=0, empty_slot=False, w=None, hole=False):
    """A decode tick's paged attention (``w`` None: q (B, N, D), new rows
    (B, K, D)) at the serving windows (24 pages of 16): slot i holds 256
    image + 4..64 prompt positions (the rest of the 64-wide prompt dead),
    then 0..63 decoded ones, on pages of its own. With ``w`` a verify
    round's window attention (q (B, W, N, D), new rows (B, W, K, D)) at the
    speculative serving windows (23 pages of 16, 0..31 decoded positions),
    the last slot the dead lane; the table reaches the pages through the
    window's end, whose rows past the cursor hold random values and are
    masked, as a rejected suffix of an earlier round would. One slot in 16
    is inactive (one-hot mask on the trash page, length 1, as the servers
    run them); table entries past a slot's pages are the trash page; with
    ``empty_slot`` slot 1 has an empty stored mask; with ``hole`` slot 2's
    positions 64..127 (tile 1) are masked whole. Pools N(0, 1), or their
    int8 quantization with scales; int8 new rows arrive dequant-roundtripped."""
    import torch

    from vla_fastvlm_tpu_torch.ops.quant import quantize_kv

    cfg = SERVE if w is None else SPEC
    page, prefill = cfg["page_size"], N_IMG + cfg["prompt_len"]
    p_slot = (prefill + SERVE["max_new_tokens"]) // page if w is None else SPEC_PAGES
    rows = () if w is None else (w,)
    g = torch.Generator(device="cpu").manual_seed(seed)
    p_total = b * p_slot + 1
    rnd = lambda *s: torch.randn(*s, generator=g)
    q, kn, vn = rnd(b, *rows, n, d), rnd(b, *rows, kh, d), rnd(b, *rows, kh, d)
    pk, pv = rnd(p_total, kh, page, d), rnd(p_total, kh, page, d)
    tables = torch.zeros(b, p_slot, dtype=torch.int32)
    mask = torch.zeros(b, p_slot * page, dtype=torch.bool)
    lengths = torch.ones(b, dtype=torch.int32)
    perm = torch.randperm(p_total - 1, generator=g) + 1
    for i in range(b):
        if empty_slot and i == 1 and w is None:
            continue
        if i % 16 == 15 or (w is not None and i == b - 1):
            mask[i, 0] = True
            continue
        plen = int(torch.randint(4, cfg["prompt_len"] + 1, (1,), generator=g))
        length = prefill + int(torch.randint(0, cfg["max_new_tokens"], (1,), generator=g))
        used = (length + (w or 1) - 1) // page + 1  # pages through the last new row
        tables[i, :used] = perm[i * p_slot: i * p_slot + used]
        lengths[i] = length
        if empty_slot and i == 1:
            continue
        mask[i, :N_IMG + plen] = True
        mask[i, prefill:length] = True
        if hole and i == 2:
            mask[i, 64:128] = False
    scales = {}
    if int8:
        (pk, ks), (pv, vs) = quantize_kv(pk), quantize_kv(pv)
        scales = dict(pool_k_scale=ks.cuda(), pool_v_scale=vs.cuda())
        (kq, kss), (vq, vss) = quantize_kv(kn), quantize_kv(vn)
        kn, vn = kq.float() * kss[..., None], vq.float() * vss[..., None]
    else:
        pk, pv = pk.to(dtype), pv.to(dtype)
    args = [q.to(dtype), pk, pv, tables, mask, lengths, kn.to(dtype), vn.to(dtype)]
    return [a.cuda() for a in args], scales


def serve_stream(seed=SEED, n=SERVE_REQUESTS):
    """``scripts/serve.py``'s first ``n`` synthetic requests: prompt lengths
    uniform in 4..prompt_len, token ids in 3..249, images uniform in [0, 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    width = SERVE["prompt_len"]
    reqs = []
    for _ in range(n):
        length = int(rng.integers(4, width + 1))
        ids = np.zeros((1, width), np.int32)
        mask = np.zeros((1, width), np.int32)
        ids[0, :length] = rng.integers(3, 250, length)
        mask[0, :length] = 1
        reqs.append((ids, mask, rng.random((1, 3, 1024, 1024), dtype=np.float32)))
    return reqs


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


def paged_bound_ms(args, scales, out):
    """Bytes: the distinct pages holding a valid position, K and V, plus q,
    out, the new rows, the int32 mask and tables, and for int8 pools the
    K and V scales of the pages reached. Operations: 4 D per (query row,
    valid stored position) and per (query row, new column at or before its
    own): with W new rows a slot's rows see 1 .. W of them."""
    q, pk, pv, tables, mask, lengths, kn, vn = args
    b, n, d = q.shape[0], q.shape[-2], q.shape[-1]
    w = q.shape[1] if q.ndim == 4 else 1
    page = pk.shape[2]
    reached = tables[mask.view(b, tables.shape[1], page).any(-1)].unique().numel()
    nbytes = 2 * reached * pk[0].numel() * pk.element_size()
    nbytes += sum(x.numel() * x.element_size() for x in (q, kn, vn, out)) + 4 * (mask.numel() + tables.numel())
    if scales:
        nbytes += 2 * reached * pk.shape[1] * page * 4
    flops = 4 * d * n * (w * int(mask.sum()) + b * w * (w + 1) // 2)
    return _bound(nbytes, flops)


def _bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases

KERNEL_SOURCES = ("flash_attention", "repmixer", "paged_attention", "paged_window")


def phase_build(names=KERNEL_SOURCES):
    from vla_fastvlm_tpu_torch.ops.kernels import _build

    log("[1/14] build" + ("" if tuple(names) == KERNEL_SOURCES else f": {', '.join(names)}"))
    t0 = time.perf_counter()
    logs = _build.build(names)
    for name, text in logs.items():
        log(f"  {name}: " + (" | ".join(ptxas_usage(text)) or "built"))
    log(f"  built in {time.perf_counter() - t0:.1f} s")


def ptxas_usage(text: str) -> list:
    """One entry per kernel instance of an ``nvcc -Xptxas -v`` log: its
    mangled name, then its registers and spills."""
    out, entry = [], None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
        elif entry and ("spill" in ln or "registers" in ln):
            if "spill" in ln:
                spill = ln.strip()
            else:
                out.append(f"{entry}: {ln.split(':', 1)[-1].strip()}; {spill}")
                entry = None
    return out


# Flash against its plain version: (label, shape, dtype, mask padding). The
# main paths' shapes in bf16 (the policy step's, the 7B decoder's heads, the
# train step's and the closed loop's, there also in fp32), fp32 at a small
# batch, left-padded masks, T = 1, T = 17 and 100 (7 x 17 =
# 119 and 7 x 100 = 700 packed rows: not whole blocks of 128 at D = 64 or
# 112 at D = 128), and above what a block's shared memory holds (the
# streamed instance).
FLASH_CHECKS = [
    ("flash bf16 main", FLASH_MAIN, "bf16", "right"),
    ("flash bf16 d128", FLASH_7B, "bf16", "right"),
    ("flash fp32 d64", dict(FLASH_MAIN, b=4), "fp32", "right"),
    ("flash fp32 d128", dict(FLASH_7B, b=2), "fp32", "right"),
    ("flash bf16 main left-padded", FLASH_MAIN, "bf16", "left"),
    ("flash fp32 d64 left-padded", dict(FLASH_MAIN, b=9), "fp32", "left"),
    ("flash fp32 d128 left-padded", dict(FLASH_7B, b=9), "fp32", "left"),
    ("flash bf16 T=1", dict(FLASH_MAIN, t=1), "bf16", "right"),
    ("flash fp32 T=17", dict(FLASH_MAIN, b=9, t=17), "fp32", "left"),
    ("flash bf16 T=100 d128", dict(FLASH_7B, t=100), "bf16", "right"),
    ("flash fp32 T=100", dict(FLASH_MAIN, b=9, t=100), "fp32", "right"),
] + [(f"flash {kind} train{label}", FLASH_TRAIN, kind, pad)
     for kind in ("bf16", "fp32") for pad, label in (("right", ""), ("left", " left-padded"))] + [
    ("flash bf16 closed loop", FLASH_LOOP, "bf16", "right"),
    ("flash bf16 closed loop, staggered group", dict(FLASH_LOOP, b=LOOP_GROUP), "bf16", "right"),
    ("flash fp32 closed loop", dict(FLASH_LOOP, b=4), "fp32", "right"),
    ("flash bf16 LoRA token-head train", FLASH_TOKEN_TRAIN, "bf16", "right"),
    ("flash fp32 LoRA token-head train, 256 px", FLASH_TOKEN_FP32, "fp32", "right"),
    ("flash bf16 LoRA 7B train", FLASH_7B_TRAIN, "bf16", "right"),
    ("flash fp32 LoRA 7B train", dict(FLASH_7B_TRAIN, b=2), "fp32", "right"),
] + [(f"flash {kind} S={shape['t']} d{shape['d']} (streamed)", shape, kind, "right")
     for shape in FLASH_LONG for kind in ("bf16", "fp32")]


def check_flash() -> float:
    """FLASH_CHECKS, with and without causal masking at the main shape,
    and the streamed instance at the main shape; returns the bf16 error at
    the main shape."""
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import flash_attention, flash_attention_reference, flash_attention_streamed

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    main_err = 0.0
    for what, shape, kind, pad in FLASH_CHECKS:
        q, k, v, mask = flash_inputs(**shape, dtype=dtypes[kind], pad=pad)
        for causal in (True, False) if shape is FLASH_MAIN else (True,):
            out = flash_attention(q, k, v, mask, causal)
            torch.cuda.synchronize()
            err = check_close(what + ("" if causal else ", not causal"), out,
                              flash_attention_reference(q, k, v, mask, causal), TOL[("flash", kind)])
            if what == "flash bf16 main" and causal:
                main_err = err
    q, k, v, mask = flash_inputs(**FLASH_MAIN, dtype=torch.bfloat16)
    check_close("flash bf16 main, streamed instance", flash_attention_streamed(q, k, v, mask, True),
                flash_attention_reference(q, k, v, mask, True), TOL[("flash", "bf16")])
    return main_err


def phase_kernels():
    log("[2/14] kernels against their plain versions")
    errs = {"flash_attention": check_flash(), "repmixer_block": check_repmixer()}
    errs.update(check_paged())
    return errs


# Kernel against plain version at the default split plan: (name in the JSON
# line, label, shape, dtype, int8 pools, edge slots). Edge slots: an empty
# stored mask (slot 1), trash entries and inactive slots.
PAGED_CHECKS = [
    ("paged_attention", "paged bf16 main", PAGED_MAIN, "bf16", False, False),
    ("paged_attention_int8", "paged int8 main", PAGED_MAIN, "bf16", True, False),
    (None, "paged bf16 d128", PAGED_7B, "bf16", False, False),
    (None, "paged int8 d128", PAGED_7B, "bf16", True, False),
    (None, "paged fp32 d64", dict(PAGED_MAIN, b=17), "fp32", False, True),
    (None, "paged fp32 int8 d64", dict(PAGED_MAIN, b=17), "fp32", True, True),
    (None, "paged fp32 d128", dict(PAGED_7B, b=3), "fp32", False, True),
    # The verify window kernel (W > 1): bf16 and int8 pools at the 7B verify
    # shape (the main path's) and with the 0.5B heads at 64 slots; fp32 at a
    # small batch, W = 2, 5 and 9.
    ("paged_attention_window", "window bf16 7B", WINDOW_7B, "bf16", False, False),
    ("paged_attention_window_int8", "window int8 7B", WINDOW_7B, "bf16", True, False),
    (None, "window bf16 0.5B heads", WINDOW_MAIN, "bf16", False, False),
    (None, "window int8 0.5B heads", WINDOW_MAIN, "bf16", True, False),
    (None, "window fp32 W=2 d64", dict(WINDOW_MAIN, b=5, w=2), "fp32", False, True),
    (None, "window fp32 W=9 d64", dict(WINDOW_MAIN, b=5, w=9), "fp32", False, True),
    (None, "window fp32 int8 W=5 d64", dict(WINDOW_MAIN, b=5), "fp32", True, True),
    (None, "window fp32 W=5 d128", dict(WINDOW_7B, b=5), "fp32", False, True),
    (None, "window fp32 int8 W=9 d128", dict(WINDOW_7B, b=5, w=9), "fp32", True, True),
]
# Forced split counts: (label, shape) at 9 slots, each in fp32, bf16 and
# over int8 pools, with 1, 2 and the most parts.
SPLIT_CHECKS = [("W=1 d64", dict(PAGED_MAIN, b=9)), ("W=1 d128", dict(PAGED_7B, b=9)),
                ("W=2 d64", dict(WINDOW_MAIN, b=9, w=2)), ("W=5 d64", dict(WINDOW_MAIN, b=9)),
                ("W=5 d128", dict(WINDOW_7B, b=9)), ("W=9 d64", dict(WINDOW_MAIN, b=9, w=9))]


def paged_fns(window: bool):
    from vla_fastvlm_tpu_torch.ops.kernels import (
        paged_attention_decode, paged_attention_decode_reference, paged_attention_window,
        paged_attention_window_reference,
    )

    if window:
        return paged_attention_window, paged_attention_window_reference
    return paged_attention_decode, paged_attention_decode_reference


def check_empty_slot(what, out, args, shape, kind):
    """Slot 1's stored mask is empty: its (first window position's) rows are
    its (first) new V row."""
    rep = shape["n"] // shape["kh"]
    first_out, first_v = (out[1], args[7][1]) if out.ndim == 3 else (out[1, 0], args[7][1, 0])
    check_close(f"{what}, empty stored mask", first_out, first_v.repeat_interleave(rep, dim=0), TOL[("paged", kind)])


def check_paged() -> dict:
    """Both paged kernels against their plain versions (see PAGED_CHECKS),
    then at forced split counts (SPLIT_CHECKS) also against the split twin.
    Returns the bf16 errors at the main-path shapes."""
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import paged_attention as pa

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    errs = {}
    for name, what, shape, kind, int8, edge in PAGED_CHECKS:
        kernel, plain = paged_fns("w" in shape)
        args, scales = paged_inputs(**shape, dtype=dtypes[kind], int8=int8, empty_slot=edge)
        out = kernel(*args, **scales)
        torch.cuda.synchronize()
        err = check_close(what, out, plain(*args, **scales), TOL[("paged", kind)])
        if name:
            errs[name] = err
        if edge:
            check_empty_slot(what, out, args, shape, kind)
    for label, shape in SPLIT_CHECKS:
        _, plain = paged_fns("w" in shape)
        for kind, int8 in (("fp32", False), ("bf16", False), ("bf16", True)):
            args, scales = paged_inputs(**shape, dtype=dtypes[kind], int8=int8, empty_slot=True, hole=True)
            tiles = -(-args[4].shape[1] // pa.TILE)
            ref = plain(*args, **scales)
            for splits in sorted({1, 2, tiles}):
                what = f"{label} {kind}{' int8' if int8 else ''} splits={splits}"
                out = pa._launch(*args[:5], *args[6:], scales.get("pool_k_scale"), scales.get("pool_v_scale"),
                                 shape["d"] ** -0.5, splits=splits)
                torch.cuda.synchronize()
                check_close(what, out, ref, TOL[("paged", kind)])
                twin = pa.paged_attention_split_reference(*args, **scales, splits=splits)
                check_close(f"{what} vs split twin", out, twin, TOL[("paged", kind)])
                check_empty_slot(what, out, args, shape, kind)
    if any(int(c.abs().sum()) for c in pa._COUNTERS.values()):
        fail("paged kernels left a ticket counter other than 0")
    return errs


def check_repmixer() -> float:
    """The RepMixer kernel against its plain version: bf16 at each stage's
    shape on the policy step, the train step and the closed loop, fp32 at
    batch 2 of each grid, and ragged pixel grids (tiles cut by the image's
    edge) in both dtypes. Returns the largest bf16 error at the main paths'
    shapes."""
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import repmixer_block, repmixer_block_reference

    worst, fp32_grids = 0.0, set()
    for shape in [shape for shape, _ in REPMIXER_STAGES] + REPMIXER_TRAIN + REPMIXER_LOOP:
        b, h, w, c, f = shape
        args = repmixer_inputs(*shape, torch.bfloat16)
        out = repmixer_block(*args)
        torch.cuda.synchronize()
        err = check_close(f"repmixer bf16 {shape}", out, repmixer_block_reference(*args),
                          TOL[("repmixer", "bf16")])
        worst = max(worst, err)
        del args, out
        if (h, w, c, f) in fp32_grids:
            continue
        fp32_grids.add((h, w, c, f))
        args = repmixer_inputs(2, h, w, c, f, torch.float32)
        out = repmixer_block(*args)
        torch.cuda.synchronize()
        check_close(f"repmixer fp32 {(2, h, w, c, f)}", out, repmixer_block_reference(*args),
                    TOL[("repmixer", "fp32")])
    # Odd sizes exercise the ragged edge tiles of the pixel grid.
    for shape in REPMIXER_RAGGED:
        for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            args = repmixer_inputs(*shape, dtype)
            out = repmixer_block(*args)
            torch.cuda.synchronize()
            check_close(f"repmixer {kind} ragged {shape}", out, repmixer_block_reference(*args),
                        TOL[("repmixer", kind)])
    return worst


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


def build_policy(attention_impl: str, vision_block_impl: str, quantization: str = "none"):
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy

    cfg = FastVLAConfig(
        vlm_model_name="fastvlm-0.5b", bootstrap_model_name="fastvlm-0.5b",
        image_size=IMAGE, tokenizer_max_length=TEXT_LEN, dtype="bfloat16",
        param_dtype="bfloat16", dropout=0.0, attention_impl=attention_impl,
        vision_block_impl=vision_block_impl, quantization=quantization, seed=SEED,
    )
    return FastVLAPolicy(cfg)


def phase_policy():
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    log("[3/14] FastVLA-0.5B policy, batch 128, 256 px, bf16, full depth")
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
    expect = {"flash_attention": 24, "repmixer_block": 38, "paged_attention": 0, "paged_attention_window": 0}
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


# ---------------------------------------------------------------------------
# training

# configs/train_aloha.yaml: FastVLA-0.5B, batch 8, 512 px (64 image tokens),
# tokenizer_max_length 64, bf16 compute over fp32 parameters, dropout 0.1,
# lr 1e-4, weight decay 1e-4, seed 42; camera frames of ALOHA's 480 x 640,
# which the letterbox resizes on the card.
TRAIN_FRAME_HW = (480, 640)
TRAIN_LR, TRAIN_WD, TRAIN_DROPOUT, TRAIN_SEED = 1e-4, 1e-4, 0.1, 42
# Frozen backbone: 12 steps saving at step 10, one evaluation, a resume from
# step 10 for the last 2 steps; full backbone: 3 steps.
TRAIN_STEPS, TRAIN_SAVE_STEPS, TRAIN_EVAL_SAMPLES, TRAIN_FULL_STEPS = 12, 10, 16, 3
# Flash and RepMixer launches a forward of FastVLA-0.5B (24 decoder layers;
# FastViTHD's RepMixer blocks, depths 2 / 12 / 24). With the full backbone the
# decoder blocks are rematerialized: each step runs their forward twice.
FLASH_A_FORWARD, REPMIXER_A_FORWARD = DECODER_LAYERS, 38
# Kernel path against plain path on one train step, bf16: relative L2 of the
# loss, the gradient norm and the head's gradients (the policy's limit); of
# every gradient leaf in fp32 (the kernels match their plain versions in fp32
# to about 1e-6).
TRAIN_REL_L2, TRAIN_FP32_REL_L2 = POLICY_REL_L2, 1e-4
# The backbone's gradients, bf16, jointly: the same roundings reach every
# gradient through the backward; measured 1.48e-2 on an H100 (PERF.md), the limit
# is the policy's, twice that.
TRAIN_BACKBONE_REL_L2 = POLICY_REL_L2
TRAIN_FP32 = dict(batch=2, image=256)
# Train steps timed a path and turn (kernel, plain, plain, kernel), after one
# step whose loss and gradient norm are held kernel path against plain path.
TRAIN_TIMED_STEPS = 20
TRAIN_MODEL, TRAIN_DEVICE = "fastvlm-0.5b", "cuda"


def train_policy(impl="auto", full=False, image=TRAIN_IMAGE, dtype="bfloat16", dropout=TRAIN_DROPOUT):
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy

    cfg = FastVLAConfig(
        vlm_model_name=TRAIN_MODEL, bootstrap_model_name=TRAIN_MODEL, image_size=image,
        tokenizer_max_length=TEXT_LEN, dtype=dtype, param_dtype="float32", dropout=dropout,
        attention_impl=impl, vision_block_impl=impl, train_backbone=full, freeze_backbone=not full, seed=SEED,
    )
    return FastVLAPolicy(cfg, device=TRAIN_DEVICE)


def copy_weights(dst, src) -> None:
    dst.model.backbone.model.load_state_dict(src.model.backbone.model.state_dict())
    dst.model.head.load_state_dict(src.model.head.state_dict())


def train_config(out: Path, **kw):
    from vla_fastvlm_tpu_torch.training import TrainingConfig

    settings = dict(output_dir=str(out), learning_rate=TRAIN_LR, weight_decay=TRAIN_WD, seed=TRAIN_SEED,
                    report_to=[], logging_steps=1, eval_steps=10**9, save_steps=10**9, mixed_precision="bf16")
    settings.update(kw)
    return TrainingConfig(**settings)


def check_launches(what: str, counts: dict, forwards: int, flash_runs: int = 1) -> None:
    """Launches of a run of ``forwards`` forwards, each running the decoder
    blocks' forward ``flash_runs`` times."""
    expect = {"flash_attention": FLASH_A_FORWARD * forwards * flash_runs,
              "repmixer_block": REPMIXER_A_FORWARD * forwards, "paged_attention": 0, "paged_attention_window": 0}
    log(f"  {what}: launches {counts} (expected {expect})")
    if counts != expect:
        fail(f"{what}: launch counts {counts} != {expect}")


def read_metrics(out: Path) -> list:
    lines = [json.loads(ln) for ln in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    import math

    bad = [ln for ln in lines if not all(math.isfinite(ln[k]) for k in ("train/loss", "train/grad_norm"))]
    if bad:
        fail(f"non-finite loss or gradient norm in {out}: {bad[0]}")
    return lines


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    den = float(b.norm())
    return float((a - b).norm()) / den if den > 0 else float(a.norm() > 0) * float("inf")


def step_grads(policy, arrays):
    """One train step's loss (dropout from a generator seeded alike on both
    paths), its trainable gradients by name and their global norm: what
    ``Trainer._train_step`` computes before its update."""
    import torch

    from vla_fastvlm_tpu_torch.training import global_norm

    trainable = policy.trainable_params()
    names = [f"{part}.{n}" for part, sub in trainable.items() for n in sub]
    params = [p.requires_grad_(True) for sub in trainable.values() for p in sub.values()]
    gen = torch.Generator(device=policy.device).manual_seed(TRAIN_SEED)
    loss, _ = policy.loss_fn(arrays, train=True, generator=gen)
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    return dict(loss=loss.detach(), grad_norm=global_norm(grads), grads=dict(zip(names, grads)))


def step_trainers(kernel, plain) -> dict:
    """A Trainer for each path's policy, for timed steps on a batch already
    on the card."""
    from vla_fastvlm_tpu_torch.training import Trainer

    return {path: Trainer(pol, [], None, train_config(ROOT / "build", max_steps=10**9))
            for path, pol in (("kernel", kernel), ("plain", plain))}


def compare_paths(what, kernel, plain, limits) -> dict:
    """Kernel path against plain path on the same weights and batch: the loss,
    the gradient norm and the gradients (``limits``: part -> joint relative
    L2 limit, "leaf" -> limit of every leaf)."""
    import torch

    out = {"loss": rel_l2(kernel["loss"], plain["loss"]), "grad_norm": rel_l2(kernel["grad_norm"], plain["grad_norm"])}
    for part in ("head", "backbone", "lora"):
        names = [n for n in kernel["grads"] if n.startswith(part + ".")]
        if not names:
            continue
        cat = lambda d: torch.cat([d[n].float().reshape(-1) for n in names])
        out[f"{part} grads"] = rel_l2(cat(kernel["grads"]), cat(plain["grads"]))
        leaf = {n: rel_l2(kernel["grads"][n], plain["grads"][n]) for n in names}
        worst = max(leaf, key=leaf.get)
        out[f"{part} worst leaf"] = leaf[worst]
        log(f"  {what}: {part} grads rel_l2 {out[f'{part} grads']:.3e} over {len(names)} leaves; worst leaf "
            f"{worst} {leaf[worst]:.3e}")
    bad = [n for n, g in kernel["grads"].items() if not bool(torch.isfinite(g).all())]
    zero = [n for n, g in kernel["grads"].items() if not bool(g.any())]
    log(f"  {what}: loss {float(kernel['loss']):.5f} (plain {float(plain['loss']):.5f}, rel {out['loss']:.3e}), "
        f"grad norm {float(kernel['grad_norm']):.4f} (plain {float(plain['grad_norm']):.4f}, rel "
        f"{out['grad_norm']:.3e}); {len(kernel['grads'])} trainable leaves, {len(bad)} non-finite, "
        f"{len(zero)} all zero")
    if bad:
        fail(f"{what}: non-finite gradients in {bad[:5]}")
    for key, limit in limits.items():
        if key == "leaf":
            worst = {n: rel_l2(kernel["grads"][n], plain["grads"][n]) for n in kernel["grads"]}
            over = {n: e for n, e in worst.items() if not e <= limit}
            if over:
                fail(f"{what}: {len(over)} gradient leaves beyond rel_l2 {limit:g}, e.g. {sorted(over.items())[:3]}")
        elif not out[key] <= limit:
            fail(f"{what}: {key} rel_l2 {out[key]:.3e} beyond {limit:g}")
    return out


def aloha_batch(records) -> dict:
    """Records -> the collated batch the data loader gives (images in [0, 1])."""
    from vla_fastvlm_tpu_torch.data import AlohaDataset, aloha_collate_fn

    ds = AlohaDataset(source=records)
    return aloha_collate_fn([ds[i] for i in range(len(ds))])


def time_train_steps(label, trainers, arrays, batch, profile_dir=None, steps=TRAIN_TIMED_STEPS) -> dict:
    """p50 train step (host clock around synchronized steps) of the kernel
    path and the plain path, in turns; under --profile each one's device
    time a step by part. The first step of each path (a warm-up, the weights
    alike) holds the loss and gradient norm that ``Trainer._train_step``
    returns, kernel path against plain path."""
    import torch

    def timed_steps(trainer, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer._train_step(arrays)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    first = {path: trainers[path]._train_step(arrays) for path in ("kernel", "plain")}
    for key in ("loss", "grad_norm"):
        err = rel_l2(first["kernel"][key], first["plain"][key])
        log(f"  train step {label}, first step: {key} {float(first['kernel'][key]):.5f} (plain "
            f"{float(first['plain'][key]):.5f}, rel {err:.3e})")
        if not err <= TRAIN_REL_L2:
            fail(f"train step {label}: the first step's {key} rel_l2 {err:.3e} beyond {TRAIN_REL_L2:g}")
    ms = {"kernel": [], "plain": []}
    for path in ("kernel", "plain", "plain", "kernel"):
        ms[path].extend(timed_steps(trainers[path], steps))
    result = {}
    for path, times in ms.items():
        p50 = statistics.median(times)
        result[path] = dict(p50_ms=p50, samples_per_s=batch / p50 * 1e3, min_ms=min(times), max_ms=max(times),
                            n=len(times))
        log(f"  train step {label}, {path} path: p50 {p50:.2f} ms, {batch / p50 * 1e3:.1f} samples/s "
            f"(min {min(times):.2f}, max {max(times):.2f}, n={len(times)})")
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        for path, trainer in trainers.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    trainer._train_step(arrays)
                torch.cuda.synchronize()
            name = f"train_{label.replace(' ', '_').replace(',', '')}_{path}"
            (profile_dir / f"{name}_profile.txt").write_text(
                prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
            parts = step_parts(prof, 3)
            total = sum(parts.values())
            result[path]["device_ms_by_part"] = parts
            log(f"  {name}: device time a step {total:.2f} ms: "
                + ", ".join(f"{part} {v:.2f} ms ({v / total:.1%})" for part, v in parts.items()))
    return result


def phase_train(profile_dir: Path | None = None) -> dict:
    import shutil

    import numpy as np
    import torch

    from vla_fastvlm_tpu_torch.data import AlohaDataset, SyntheticAlohaSource, create_aloha_dataloader
    from vla_fastvlm_tpu_torch.io.checkpoint import load_policy_from_checkpoint
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.training import Trainer
    from vla_fastvlm_tpu_torch.utils.flops import device_peak_flops, fastvlm_train_flops, mfu

    log(f"[4/14] training FastVLA-0.5B at configs/train_aloha.yaml's settings: batch {TRAIN_BATCH}, "
        f"{TRAIN_IMAGE} px from {TRAIN_FRAME_HW[0]}x{TRAIN_FRAME_HW[1]} frames, bf16 over fp32 parameters, "
        f"dropout {TRAIN_DROPOUT}, full depth")
    out = ROOT / "build" / "train_smoke"
    shutil.rmtree(out, ignore_errors=True)
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    records = SyntheticAlohaSource(num_samples=TRAIN_STEPS * TRAIN_BATCH, image_hw=TRAIN_FRAME_HW, seed=SEED)
    train_ds, eval_ds = AlohaDataset(source=records), AlohaDataset(source=records, limit_samples=TRAIN_EVAL_SAMPLES)
    loader = lambda ds, shuffle: create_aloha_dataloader(ds, batch_size=TRAIN_BATCH, shuffle=shuffle,
                                                         num_workers=2, seed=SEED)
    result = {}
    lap("records")

    # Frozen backbone: fit, evaluate, checkpoint layout.
    policy = train_policy()
    lap("build")
    trainer = Trainer(policy, loader(train_ds, True), loader(eval_ds, False),
                      train_config(out, max_steps=TRAIN_STEPS, save_steps=TRAIN_SAVE_STEPS, keep_last_n=1))
    reset_launch_counts()
    trainer.fit()
    eval_mse = trainer.evaluate()["eval/mse"]
    torch.cuda.synchronize()
    forwards = TRAIN_STEPS + -(-TRAIN_EVAL_SAMPLES // TRAIN_BATCH)
    check_launches(f"frozen backbone: {TRAIN_STEPS} steps + evaluation", launch_counts(), forwards)
    lines = read_metrics(out)
    if [ln["step"] for ln in lines] != list(range(1, TRAIN_STEPS + 1)) or not np.isfinite(eval_mse):
        fail(f"frozen backbone: logged steps {[ln['step'] for ln in lines]}, eval mse {eval_mse}")
    lap("frozen fit")
    log(f"  frozen backbone: loss {lines[0]['train/loss']:.4f} -> {lines[-1]['train/loss']:.4f}, grad norm "
        f"{lines[-1]['train/grad_norm']:.4f}, lr {lines[-1]['train/lr']:.3e}, eval mse {eval_mse:.4f}")
    ckpt = out / "checkpoints" / f"step-{TRAIN_SAVE_STEPS}"
    layout = [out / "training_config.json", ckpt / "policy_config.json", ckpt / "policy_state_dict.safetensors",
              ckpt / "train_state" / "train_state.pt"]
    missing = [str(p.relative_to(out)) for p in layout if not p.is_file()]
    present = sorted(p.name for p in (out / "checkpoints").iterdir())
    if missing or present != [ckpt.name]:
        fail(f"checkpoint layout: missing {missing}, checkpoints {present}")
    del trainer

    # A new trainer resumes from step 10 (the policy's weights, the optimizer
    # state, the counters and the generator all from the checkpoint) for the
    # last 2 steps; the step-12 save prunes step-10 (keep_last_n 1).
    resumed = Trainer(policy, loader(train_ds, True), None,
                      train_config(out, max_steps=TRAIN_STEPS, save_steps=TRAIN_STEPS, keep_last_n=1,
                                   resume_from=str(ckpt)))
    reset_launch_counts()
    resumed.fit()
    torch.cuda.synchronize()
    check_launches(f"resumed from {ckpt.name}", launch_counts(), TRAIN_STEPS - TRAIN_SAVE_STEPS)
    steps = [ln["step"] for ln in read_metrics(out)]
    present = sorted(p.name for p in (out / "checkpoints").iterdir())
    state = (resumed.global_step, resumed.epoch, resumed.updates)
    log(f"  resumed: global_step, epoch, updates {state}; logged steps {steps[TRAIN_STEPS:]}; checkpoints {present}")
    if state != (TRAIN_STEPS, 0, TRAIN_STEPS) or steps[TRAIN_STEPS:] != list(range(TRAIN_SAVE_STEPS + 1, TRAIN_STEPS + 1)) \
            or present != [f"step-{TRAIN_STEPS}"]:
        fail(f"resume: state {state}, logged steps {steps}, checkpoints {present}")

    lap("resume")

    # The written weights load into a fresh policy with the same actions, bit for bit.
    loaded, _ = load_policy_from_checkpoint(out / "checkpoints" / f"step-{TRAIN_STEPS}", device=TRAIN_DEVICE)
    batch8 = aloha_batch(records[:TRAIN_BATCH])
    obs = (batch8["images"], batch8["states"], batch8["tasks"])
    same = torch.equal(policy.forward(*obs), loaded.forward(*obs))
    log(f"  reloaded step-{TRAIN_STEPS} into a fresh policy: actions bit-equal {same}")
    if not same:
        fail("the reloaded checkpoint's actions differ from the trained policy's")
    del resumed, policy
    arrays8 = loaded.to_device(loaded.prepare_batch(batch8))
    lap("reload")

    # Full backbone: 3 steps, gradients through both kernels, decoder remat.
    held = torch.cuda.memory_allocated() / 2**30  # the frozen policy, kept for the comparisons
    full = train_policy(full=True)
    full_trainer = Trainer(full, loader(train_ds, True), None, train_config(out / "full", max_steps=TRAIN_FULL_STEPS))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    full_trainer.fit()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_launches(f"full backbone: {TRAIN_FULL_STEPS} steps", launch_counts(), TRAIN_FULL_STEPS, flash_runs=2)
    lines = read_metrics(out / "full")
    n_params = sum(p.numel() for p in full_trainer._params)
    log(f"  full backbone: {n_params / 1e6:.1f} M trainable parameters, loss {lines[0]['train/loss']:.4f} -> "
        f"{lines[-1]['train/loss']:.4f}, grad norm {lines[-1]['train/grad_norm']:.4f}; peak memory "
        f"{peak:.2f} GiB (torch.cuda.max_memory_allocated), {held:.2f} GiB of it held before the policy was "
        f"built: the full-backbone training's own {peak - held:.2f} GiB")
    result["full_backbone_training_gib"] = peak - held
    del full_trainer
    shutil.rmtree(out, ignore_errors=True)
    lap("full fit")

    # Kernel path against plain path: fp32 at batch 2 / 256 px first (then freed), then bf16.
    kf = train_policy(full=True, image=TRAIN_FP32["image"], dtype="float32")
    pf = train_policy("xla", full=True, image=TRAIN_FP32["image"], dtype="float32")
    copy_weights(pf, kf)
    arrays2 = kf.to_device(kf.prepare_batch(aloha_batch(records[:TRAIN_FP32["batch"]])))
    result["fp32 full backbone"] = compare_paths(
        f"fp32 full backbone, batch {TRAIN_FP32['batch']}, {TRAIN_FP32['image']} px",
        step_grads(kf, arrays2), step_grads(pf, arrays2),
        {"loss": TRAIN_FP32_REL_L2, "leaf": TRAIN_FP32_REL_L2})
    del kf, pf
    torch.cuda.empty_cache()
    lap("fp32 compare")

    plain_full = train_policy("xla", full=True)
    copy_weights(plain_full, full)
    result["bf16 full backbone"] = compare_paths(
        "bf16 full backbone", step_grads(full, arrays8), step_grads(plain_full, arrays8),
        {"loss": TRAIN_REL_L2, "grad_norm": TRAIN_REL_L2, "head grads": TRAIN_REL_L2,
         "backbone grads": TRAIN_BACKBONE_REL_L2})
    plain_frozen = train_policy("xla")
    copy_weights(plain_frozen, loaded)
    result["bf16 frozen"] = compare_paths(
        "bf16 frozen backbone", step_grads(loaded, arrays8), step_grads(plain_frozen, arrays8),
        {"loss": TRAIN_REL_L2, "grad_norm": TRAIN_REL_L2, "head grads": TRAIN_REL_L2})
    lap("bf16 compare")

    # Times.
    log("  train step times (host clock around synchronized steps; inputs on the card)")
    timed = {f"frozen, batch {TRAIN_BATCH}, {TRAIN_IMAGE} px": (step_trainers(loaded, plain_frozen), arrays8,
                                                                TRAIN_BATCH)}
    k256, p256 = train_policy(image=IMAGE), train_policy("xla", image=IMAGE)
    copy_weights(p256, k256)
    images, states, tasks = policy_inputs()
    batch128 = dict(images=images, states=states, tasks=tasks,
                    actions=np.random.default_rng(SEED).standard_normal((BATCH, 14)).astype(np.float32))
    timed[f"frozen, batch {BATCH}, {IMAGE} px"] = (step_trainers(k256, p256),
                                                   k256.to_device(k256.prepare_batch(batch128)), BATCH)
    timed[f"full backbone, batch {TRAIN_BATCH}, {TRAIN_IMAGE} px"] = (step_trainers(full, plain_full), arrays8,
                                                                     TRAIN_BATCH)
    lap("256 px build")
    for label, (trainers, arrays, batch) in timed.items():
        result[label] = time_train_steps(label, trainers, arrays, batch, profile_dir)
        lap(f"time {label}")
    label = f"frozen, batch {BATCH}, {IMAGE} px"
    t0 = time.perf_counter()
    step_flops = fastvlm_train_flops(k256.model, BATCH, TEXT_LEN)
    count_s = time.perf_counter() - t0
    card = card_line()
    for path in ("kernel", "plain"):
        p50 = result[label][path]["p50_ms"]
        result[label][path]["mfu"] = mfu(step_flops, p50 / 1e3)
        log(f"  train step {label}, {path} path: {step_flops / 1e9:.1f} GFLOP a step (fastvlm_train_flops, "
            f"counted in {count_s:.2f} s), MFU {result[label][path]['mfu']:.4f} at its p50 {p50:.2f} ms of "
            f"{device_peak_flops() / 1e12:.1f} TFLOP/s; {card}")
    result[label]["gflop"] = step_flops / 1e9
    log(f"  seconds by part: {laps}")
    log(json.dumps({"train": result}))
    return result


def serving_backbone(kv="none", quantization="none"):
    """FastVLM-0.5B at 1024 px, bf16, from seed 0 (KV pools of ``kv``; the
    decoder's projections quantized with ``quantization``)."""
    from vla_fastvlm_tpu_torch.model import FastVLMBackbone, FastVLMBackboneConfig

    return FastVLMBackbone(FastVLMBackboneConfig(
        model_id="fastvlm-0.5b", bootstrap_model_id="fastvlm-0.5b", dtype="bfloat16",
        param_dtype="bfloat16", kv_cache_quantization=kv, quantization=quantization, seed=SEED,
    ))


def make_servers():
    """The bf16 model of FastVLM-0.5B at 1024 px from seed 0, and the same
    weights under a text config with int8 KV pools."""
    bf16, int8 = serving_backbone("none"), serving_backbone("int8")
    int8.model.load_state_dict(bf16.model.state_dict())
    return bf16.model, int8.model


def new_server(model, impl):
    from vla_fastvlm_tpu_torch.serving import PagedGenerationServer

    return PagedGenerationServer(model, eos_token_id=-1, temperature=0.0, seed=SEED, decode_impl=impl, **SERVE)


def device_ms(avg) -> float:
    """Device time (ms) of the kernels in a profile's ``key_averages()``: the
    self device time of the device-side events, as the profiler's own table
    totals it (an operator's row repeats its kernels' time, so it is not
    added)."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3


def run_stream(server, reqs, table: Path | None = None, slots: int = SERVE["num_slots"],
               arrivals_per_tick: int = SERVE_ARRIVALS, lora_routes=None):
    """``scripts/serve.py``'s loop: up to ``arrivals_per_tick`` arrivals a
    tick while slots and pages allow, then one ``step`` (a decode tick, or a
    draft-verify round on a speculative server). Once every slot is busy and
    nothing arrives, ``IDLE_TICKS`` ticks run under the profiler for the
    device time of a tick; their time and tokens are left out of the tick
    times and the rate. With ``table`` the profile of those ticks is written
    there, by device time and by host time. ``lora_routes``: each
    request's ``lora_index`` on a multi-LoRA server."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    spec = hasattr(server, "spec_ticks")
    ticks = lambda: server.spec_ticks if spec else server.ticks
    submitted, finished, tick_times, prof_ms = 0, {}, [], None
    window_tokens, window_s = 0, 0.0
    t_start = time.perf_counter()
    while len(finished) < len(reqs):
        arrivals = 0
        while submitted < len(reqs) and server.has_free_slot() and arrivals < arrivals_per_tick:
            server.submit(*reqs[submitted], **({} if lora_routes is None else {"lora_index": lora_routes[submitted]}))
            submitted += 1
            arrivals += 1
        if prof_ms is None and arrivals == 0 and server.num_active == slots and ticks() >= 8:
            w0 = time.perf_counter()
            emitted0 = server.spec_tokens_emitted if spec else 0
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(IDLE_TICKS):
                    window_tokens += 0 if spec else server.num_active  # one token per active slot
                    finished.update(server.step())
                torch.cuda.synchronize()
            window_tokens += server.spec_tokens_emitted - emitted0 if spec else 0
            # Reading the profile takes seconds for a round's ~7,000 launches:
            # it stays inside the window left out of the run's time.
            avg = prof.key_averages()
            prof_ms = device_ms(avg) / IDLE_TICKS
            if table is not None:
                table.write_text(avg.table(sort_by="self_cuda_time_total", row_limit=30) + "\n"
                                 + avg.table(sort_by="self_cpu_time_total", row_limit=30))
            window_s = time.perf_counter() - w0
            continue
        t0 = time.perf_counter()
        finished.update(server.step())
        torch.cuda.synchronize()
        tick_times.append((time.perf_counter() - t0) * 1e3)
    elapsed = time.perf_counter() - t_start - window_s
    total = sum(len(t) for t in finished.values())
    p50 = statistics.median(tick_times)
    summary = {
        "requests": len(reqs), "slots": slots, "prefill_batch": server.prefill_batch,
        "total_new_tokens": total, "tokens_per_sec": (total - window_tokens) / elapsed, "p50_tick_ms": p50,
        "ticks": ticks(), "admissions": server.admissions,
        "device_ms_per_decode_tick": prof_ms,
        "device_idle_share": None if prof_ms is None else 1.0 - prof_ms / p50,
    }
    if spec:
        summary.update(tokens_per_tick=server.tokens_per_tick, tokens_per_slot_round=server.tokens_per_slot_round)
    return finished, summary


def check_answers(name, server, finished, n_requests, n_tokens):
    """Every request answered with ``n_tokens`` tokens, every page back."""
    if len(finished) != n_requests or any(len(t) != n_tokens for t in finished.values()):
        fail(f"{name}: {len(finished)} requests answered, token counts {sorted({len(t) for t in finished.values()})}")
    pool = server.pool
    if pool.free_pages != pool.num_pages - 1 or pool.page_table.any():
        fail(f"{name}: {pool.free_pages} of {pool.num_pages - 1} pages back on the free list")


def same_tokens(a: dict, b: dict) -> float:
    """Share of positions where two runs over the same requests agree."""
    pairs = [(x, y) for rid in a for x, y in zip(a[rid], b[rid])]
    return sum(x == y for x, y in pairs) / len(pairs)


def phase_serving(profile_dir: Path | None = None):
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    log(f"[5/14] paged serving: FastVLM-0.5B, 1024 px, bf16, {SERVE_REQUESTS} requests, 64 slots, 64 new tokens")
    t0 = time.perf_counter()
    model, model_int8 = make_servers()
    reqs = serve_stream()
    log(f"  models and stream ready in {time.perf_counter() - t0:.1f} s")

    # One admitted state (64 slots, 8 ticks decoded), both tick programs.
    server = new_server(model, "kernel")
    for req in reqs[: SERVE["num_slots"]]:
        server.submit(*req)
    for _ in range(8):
        server.step()
    kernel_logits, gathered_logits = server.tick_logits("kernel").float(), server.tick_logits("gathered").float()
    rel = float((kernel_logits - gathered_logits).norm() / gathered_logits.norm())
    agree = float((kernel_logits.argmax(-1) == gathered_logits.argmax(-1)).float().mean())
    log(f"  kernel vs gathered tick logits from one admitted state: rel_l2={rel:.3e} "
        f"(limit {SERVE_LOGITS_REL_L2:g}), same argmax in {agree:.3f} of slots")
    if not rel <= SERVE_LOGITS_REL_L2:
        fail(f"kernel tick differs from the gathered tick: rel_l2={rel:.3e}")
    del server
    torch.cuda.empty_cache()

    outputs, summaries, counts = {}, {}, {}
    for name, mdl, impl in (("kernel", model, "kernel"), ("gathered", model, "gathered"),
                            ("kernel_int8", model_int8, "kernel")):
        server = new_server(mdl, impl)
        reset_launch_counts()
        table = None if profile_dir is None else profile_dir / f"serve_{name}_ticks.txt"
        finished, summary = run_stream(server, reqs, table)
        counts[name] = launch_counts()
        summaries[name], outputs[name] = summary, finished
        log(f"  {name}: {json.dumps(summary)}")
        log(f"  {name}: launches {counts[name]}")
        check_answers(name, server, finished, SERVE_REQUESTS, SERVE["max_new_tokens"])
        expect = {"flash_attention": 0, "repmixer_block": 38 * server.admissions,
                  "paged_attention": DECODER_LAYERS * server.ticks if impl == "kernel" else 0,
                  "paged_attention_window": 0}
        if counts[name] != expect:
            fail(f"{name}: launch counts {counts[name]} != {expect}")
        del server
        torch.cuda.empty_cache()
    for other in ("gathered", "kernel_int8"):
        log(f"  greedy tokens identical between kernel and {other}: "
            f"{same_tokens(outputs['kernel'], outputs[other]):.4f}")
    del model_int8
    return summaries, counts, model


def build_model(cfg, seed: int):
    """A FastVLM of ``cfg`` on the card, weights random from ``seed``."""
    import torch

    from vla_fastvlm_tpu_torch.models import FastVLM, init_weights

    with torch.device("cuda"):
        model = FastVLM(cfg)
    model.eval().requires_grad_(False)
    init_weights(model, torch.Generator(device="cuda").manual_seed(seed))
    return model


def spec_models():
    """FastVLM-7B (seed 0) and the FastVLM-0.5B draft with its vocab padded to
    the target's (seed 1), bf16 at 1024 px; and the target's weights, shared,
    under a text config with int8 KV pools."""
    import torch

    from vla_fastvlm_tpu_torch.models import FastVLM, FastVLMConfig, fastvithd, qwen2_0_5b, qwen2_7b

    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    target_cfg = FastVLMConfig(vision=fastvithd(**bf16), text=qwen2_7b(**bf16), image_size=1024)
    draft_cfg = FastVLMConfig(vision=fastvithd(**bf16), text=qwen2_0_5b(vocab_size=TARGET_VOCAB, **bf16),
                              image_size=1024)
    target, draft = build_model(target_cfg, SEED), build_model(draft_cfg, SEED + 1)
    return target, draft, int8_kv_twin(target)


def int8_kv_twin(model):
    """``model``'s weights, shared, under a text config with int8 KV pools."""
    import torch

    from vla_fastvlm_tpu_torch.models import FastVLM

    with torch.device("meta"):
        twin = FastVLM(model.cfg.replace(text=model.cfg.text.replace(kv_cache_quantization="int8")))
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin.eval().requires_grad_(False)


def new_spec_server(target, draft, impl):
    from vla_fastvlm_tpu_torch.serving import SpeculativePagedGenerationServer

    return SpeculativePagedGenerationServer(target, draft, eos_token_id=-1, temperature=0.0, seed=SEED,
                                            decode_impl=impl, **SPEC)


def divergence_report(target, reqs, spec_out: dict, plain_out: dict, logit_err: float, name: str) -> dict:
    """Fault or near-tie: for each request, the first position where the
    speculative server's greedy tokens and the plain paged server's differ,
    and there the target's logits recomputed on the common prefix by another
    program, the dense cache path (``prefill`` of the request, then
    ``decode_step`` teacher-forced with the common tokens, 8 requests at a
    time): the top-2 gap and the gap between the two servers' tokens, set
    against ``logit_err``, the largest |kernel - gathered| verify logit
    difference of one admitted state. Returns the summary it prints."""
    import numpy as np
    import torch

    from vla_fastvlm_tpu_torch.models.qwen2 import init_kv_cache

    device = next(target.parameters()).device
    first = {}
    for rid in sorted(spec_out):
        diff = [i for i, (x, y) in enumerate(zip(spec_out[rid], plain_out[rid])) if x != y]
        if diff:
            first[rid] = diff[0]
    rows = []
    div = sorted(first)
    for c in range(0, len(div), 8):
        chunk = div[c:c + 8]
        ids, mask, images = (np.concatenate([reqs[rid][j] for rid in chunk]) for j in range(3))
        steps = max(first[rid] for rid in chunk) + 1
        with torch.no_grad():
            cache = init_kv_cache(target.cfg.text, len(chunk), N_IMG + ids.shape[1] + steps, device=device)
            logits, _, cache, _, _ = target.prefill(
                *(torch.from_numpy(a).to(device) for a in (images, ids, mask)), cache)
            for j in range(steps):
                for i, rid in enumerate(chunk):
                    if first[rid] == j:
                        row = logits[i].float()
                        top = row.topk(2).values
                        a, b = spec_out[rid][j], plain_out[rid][j]
                        rows.append(dict(request=rid, position=j, top2_gap=float(top[0] - top[1]),
                                         token_gap=abs(float(row[a] - row[b])), dense_argmax=int(row.argmax()),
                                         spec_token=int(a), plain_token=int(b)))
                if j + 1 < steps:
                    tok = torch.tensor([[plain_out[rid][j]] for rid in chunk], dtype=torch.int32, device=device)
                    logits, cache = target.decode_step(tok, cache)
    for r in rows:
        log(f"  {name} vs plain, request {r['request']}: first differs at {r['position']}, top-2 gap "
            f"{r['top2_gap']:.4f}, gap between the two tokens {r['token_gap']:.4f} (dense path picks "
            f"{r['dense_argmax']}; {r['spec_token']} / {r['plain_token']})")
    within = sum(r["token_gap"] <= logit_err for r in rows)
    summary = dict(requests=len(spec_out), diverged=len(rows), within_logit_err=within, logit_err=logit_err,
                   max_token_gap=max((r["token_gap"] for r in rows), default=None),
                   median_top2_gap=statistics.median([r["top2_gap"] for r in rows]) if rows else None)
    log(f"  {name}: {json.dumps(summary)}")
    return summary


def phase_speculative(draft_self, profile_dir: Path | None = None):
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.serving import PagedGenerationServer

    log(f"[6/14] speculative serving: FastVLM-7B target, FastVLM-0.5B draft, k = {SPEC['k']}, 1024 px, bf16, "
        f"{SPEC_REQUESTS} requests, {SPEC['num_slots']} slots, {SPEC['max_new_tokens']} new tokens")
    t0 = time.perf_counter()
    target, draft, target_int8 = spec_models()
    reqs = serve_stream()[:SPEC_REQUESTS]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in target.parameters())
    log(f"  models ready in {time.perf_counter() - t0:.1f} s ({n_params / 1e9:.2f} B target parameters)")
    slots = SPEC["num_slots"]

    # One admitted state (16 slots, 3 rounds), both verify programs.
    server = new_spec_server(target, draft, "kernel")
    for req in reqs[:slots]:
        server.submit(*req)
    for _ in range(3):
        server.step()
    kernel_logits, gathered_logits = server.verify_logits("kernel").float(), server.verify_logits("gathered").float()
    rel = float((kernel_logits - gathered_logits).norm() / gathered_logits.norm())
    agree = float((kernel_logits.argmax(-1) == gathered_logits.argmax(-1)).float().mean())
    logit_err = float((kernel_logits - gathered_logits).abs().max())
    log(f"  kernel vs gathered verify logits from one admitted state: rel_l2={rel:.3e} "
        f"(limit {SERVE_LOGITS_REL_L2:g}), max |difference| {logit_err:.4f}, same argmax in {agree:.3f} of window rows")
    if not rel <= SERVE_LOGITS_REL_L2:
        fail(f"kernel verify differs from the gathered verify: rel_l2={rel:.3e}")
    del server
    torch.cuda.empty_cache()

    outputs, summaries, counts = {}, {}, {}
    for name, tgt, impl in (("spec_kernel", target, "kernel"), ("spec_gathered", target, "gathered"),
                            ("spec_kernel_int8", target_int8, "kernel")):
        server = new_spec_server(tgt, draft, impl)
        reset_launch_counts()
        table = None if profile_dir is None else profile_dir / f"{name}_rounds.txt"
        finished, summary = run_stream(server, reqs, table, slots, SPEC_ARRIVALS)
        counts[name] = launch_counts()
        summaries[name], outputs[name] = summary, finished
        log(f"  {name}: {json.dumps(summary)}")
        log(f"  {name}: launches {counts[name]}")
        check_answers(name, server, finished, SPEC_REQUESTS, SPEC["max_new_tokens"])
        # Every admission runs the target's vision tower and the draft's.
        expect = {"flash_attention": 0, "repmixer_block": 2 * 38 * server.admissions, "paged_attention": 0,
                  "paged_attention_window": TARGET_LAYERS * server.spec_ticks if impl == "kernel" else 0}
        if counts[name] != expect:
            fail(f"{name}: launch counts {counts[name]} != {expect}")
        del server
        torch.cuda.empty_cache()

    # The plain paged server on the same target: greedy agreement, printed only
    # (random weights put the argmax near ties; one flip changes the rest).
    plain = PagedGenerationServer(target, eos_token_id=-1, temperature=0.0, seed=SEED, decode_impl="kernel",
                                  **{k: v for k, v in SPEC.items() if k != "k"})
    plain_out, plain_summary = run_stream(plain, reqs, None, slots, SPEC_ARRIVALS)
    log(f"  plain paged server, same target: {json.dumps(plain_summary)}")
    check_answers("plain 7B", plain, plain_out, SPEC_REQUESTS, SPEC["max_new_tokens"])
    for name in outputs:
        log(f"  greedy tokens identical between {name} and the plain paged server: "
            f"{same_tokens(outputs[name], plain_out):.4f}")
    summaries["plain_7b"] = plain_summary
    for name in ("spec_kernel", "spec_gathered"):
        divergence_report(target, reqs, outputs[name], plain_out, logit_err, name)
    del plain, target, draft, target_int8
    torch.cuda.empty_cache()

    # FastVLM-0.5B as its own draft: the proposals are the target's own
    # greedy tokens up to bf16 ties, so most are accepted.
    server = new_spec_server(draft_self, draft_self, "kernel")
    finished, summary = run_stream(server, serve_stream()[:SELF_DRAFT_REQUESTS], None, slots, SPEC_ARRIVALS)
    log(f"  self-draft 0.5B: {json.dumps(summary)}")
    check_answers("self-draft", server, finished, SELF_DRAFT_REQUESTS, SPEC["max_new_tokens"])
    if not server.tokens_per_slot_round >= SELF_DRAFT_MIN_TOKENS_PER_SLOT_ROUND:
        fail(f"self-draft: {server.tokens_per_slot_round:.3f} tokens per slot and round "
             f"< {SELF_DRAFT_MIN_TOKENS_PER_SLOT_ROUND}")
    summaries["self_draft"] = summary
    return summaries, counts


# The serving CLI, ``python -m vla_fastvlm_tpu_torch.scripts.serve``, called
# in-process: FastVLM-0.5B at its 1024 px, bf16, seed 0, on scripts/serve.py's
# stream at the SERVE shape (64 slots, admission batches of 16, prompts of
# 4..64 tokens, 64 new tokens, pages of 16, 128 requests arriving 16 a tick);
# the speculative run at the SPEC shape (16 slots, admission batches of 8, 32
# requests, 32 new tokens) with a FastVLM-0.5B draft (seed 1). Half the
# requests of a prefix-cache run repeat the first (--repeat-fraction 0.5).
SERVE_CLI = dict(model_id="fastvlm-0.5b", dtype="bfloat16", seed=SEED, paged=True, num_requests=SERVE_REQUESTS,
                 arrivals_per_tick=SERVE_ARRIVALS, **SERVE)
SERVE_CLI_RUNS = [
    ("paged", {}),
    ("paged_prefix", dict(prefix_cache=16, repeat_fraction=0.5)),
    ("paged_chunked", dict(prefill_chunk_tokens=16)),
    ("paged_prefix_chunked_int8", dict(prefix_cache=16, repeat_fraction=0.5, prefill_chunk_tokens=16,
                                       kv_cache_quantization="int8")),
    ("spec_paged_prefix_chunked", dict(draft_model_id="fastvlm-0.5b", spec_k=SPEC["k"], prefix_cache=8,
                                       repeat_fraction=0.5, prefill_chunk_tokens=16, num_requests=SPEC_REQUESTS,
                                       **{k: v for k, v in SPEC.items() if k != "k"})),
]
# The direct prefix check: 16 requests on one frame sharing a 48-token
# template (pages 16-18 after the image's 16), each with its own 16-token tail.
PARTIAL_REQUESTS, PARTIAL_TEMPLATE = 16, 48
# The whole-prompt hit's prompt width: its rows end 8 positions into a page.
HIT_WIDTH = 56


def check_cli_run(name, args, summary, counts) -> None:
    """A serving-CLI run: every request answered in full, every page back
    (free + cache-pinned = the pool before the cache is emptied, free
    after), prefix-cache counts where the traffic makes them, launch counts
    (paged = 24 x ticks or window = 24 x rounds; RepMixer = 38 x tower
    passes: miss admission batches, image chunks and draft prefills)."""
    if summary["total_new_tokens"] != args.num_requests * args.max_new_tokens:
        fail(f"serve_cli {name}: {summary['total_new_tokens']} tokens, not {args.num_requests} x {args.max_new_tokens}")
    pages = summary["pages"]
    if not (pages["free"] + pages["pinned"] == pages["usable"] == pages["free_after_evict"] and pages["tables_empty"]):
        fail(f"serve_cli {name}: pages {pages}")
    if args.prefix_cache:
        hits, partial, misses = (summary[f"prefix_cache_{k}"] for k in ("hits", "partial_hits", "misses"))
        if not (hits > 0 and misses > 0 and hits + partial + misses == args.num_requests):
            fail(f"serve_cli {name}: {hits} hits, {partial} partial hits, {misses} misses of {args.num_requests}")
    if args.prefill_chunk_tokens and (summary["admissions"] or not summary["image_chunks"]):
        fail(f"serve_cli {name}: chunked admission ran {summary['admissions']} whole prefills, "
             f"{summary['image_chunks']} image chunks")
    spec = args.draft_model_id is not None
    towers = summary["admissions"] + summary["image_chunks"] + summary.get("draft_admissions", 0)
    ticks = DECODER_LAYERS * summary["decode_ticks"]
    expect = {"flash_attention": 0, "repmixer_block": 38 * towers, "paged_attention": 0 if spec else ticks,
              "paged_attention_window": ticks if spec else 0}
    if counts != expect:
        fail(f"serve_cli {name}: launch counts {counts} != {expect}")


def rel_rows(got, ref) -> float:
    """Largest relative L2 error over the rows of two (B, V) logits."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def check_prefix_paths(model) -> dict:
    """Page-level partial hits (over bf16 and int8 pools), chunked admission
    and a whole-prompt hit on the paged server of ``model`` (FastVLM-0.5B,
    bf16, the SERVE shape), each held to the whole-prompt prefill of the
    same requests on the card: first-token logits within SERVE_LOGITS_REL_L2
    (those of a partial hit or a chunked admission are what its cache entry
    records). The whole hit runs at a 56-token bucket, so its prompt ends
    inside a page: its first token is the argmax of its entry's logits,
    which it leaves unchanged; its tail page is a private copy of the
    entry's (copy-on-write), and the entry's pages keep their bytes while
    it decodes."""
    import numpy as np
    import torch

    from vla_fastvlm_tpu_torch.models.qwen2 import init_kv_cache
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.serving import PagedGenerationServer

    def whole_prefill_logits(m, reqs):
        ids, mask, images = (np.concatenate([r[j] for r in reqs]) for j in range(3))
        with torch.no_grad():
            cache = init_kv_cache(m.cfg.text, len(reqs), N_IMG + ids.shape[1], device="cuda")
            return m.prefill(*(torch.from_numpy(a).cuda() for a in (images, ids, mask)), cache)[0]

    def entry_logits(server, reqs):
        return torch.stack([server._prefix_cache[server._prompt_hashes(*r)[0]]["logits"] for r in reqs])

    def drain(server, finished):
        while server.num_active:
            finished.update(server.step())
        return finished

    def check_pages(name, server, finished, n_requests):
        """Answers in full; free + pinned pages make the pool; all free once
        the cache is emptied."""
        pool = server.pool
        if pool.free_pages + len(server.pinned_pages()) != pool.num_pages - 1:
            fail(f"{name}: {pool.free_pages} free + {len(server.pinned_pages())} pinned of {pool.num_pages - 1}")
        server.evict_prefix_cache()
        check_answers(name, server, finished, n_requests, SERVE["max_new_tokens"])

    def new_server(m, **kw):
        return PagedGenerationServer(m, eos_token_id=-1, temperature=0.0, seed=SEED, decode_impl="kernel",
                                     **dict(SERVE, **kw))

    width = SERVE["prompt_len"]

    def partial_hits(name, m) -> dict:
        """The first request misses, the other 15 reuse its 19 shared pages
        (image and template) and prefill their 16-token tail."""
        rng = np.random.default_rng(SEED + 11)
        frame = rng.random((1, 3, 1024, 1024), dtype=np.float32)
        template = rng.integers(3, 250, PARTIAL_TEMPLATE)
        reqs = [(np.concatenate([template, rng.integers(3, 250, width - PARTIAL_TEMPLATE)]).astype(np.int32)[None],
                 np.ones((1, width), np.int32), frame) for _ in range(PARTIAL_REQUESTS)]
        server = new_server(m, prefix_cache_size=PARTIAL_REQUESTS)
        reset_launch_counts()
        server.submit(*reqs[0])
        finished = server.step()
        t0 = time.perf_counter()
        for req in reqs[1:]:
            server.submit(*req)
        submit_ms = (time.perf_counter() - t0) * 1e3 / (len(reqs) - 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finished.update(server.step())  # the 15 tails, then one decode tick
        torch.cuda.synchronize()
        tails_tick_ms = (time.perf_counter() - t0) * 1e3
        drain(server, finished)
        counts = launch_counts()
        hits = (server.prefix_cache_hits, server.prefix_cache_partial_hits, server.prefix_cache_misses)
        if hits != (0, PARTIAL_REQUESTS - 1, 1) or server.text_chunks != 1:
            fail(f"{name}: (hits, partial, misses) = {hits}, {server.text_chunks} text-chunk programs (the 15 "
                 "16-token tails share one)")
        expect = {"flash_attention": 0, "repmixer_block": 38, "paged_attention": DECODER_LAYERS * server.ticks,
                  "paged_attention_window": 0}
        if counts != expect:
            fail(f"{name}: launch counts {counts} != {expect}")
        err = rel_rows(entry_logits(server, reqs[1:]), whole_prefill_logits(m, reqs[1:]))
        shared = (N_IMG + PARTIAL_TEMPLATE) // SERVE["page_size"]
        log(f"  {name}: {hits[1]} of {len(reqs)} requests reuse {shared} pages and prefill the rest "
            f"({server.text_chunks} text-chunk programs); first-token logits against the whole-prompt prefill: max rel_l2 "
            f"{err:.3e} (limit {SERVE_LOGITS_REL_L2:g}); submit {submit_ms:.2f} ms a request; the tick admitting "
            f"the {hits[1]} tails {tails_tick_ms:.2f} ms; launches {counts}")
        if not err <= SERVE_LOGITS_REL_L2:
            fail(f"{name}: first-token logits rel_l2 {err:.3e}")
        check_pages(name, server, finished, len(reqs))
        return dict(partial_hits=hits[1], rel_l2=err, submit_ms=submit_ms, tails_tick_ms=tails_tick_ms)

    result = {"partial": partial_hits("partial hits", model)}
    torch.cuda.empty_cache()
    result["partial_int8"] = partial_hits("partial hits int8", int8_kv_twin(model))
    torch.cuda.empty_cache()

    # Chunked admission of 16 requests of the stream (an image chunk and four
    # 16-token text chunks).
    reqs = serve_stream(n=SERVE["prefill_batch"])
    server = new_server(model, prefix_cache_size=16, prefill_chunk_tokens=16)
    for req in reqs:
        server.submit(*req)
    server.flush()
    if (server.admissions, server.image_chunks, server.text_chunks) != (0, 1, width // 16):
        fail(f"chunked: {server.admissions} prefills, {server.image_chunks} image and {server.text_chunks} text chunks")
    err = rel_rows(entry_logits(server, reqs), whole_prefill_logits(model, reqs))
    log(f"  chunked admission: first-token logits against the whole-prompt prefill: max rel_l2 {err:.3e} "
        f"(limit {SERVE_LOGITS_REL_L2:g})")
    if not err <= SERVE_LOGITS_REL_L2:
        fail(f"chunked: first-token logits rel_l2 {err:.3e}")
    check_pages("chunked", server, drain(server, {}), len(reqs))
    result["chunked"] = dict(rel_l2=err)
    del server

    # A whole-prompt hit whose prompt ends inside a page: 256 image + 56
    # text rows fill 19 pages and 8 positions of the 20th. The first request
    # misses and decodes to its end (into the rest of the tail page); then
    # the repeat hits.
    rng = np.random.default_rng(SEED + 12)
    req = (rng.integers(3, 250, (1, HIT_WIDTH)).astype(np.int32), np.ones((1, HIT_WIDTH), np.int32),
           rng.random((1, 3, 1024, 1024), dtype=np.float32))
    server = new_server(model, prompt_len=(HIT_WIDTH, width), prefix_cache_size=2)
    server.submit(*req)
    finished = drain(server, {})
    entry = server._prefix_cache[server._prompt_hashes(*req)[0]]
    logits = entry["logits"].clone()
    n_full, part = divmod(entry["prefill_len"], SERVE["page_size"])
    pages = torch.tensor(entry["pages"], device="cuda")
    before = {name: buf[:, pages].clone() for name, buf in server.pool.pools().items()}
    rid = server.submit(*req)
    server.flush()
    slot = next(i for i, s in enumerate(server._slots) if s.active and s.request_id == rid)
    table = server.pool.page_table[slot, : n_full + 1].tolist()
    tail = int(table[n_full])
    private = (part > 0 and table[:n_full] == entry["pages"][:n_full] and tail != entry["pages"][n_full]
               and all(torch.equal(buf[:, tail, :, :part], before[name][:, n_full, :, :part])
                       for name, buf in server.pool.pools().items()))
    first = server._slots[slot].tokens[0]
    drain(server, finished)
    same_pages = all(torch.equal(buf[:, pages], before[name]) for name, buf in server.pool.pools().items())
    exact = torch.equal(entry["logits"], logits) and first == int(logits.argmax())
    log(f"  whole-prompt hit: first token {first} = argmax of the entry's logits, entry unchanged: {exact}; "
        f"{n_full} pages shared and the tail page ({part} prompt positions) a private copy: {private}; the "
        f"entry's {len(entry['pages'])} pages unchanged after the hit decoded: {same_pages}")
    if (server.prefix_cache_hits, server.admissions) != (1, 1) or not (exact and private and same_pages):
        fail(f"whole-prompt hit: hits {server.prefix_cache_hits}, prefills {server.admissions}, exact {exact}, "
             f"private tail {private}, pages unchanged {same_pages}")
    check_pages("whole hit", server, finished, 2)
    return result


def serve_cli_run(name: str, extra: dict, profile_dir: Path | None) -> dict:
    """One ``scripts.serve`` run in-process on SERVE_CLI with ``extra``,
    checked by ``check_cli_run``; with ``profile_dir`` traced whole (device
    activity only): its device time by part and the serving loop's idle share."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.scripts import serve

    args = serve.ServeArgs(**dict(SERVE_CLI, **extra))
    tracer = contextlib.nullcontext() if profile_dir is None else profile(activities=[ProfilerActivity.CUDA])
    reset_launch_counts()
    t0 = time.perf_counter()
    with tracer:
        summary = serve.main(args)
        torch.cuda.synchronize()
    counts = launch_counts()
    summary.update(run_s=time.perf_counter() - t0, launches=counts)
    if profile_dir is not None:
        (profile_dir / f"serve_cli_{name}.txt").write_text(
            tracer.key_averages().table(sort_by="self_cuda_time_total", row_limit=30))
        parts = step_parts(tracer, 1)
        busy = sum(parts.values())
        loop_ms = summary["total_new_tokens"] / summary["tokens_per_sec"] * 1e3
        summary.update(device_ms_by_part={k: round(v, 2) for k, v in parts.items()}, device_busy_ms=busy,
                       device_idle_share=1.0 - busy / loop_ms)
    log(f"  {name}: launches {counts}")
    check_cli_run(name, args, summary, counts)
    torch.cuda.empty_cache()
    return summary


def phase_serve_cli(model, profile_dir: Path | None = None) -> dict:
    """The serving-CLI runs, generate and the prefix paths. With
    ``profile_dir`` each CLI run is traced whole (device activity only; the
    trace holds the server's build too): its device time by part
    (STEP_PARTS) and the idle share of its serving loop."""
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.scripts import generate

    log("[7/14] serving CLI: python -m vla_fastvlm_tpu_torch.scripts.serve in-process, FastVLM-0.5B, 1024 px, bf16: "
        "paged, prefix cache, chunked admission, both over int8 pools, speculative paged; then generate, and "
        "the prefix paths against whole-prompt prefills")
    summaries = {name: serve_cli_run(name, extra, profile_dir) for name, extra in SERVE_CLI_RUNS}
    reset_launch_counts()
    t0 = time.perf_counter()
    text = generate.main(generate.GenerateArgs(model_id="fastvlm-0.5b", bootstrap_model_id="fastvlm-0.5b",
                                               dtype="bfloat16", seed=SEED))
    torch.cuda.synchronize()
    counts = launch_counts()
    expect = {"flash_attention": 0, "repmixer_block": 38, "paged_attention": 0, "paged_attention_window": 0}
    if not isinstance(text, str) or counts != expect:
        fail(f"generate: {type(text).__name__}, launch counts {counts} != {expect}")
    summaries["generate"] = dict(seconds=time.perf_counter() - t0, characters=len(text), launches=counts)
    log(f"  generate: {json.dumps(summaries['generate'])}")
    torch.cuda.empty_cache()
    summaries["prefix_paths"] = check_prefix_paths(model)
    return summaries


def log_serve_cli_summaries(summaries: dict) -> None:
    for name, s in summaries.items():
        if "ticks" not in s:
            continue
        cache = "" if "prefix_cache_hits" not in s else (
            f", hits / partial / misses {s['prefix_cache_hits']} / {s['prefix_cache_partial_hits']} / "
            f"{s['prefix_cache_misses']}")
        idle = "" if "device_idle_share" not in s else (
            f", device {s['device_busy_ms']:.1f} ms ({json.dumps(s['device_ms_by_part'])}), idle share "
            f"{s['device_idle_share']:.3f}")
        log(f"serve_cli {name}: tokens/s {s['tokens_per_sec']:.1f}, p50 tick {s['p50_tick_ms']:.2f} ms, max tick "
            f"{s['max_tick_ms']:.2f} ms, ticks {s['ticks']}; admission ticks {s['admission_ticks']} "
            f"({s['admission_ticks'] / s['ticks']:.1%}), p50 {s['p50_admission_tick_ms']:.2f} ms against "
            f"{s['p50_decode_tick_ms']:.2f} ms for decode ticks{cache}; submit p50 {s['p50_submit_ms']:.2f} ms "
            f"(max {s['max_submit_ms']:.2f}){idle}")


# Closed-loop control: FastVLA-0.5B at full width and depth, the preset's
# 1024 px, bf16, random weights from the seed, 64 DummyEnvs of
# vla_fastvlm_tpu_torch/scripts/eval_closed_loop.py with 256-px frames that
# the letterbox resizes on the card, state and action widths 14 (ALOHA's),
# the CLI's default task: BASELINE.md's closed-loop configuration ("64
# parallel envs") at the 0.5B model the port serves. Every run goes through
# BatchedEnvRunner over the CLI's build functions, LOOP_TICKS control ticks
# each (the speculative run, ~5 s a tick, SPEC_LOOP_TICKS). The first tick
# carries the cold first forward (and a staggered run's prologue), so the p50
# and its min and max are read over the ticks after it.
LOOP_TICKS, SPEC_LOOP_TICKS, LOOP_DEVICE = 8, 4, "cuda"
LOOP = dict(model_id="fastvlm-0.5b", num_envs=LOOP_ENVS, image_size=256, state_dim=14, action_dim=14,
            dtype="bfloat16", max_steps=LOOP_TICKS, seed=SEED)
LOOP_SERVE = dict(num_slots=64, prefill_batch=LOOP_GROUP, page_size=16)
LOOP_SPEC = dict(num_slots=16, prefill_batch=8, page_size=16, spec_k=4, draft_model_id="self",
                 max_steps=SPEC_LOOP_TICKS)
# (name, ClosedLoopArgs fields past LOOP), in the order they run.
LOOP_RUNS = [
    ("mlp", dict(action_head="mlp")),
    ("mlp_stagger4", dict(action_head="mlp", stagger=4)),
    ("token_batch", dict(action_head="token", serving="batch")),
    ("token_dense", dict(action_head="token", serving="dense", **LOOP_SERVE)),
    ("token_paged", dict(action_head="token", serving="paged", **LOOP_SERVE)),
    ("token_paged_int8", dict(action_head="token", serving="paged", kv_cache_quantization="int8", **LOOP_SERVE)),
    ("token_spec_paged", dict(action_head="token", serving="spec-paged", **LOOP_SPEC)),
]


def loop_expected_launches(args, bridge) -> dict:
    """The kernel launches a run must make: MLP forwards 24 flash + 38
    RepMixer (a staggered group dispatches once more after the last tick);
    token runs RepMixer in each tower pass (the prefills run no flash), the
    paged kernel 24 a decode tick, the window kernel 24 a round."""
    counts = dict(flash_attention=0, repmixer_block=0, paged_attention=0, paged_attention_window=0)
    if args.action_head == "mlp":
        forwards = args.max_steps if args.stagger == 1 else args.stagger * (args.max_steps + 1)
        counts.update(flash_attention=DECODER_LAYERS * forwards, repmixer_block=REPMIXER_A_FORWARD * forwards)
    elif bridge is None:
        counts.update(repmixer_block=REPMIXER_A_FORWARD * args.max_steps)
    else:
        server = bridge.server
        towers = 2 if hasattr(server, "draft") else 1  # the self-draft prefills its own tower
        counts.update(repmixer_block=towers * REPMIXER_A_FORWARD * server.admissions)
        if args.serving == "paged":
            counts.update(paged_attention=DECODER_LAYERS * server.ticks)
        elif args.serving == "spec-paged":
            counts.update(paged_attention_window=DECODER_LAYERS * server.spec_ticks)
    return counts


def event_ms(fn) -> float:
    """Time of ``fn()`` between CUDA events on a synchronized card."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def loop_run(name, args, policy, obs0, profile_dir: Path | None):
    """One closed-loop run through BatchedEnvRunner: every env one finite
    action a tick, the launch counts, token actions on the codebook's bin
    centers, pages back on the free list. Returns the summary, the first
    tick's actions and, for a token server, its first tick's tokens."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.scripts.eval_closed_loop import build_envs, summarize
    from vla_fastvlm_tpu_torch.serving import ActionQueuePolicy, BatchedEnvRunner, TokenPolicyServer

    dispatch_ms = []

    class TimedQueue(ActionQueuePolicy):
        def dispatch_chunk(self, batch):
            t0 = time.perf_counter()
            out = super().dispatch_chunk(batch)
            dispatch_ms.append((time.perf_counter() - t0) * 1e3)
            return out

    bridge = policy if isinstance(policy, TokenPolicyServer) else None
    runner = BatchedEnvRunner(build_envs(args), TimedQueue(policy, args.n_action_steps), task=args.task)
    ticks, actions, first_tokens = [], [], []

    def on_step(tick_actions, done):
        ticks.append(time.perf_counter())
        actions.append(np.array(tick_actions))
        if bridge is not None and not first_tokens:
            first_tokens.append(bridge.last_tokens.copy())

    reset_launch_counts()
    t0 = time.perf_counter()
    result = runner.run(max_steps=args.max_steps, on_step=on_step, stagger=args.stagger)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launch_counts()
    if len(actions) != args.max_steps or any(a.shape != (args.num_envs, args.action_dim) for a in actions):
        fail(f"loop {name}: {len(actions)} ticks of actions {sorted({a.shape for a in actions})}")
    if not all(np.isfinite(a).all() for a in actions) or (result["lengths"] != args.max_steps).any():
        fail(f"loop {name}: non-finite actions or episode lengths {sorted(set(result['lengths'].tolist()))}")
    if args.action_head == "token":
        tok = (bridge.policy if bridge else policy).tokenizer
        if any((tok.decode(tok.encode(a)) != a).any() for a in actions):
            fail(f"loop {name}: actions off the codebook's bin centers")
    expect = loop_expected_launches(args, bridge)
    if counts != expect:
        fail(f"loop {name}: launch counts {counts} != {expect}")
    if bridge is not None and hasattr(bridge.server, "pool"):
        pool = bridge.server.pool
        if pool.free_pages != pool.num_pages - 1 or pool.page_table.any():
            fail(f"loop {name}: {pool.free_pages} of {pool.num_pages - 1} pages back on the free list")

    # The CLI's summary, then the ticks after the first, the dispatches and the launches.
    summary = summarize(args, policy, result, ticks, t0, elapsed)
    deltas = np.diff([t0] + ticks) * 1e3
    warm = deltas[1:]
    summary.update(first_tick_ms=float(deltas[0]), warm_p50_tick_ms=float(np.median(warm)),
                   warm_min_tick_ms=float(warm.min()), warm_max_tick_ms=float(warm.max()),
                   actions_per_sec_at_warm_p50=args.num_envs / float(np.median(warm)) * 1e3,
                   dispatch_host_ms_p50=float(np.median(dispatch_ms)), launches=counts)
    if bridge is not None:
        server = bridge.server
        summary.update(admissions=server.admissions)
        if hasattr(server, "spec_ticks"):
            summary.update(tokens_per_slot_round=server.tokens_per_slot_round)
    # A dispatch's batch: the tick's, or a staggered group's.
    group = {k: v[: args.num_envs // args.stagger] for k, v in obs0.items()}
    one = lambda: ActionQueuePolicy.fetch_chunk(policy.forward(group["images"], group["states"], group["tasks"]))
    tick = lambda: [one() for _ in range(args.stagger)]
    # One more forward between CUDA events for the dispatch's host time to
    # stand against (a token server answers on the host: its dispatch is the
    # whole forward).
    summary.update(forward_batch=len(group["tasks"]), forward_event_ms=event_ms(one))
    if profile_dir is not None:
        # One control tick's device work (a staggered tick: every group's
        # forward), by part; idle = 1 - device time / p50 tick, as in §2.
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tick()
            torch.cuda.synchronize()
        avg = prof.key_averages()
        dev = device_ms(avg)
        (profile_dir / f"loop_{name}.txt").write_text(avg.table(sort_by="self_cuda_time_total", row_limit=30)
                                                     + "\n" + avg.table(sort_by="self_cpu_time_total", row_limit=30))
        summary.update(tick_device_ms=dev, device_idle_share=1.0 - dev / summary["warm_p50_tick_ms"],
                       tick_parts_ms={k: round(v, 2) for k, v in step_parts(prof, 1).items()})
    log(f"  {name}: {json.dumps(summary)}")
    return summary, actions[0], (first_tokens[0] if first_tokens else None)


def log_loop_summaries(summaries: dict) -> None:
    for name, summary in summaries.items():
        extra = "" if "server_programs_per_control_tick" not in summary else (
            f", server calls {summary['server_programs_per_control_tick']:.2f} and decode ticks "
            f"{summary['server_ticks_per_control_tick']:.2f} a control tick")
        log(f"loop {name}: actions/s {summary['actions_per_sec']:.1f} ({summary['actions_per_sec_at_warm_p50']:.1f} "
            f"at the p50 after the first tick), p50 control tick {summary['p50_control_latency_ms']:.2f} ms, "
            f"first {summary['first_tick_ms']:.2f} ms, then p50 {summary['warm_p50_tick_ms']:.2f} ms "
            f"[{summary['warm_min_tick_ms']:.2f}-{summary['warm_max_tick_ms']:.2f}], dispatch host "
            f"{summary['dispatch_host_ms_p50']:.2f} ms against a forward of {summary['forward_event_ms']:.2f} ms{extra}")


def phase_closed_loop(profile_dir: Path | None = None):
    import numpy as np
    import torch

    from vla_fastvlm_tpu_torch.fastvla import FastVLAPolicy
    from vla_fastvlm_tpu_torch.model.fastvlm_adapter import prepare_policy_images
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.scripts.eval_closed_loop import (
        ClosedLoopArgs, build_envs, build_policy, build_token_server,
    )
    from vla_fastvlm_tpu_torch.serving import ActionQueuePolicy, BatchedEnvRunner

    log(f"[8/14] closed loop: {LOOP['model_id']}, its preset's resolution, {LOOP['dtype']}, {LOOP['num_envs']} "
        f"DummyEnvs of {LOOP['image_size']}-px frames, state/action {LOOP['state_dim']}, {LOOP['max_steps']} "
        f"control ticks a run ({SPEC_LOOP_TICKS} speculative)")
    t0 = time.perf_counter()
    device = torch.device(LOOP_DEVICE)
    mlp_args = ClosedLoopArgs(**LOOP, action_head="mlp")
    token_args = ClosedLoopArgs(**LOOP, action_head="token")
    policies = {"mlp": build_policy(mlp_args, device), "token": build_policy(token_args, device)}
    int8 = build_policy(ClosedLoopArgs(**LOOP, action_head="token", kv_cache_quantization="int8"), device)
    int8.backbone.model.load_state_dict(policies["token"].backbone.model.state_dict())
    policies["token_int8"] = int8
    # The first tick's observations, as the runner collects them from fresh envs.
    envs = build_envs(mlp_args)
    obs0 = BatchedEnvRunner(envs, None, task=mlp_args.task)._collect_obs([env.reset() for env in envs])
    torch.cuda.synchronize()
    log(f"  policies and observations ready in {time.perf_counter() - t0:.1f} s")
    t_runs = time.perf_counter()

    summaries, first_actions, first_tokens = {}, {}, {}
    for name, fields in LOOP_RUNS:
        args = ClosedLoopArgs(**{**LOOP, **fields})
        key = "mlp" if args.action_head == "mlp" else ("token_int8" if args.kv_cache_quantization == "int8"
                                                      else "token")
        policy = policies[key]
        if args.serving != "batch":
            policy = build_token_server(args, policy)
        summaries[name], first_actions[name], first_tokens[name] = loop_run(name, args, policy, obs0, profile_dir)
        del policy
        torch.cuda.empty_cache()

    spec = summaries["token_spec_paged"]
    if not spec["tokens_per_slot_round"] >= SELF_DRAFT_MIN_TOKENS_PER_SLOT_ROUND:
        fail(f"loop self-draft: {spec['tokens_per_slot_round']:.3f} tokens per slot and round "
             f"< {SELF_DRAFT_MIN_TOKENS_PER_SLOT_ROUND}")
    a, b = first_actions["mlp_stagger4"], first_actions["mlp"]
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    log(f"  stagger=4 vs stagger=1 first-tick actions: rel_l2={rel:.3e} (limit {POLICY_REL_L2:g}; groups of "
        f"{LOOP['num_envs'] // 4} against {LOOP['num_envs']})")
    if not rel <= POLICY_REL_L2:
        fail(f"loop: staggered actions differ from serial, rel_l2={rel:.3e}")

    # The MLP tick's kernel path against its plain path, same weights, the
    # first tick's observations.
    mlp = policies["mlp"]
    plain = FastVLAPolicy(dataclasses.replace(mlp.config, attention_impl="xla", vision_block_impl="xla"), device=device)
    copy_weights(plain, mlp)
    reset_launch_counts()
    plain_actions = ActionQueuePolicy.fetch_chunk(plain.forward(obs0["images"], obs0["states"], obs0["tasks"]))
    if any(launch_counts().values()):
        fail(f"loop: the plain MLP path launched kernels: {launch_counts()}")
    b = first_actions["mlp"]
    rel = float(np.linalg.norm(plain_actions.reshape(b.shape) - b) / np.linalg.norm(plain_actions))
    log(f"  MLP kernel path vs plain path, first-tick actions: rel_l2={rel:.3e} (limit {POLICY_REL_L2:g})")
    if not rel <= POLICY_REL_L2:
        fail(f"loop: the MLP kernel path differs from the plain path, rel_l2={rel:.3e}")
    del plain, mlp

    # image_prep inside admission against the host letterbox, same observations.
    token = policies["token"]
    paged_args = ClosedLoopArgs(**LOOP, **dict(LOOP_RUNS)["token_paged"])
    host_bridge = build_token_server(paged_args, token)
    host_bridge.server.image_prep = None  # the bridge letterboxes the tick on the card, submits tower-size frames
    host_bridge.forward(obs0["images"], obs0["states"], obs0["tasks"])
    same = float((host_bridge.last_tokens == first_tokens["token_paged"]).mean())
    log(f"  paged server, image_prep in admission vs host letterbox: tokens equal in {same:.4f} of positions")
    if same != 1.0:
        fail("loop: image_prep inside admission changed the paged server's tokens")
    del host_bridge

    # Greedy agreement of the servers with the batched generation (printed):
    # the paged and window kernels and the plain dense decode sum in other
    # orders, so bf16 near-ties of random weights may flip.
    batch_tokens = token.tokens(obs0["images"], obs0["states"], obs0["tasks"]).cpu().numpy()
    for name in ("token_dense", "token_paged", "token_paged_int8", "token_spec_paged"):
        log(f"  first-tick tokens identical between {name} and token_batch: "
            f"{float((first_tokens[name] == batch_tokens).mean()):.4f}")
    diff = [r for r in range(len(batch_tokens)) if (first_tokens["token_paged"][r] != batch_tokens[r]).any()]
    if diff:
        server = build_token_server(paged_args, token).server
        ids, mask = token.prompt_arrays(token.processor.prepare_tasks([obs0["tasks"][r] for r in diff], len(diff)),
                                        obs0["states"][diff])
        images = prepare_policy_images(token.backbone.to_device(obs0["images"][diff]), token.backbone.model_config,
                                       token.backbone.config).float().cpu().numpy()
        for r in range(min(len(diff), server.num_slots)):
            server.submit(ids[r: r + 1], mask[r: r + 1], obs0["images"][diff][r: r + 1])
        server.step()
        kernel, gathered = server.tick_logits("kernel").float(), server.tick_logits("gathered").float()
        logit_err = float((kernel - gathered).abs().max())
        del server
        reqs = {r: (ids[i: i + 1], mask[i: i + 1], images[i: i + 1]) for i, r in enumerate(diff)}
        outs = lambda toks: {r: [int(t) for t in toks[r]] for r in diff}
        divergence_report(token.backbone.model, reqs, outs(first_tokens["token_paged"]), outs(batch_tokens),
                          logit_err, "token_paged")
    del policies, token, int8
    torch.cuda.empty_cache()
    log(f"  closed-loop runs and checks in {time.perf_counter() - t_runs:.1f} s")
    return summaries


# ---------------------------------------------------------------------------
# the reference's other policy surfaces

# configs/train_aloha.yaml's settings (TRAIN_* above): eval over 64 records in
# batches of 8; the LeRobot plugin 5 steps of 8; the config.json directory's
# forward 16 frames of 256 px at its tower's 1024 px (FLASH_LOOP's and
# REPMIXER_LOOP's batch-16 shapes).
SURFACE_EVAL_SAMPLES, SURFACE_PLUGIN_STEPS, SURFACE_DIR_FRAMES = 64, 5, 16
# FastVLM-0.5B's HF config.json (apple/FastVLM-0.5B, model_type llava_qwen2).
FASTVLM_05B_CONFIG = {
    "model_type": "llava_qwen2", "hidden_size": 896, "num_hidden_layers": 24, "num_attention_heads": 14,
    "num_key_value_heads": 2, "intermediate_size": 4864, "vocab_size": 151936, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-06, "tie_word_embeddings": True, "max_position_embeddings": 32768,
    "mm_vision_tower": "mobileclip_l_1024",
}


def surface_policy(kind: str, impl: str = "auto"):
    """FastVLA-0.5B with the MLP head ("mlp") or the legacy FastVLMPolicy
    ("legacy") at the yaml's settings, on the card."""
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy
    from vla_fastvlm_tpu_torch.model import FastVLMBackboneConfig, FastVLMPolicy, FastVLMPolicyConfig

    if kind == "mlp":
        return FastVLAPolicy(FastVLAConfig(
            vlm_model_name=TRAIN_MODEL, bootstrap_model_name=TRAIN_MODEL, image_size=TRAIN_IMAGE,
            tokenizer_max_length=TEXT_LEN, dtype="bfloat16", param_dtype="float32", attention_impl=impl,
            vision_block_impl=impl, seed=SEED), device=TRAIN_DEVICE)
    backbone = FastVLMBackboneConfig(
        model_id=TRAIN_MODEL, bootstrap_model_id=TRAIN_MODEL, force_image_size=TRAIN_IMAGE,
        tokenizer_max_length=TEXT_LEN, dtype="bfloat16", param_dtype="float32", attention_impl=impl,
        vision_block_impl=impl, seed=SEED + 1)  # other weights than the MLP policy's
    return FastVLMPolicy(FastVLMPolicyConfig(backbone=backbone), device=TRAIN_DEVICE)


def surface_modules(policy):
    """(backbone, head) of a FastVLA or a legacy policy."""
    return (policy.model.backbone, policy.model.head) if hasattr(policy, "model") else (policy.backbone, policy.head)


def check_surface_launches(what: str, counts: dict, forwards: int) -> None:
    expect = {"flash_attention": FLASH_A_FORWARD * forwards, "repmixer_block": REPMIXER_A_FORWARD * forwards,
              "paged_attention": 0, "paged_attention_window": 0}
    log(f"  {what}: launches {counts} (expected {expect})")
    if counts != expect:
        fail(f"{what}: launch counts {counts} != {expect}")


def surface_checkpoint(kind: str, records, out: Path) -> dict:
    """Save, reload, eval_dataset and the plain path for one policy family."""
    import contextlib
    import io

    import torch

    import vla_fastvlm_tpu_torch as port
    from vla_fastvlm_tpu_torch.data import AlohaDataset, create_aloha_dataloader
    from vla_fastvlm_tpu_torch.io.checkpoint import save_policy_checkpoint
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.scripts import eval_dataset

    result = {}
    policy = surface_policy(kind)
    ckpt = out / kind
    t0 = time.perf_counter()
    save_policy_checkpoint(ckpt, policy.config, policy.jax_params(as_numpy=False))
    loaded, device = port.load_policy_from_checkpoint(ckpt, device=TRAIN_DEVICE)
    result["save_and_load_s"] = time.perf_counter() - t0
    if type(loaded) is not type(policy) or device != torch.device(TRAIN_DEVICE):
        fail(f"{kind}: the checkpoint loaded as {type(loaded).__name__} on {device}")
    batch8 = aloha_batch(records[:TRAIN_BATCH])
    obs = (batch8["images"], batch8["states"], batch8["tasks"])
    reset_launch_counts()
    actions = loaded.forward(*obs)
    torch.cuda.synchronize()
    check_surface_launches(f"{kind}: reloaded policy, one forward", launch_counts(), 1)
    same = torch.equal(policy.forward(*obs), actions)
    log(f"  {kind}: {type(loaded).__name__} saved and reloaded through vla_fastvlm_tpu_torch."
        f"load_policy_from_checkpoint in {result['save_and_load_s']:.1f} s; actions bit-equal {same}")
    if not same or tuple(actions.shape) != (TRAIN_BATCH, 14) or not bool(torch.isfinite(actions).all()):
        fail(f"{kind}: the reloaded checkpoint's actions differ from the saving policy's (or are not finite)")
    del policy

    # The CLI in-process on the checkpoint; its printed lines echoed.
    args = eval_dataset.EvalArgs(checkpoint_dir=str(ckpt), synthetic_data=True, synthetic_samples=SURFACE_EVAL_SAMPLES,
                                 synthetic_image_size=TRAIN_FRAME_HW[0], batch_size=TRAIN_BATCH, num_workers=2,
                                 seed=SEED, device=TRAIN_DEVICE)
    printed = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        summary = eval_dataset.main(args)
    torch.cuda.synchronize()
    result["eval_cli_s"] = time.perf_counter() - t0
    for line in printed.getvalue().splitlines():
        log(f"  eval_dataset: {line}")
    batches = SURFACE_EVAL_SAMPLES // TRAIN_BATCH
    check_surface_launches(f"{kind}: eval_dataset, {batches} batches", launch_counts(), batches)

    # The same batches through compute_loss, kernel path and plain path.
    plain = surface_policy(kind, "xla")
    (plain_backbone, plain_head), (backbone, head) = surface_modules(plain), surface_modules(loaded)
    plain_backbone.model.load_state_dict(backbone.model.state_dict())
    plain_head.load_state_dict(head.state_dict())
    eval_records = eval_dataset._build_dataset(args)[0]
    loader = create_aloha_dataloader(eval_records, batch_size=TRAIN_BATCH, shuffle=False, num_workers=2)
    host_batches = list(loader)
    means = {}
    for name, pol in (("kernel", loaded), ("plain", plain)):
        pol.compute_loss(port.move_batch_to_device(host_batches[0], device))  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = 0.0
        for b in host_batches:
            total += float(pol.compute_loss(port.move_batch_to_device(b, device))["mse"]) * len(b["tasks"])
        torch.cuda.synchronize()
        means[name] = total / SURFACE_EVAL_SAMPLES
        result[f"{name}_eval_samples_per_s"] = SURFACE_EVAL_SAMPLES / (time.perf_counter() - t0)
    line = f"MSE on split 'synthetic(train-records)': {means['kernel']:.6f}"
    log(f"  {kind}: mean of compute_loss over the same {batches} batches {means['kernel']:.6f} (the CLI: "
        f"{summary['mse']:.6f}); eval samples/s {result['kernel_eval_samples_per_s']:.1f} kernel path, "
        f"{result['plain_eval_samples_per_s']:.1f} plain (host clock around the synchronized loop, batches on the "
        f"host); the CLI call {result['eval_cli_s']:.1f} s with its checkpoint load")
    if line not in printed.getvalue().splitlines() or summary["samples"] != SURFACE_EVAL_SAMPLES:
        fail(f"{kind}: eval_dataset printed {printed.getvalue()!r}, the mean of compute_loss gives {line!r}")
    obs_plain = plain.forward(*obs)
    errs = {"eval mse": rel_l2(torch.tensor(means["kernel"]), torch.tensor(means["plain"])),
            "actions": rel_l2(actions, obs_plain)}
    log(f"  {kind}: kernel vs plain path: eval mse {means['kernel']:.6f} vs {means['plain']:.6f} rel "
        f"{errs['eval mse']:.3e}, actions rel_l2 {errs['actions']:.3e} (limit {POLICY_REL_L2:g})")
    if not all(e <= POLICY_REL_L2 for e in errs.values()):
        fail(f"{kind}: the kernel path differs from the plain path: {errs}")
    result.update(eval_mse=means["kernel"], plain_eval_mse=means["plain"], rel=errs)
    return result


def surface_plugin(records) -> dict:
    """The LeRobot plugin: 5 LeRobot-style train steps and select_action."""
    import dataclasses

    import numpy as np
    import torch

    from vla_fastvlm_tpu_torch.fastvla import FastVLMWithExpert
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    sys.path.insert(0, str(ROOT / "tests" / "lerobot_stub"))  # the card's machine has no lerobot
    from lerobot.configs.types import FeatureType, PolicyFeature

    import vla_fastvlm_tpu_torch.lerobot_fastvla as plugin

    h, w = TRAIN_FRAME_HW
    config = plugin.FastVLAConfig(
        input_features={"observation.state": PolicyFeature(FeatureType.STATE, (14,)),
                        "observation.images.top": PolicyFeature(FeatureType.VISUAL, (3, h, w))},
        output_features={"action": PolicyFeature(FeatureType.ACTION, (14,))},
        vlm_model_name=TRAIN_MODEL, bootstrap_model_name=TRAIN_MODEL, device=TRAIN_DEVICE, jax_dtype="bfloat16",
        image_size=TRAIN_IMAGE,
    )
    policy = plugin.FastVLAPolicy(config)
    states = np.stack([r["observation.state"] for r in records])
    actions = np.stack([r["action"] for r in records])
    cuda = lambda x: torch.from_numpy(x).to(TRAIN_DEVICE)
    stats = {"observation.state": {"mean": cuda(states.mean(0)), "std": cuda(states.std(0))},
             "action": {"mean": cuda(actions.mean(0)), "std": cuda(actions.std(0))}}
    pre, post = plugin.make_fastvla_pre_post_processors(config, stats)

    def lerobot_batch(i):
        b = aloha_batch(records[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
        return pre({"observation.images.top": torch.from_numpy(b["images"]),
                    "observation.state": torch.from_numpy(b["states"]), "action": torch.from_numpy(b["actions"]),
                    "task": b["tasks"]})

    batches = [lerobot_batch(i) for i in range(SURFACE_PLUGIN_STEPS)]
    optim_params = list(policy.get_optim_params())
    if {id(p) for p in optim_params} != {id(p) for p in policy.head.parameters()} or \
            any(p.requires_grad for p in policy.vlm.parameters()):
        fail("plugin: get_optim_params() is not the head's parameters alone, or the backbone takes gradients")
    preset = config.get_optimizer_preset()
    opt = torch.optim.AdamW(optim_params, lr=preset.lr, betas=preset.betas, eps=preset.eps,
                            weight_decay=preset.weight_decay)
    frozen = {k: v.clone() for k, v in policy.vlm.state_dict().items()}
    head0 = {k: v.clone() for k, v in policy.head.state_dict().items()}

    # The first step's loss on the plain path, same weights, before any update.
    core = policy.model.config
    plain = FastVLMWithExpert(dataclasses.replace(core, attention_impl="xla", vision_block_impl="xla"),
                              device=TRAIN_DEVICE)
    plain.backbone.model.load_state_dict(policy.vlm.state_dict())
    plain.head.load_state_dict(policy.head.state_dict())
    arrays = policy._arrays_from_batch(batches[0], with_actions=True)
    preds = plain.apply_fn(arrays["images"], arrays["input_ids"], arrays["attention_mask"], arrays["states"])
    plain_loss = torch.mean(torch.square(preds - arrays["actions"].to(preds.dtype))).float()
    del plain, preds

    losses, norms, step_ms = [], [], []
    policy.train()
    reset_launch_counts()
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, metrics = policy.forward(batch)
        opt.zero_grad()
        loss.backward()
        norm = torch.nn.utils.clip_grad_norm_(optim_params, preset.grad_clip_norm)
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
        norms.append(float(norm))
    check_surface_launches(f"plugin: {SURFACE_PLUGIN_STEPS} train steps", launch_counts(), SURFACE_PLUGIN_STEPS)
    moved = sum(not torch.equal(v, head0[k]) for k, v in policy.head.state_dict().items())
    still = all(torch.equal(v, frozen[k]) for k, v in policy.vlm.state_dict().items())
    first = rel_l2(torch.tensor(losses[0]), plain_loss.cpu())
    log(f"  plugin: losses {[round(x, 5) for x in losses]}, gradient norms {[round(x, 4) for x in norms]} "
        f"(clipped at {preset.grad_clip_norm}); {moved} of {len(head0)} head tensors moved; backbone "
        f"bit-equal {still}; first loss {losses[0]:.5f} vs plain path {float(plain_loss):.5f}, rel {first:.3e} "
        f"(limit {POLICY_REL_L2:g})")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)) or moved != len(head0) or not still \
            or not first <= POLICY_REL_L2:
        fail("plugin: a loss or norm is not finite, the head did not move, the backbone changed, or the first "
             "loss is off the plain path")

    policy.reset()
    sel_ms, actions = [], None
    reset_launch_counts()
    for batch in batches:
        policy.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        actions = policy.select_action(batch)
        torch.cuda.synchronize()
        sel_ms.append((time.perf_counter() - t0) * 1e3)
        if len(policy._action_queue) != 0:
            fail(f"plugin: select_action left {len(policy._action_queue)} actions queued at chunk 1")
    check_surface_launches(f"plugin: {len(batches)} select_action calls", launch_counts(), len(batches))
    chunk = policy.predict_action_chunk(batches[-1])
    out = post(actions)
    if not torch.equal(actions, chunk[:, 0]) or tuple(out.shape) != (TRAIN_BATCH, 14) or out.device.type != "cpu" \
            or not bool(torch.isfinite(out).all()):
        fail(f"plugin: select_action {tuple(actions.shape)} is not the chunk's first step, or the "
             f"post-processor gave {tuple(out.shape)} on {out.device}")
    result = dict(losses=losses, grad_norms=norms, first_loss_rel=first,
                  p50_train_step_ms=statistics.median(step_ms), train_step_ms=step_ms,
                  p50_select_action_ms=statistics.median(sel_ms), select_action_ms=sel_ms)
    log(f"  plugin: p50 train step {result['p50_train_step_ms']:.2f} ms (forward, backward, clip, AdamW; steps "
        f"{[round(x, 2) for x in step_ms]}), p50 select_action {result['p50_select_action_ms']:.2f} ms "
        f"({[round(x, 2) for x in sel_ms]}); host clock around synchronized calls, batch {TRAIN_BATCH}")
    return result


def surface_hf_directory() -> dict:
    """A FastVLM-0.5B config.json directory: its config, its warning, a forward."""
    import tempfile

    import numpy as np
    import torch

    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy
    from vla_fastvlm_tpu_torch.io.presets import resolve_fastvlm_config
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        (Path(tmp) / "config.json").write_text(json.dumps(FASTVLM_05B_CONFIG))
        cfg, raw = resolve_fastvlm_config(tmp, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
        preset, _ = resolve_fastvlm_config(TRAIN_MODEL, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
        if cfg != preset or raw["model_type"] != "llava_qwen2":
            fail(f"config.json directory resolved to {cfg}, not the preset's {preset}")
        with WarningRecords() as records:
            policy = FastVLAPolicy(FastVLAConfig(vlm_model_name=tmp, bootstrap_model_name=TRAIN_MODEL,
                                                 tokenizer_max_length=TEXT_LEN, dtype="bfloat16",
                                                 param_dtype="bfloat16", seed=SEED), device=TRAIN_DEVICE)
    warned = [m for m in records.messages if "No *.safetensors found" in m and "randomly initialized" in m]
    mcfg = policy.model.backbone.model_config
    log(f"  config.json directory (llava_qwen2, mobileclip_l_1024): the preset's config, image size "
        f"{mcfg.image_size}; warning: {warned[:1]}")
    if not warned or mcfg.image_size != preset.image_size or mcfg.text != preset.text:
        fail(f"config.json directory: warning {records.messages}, image size {mcfg.image_size}")
    rng = np.random.default_rng(SEED)
    frames = rng.random((SURFACE_DIR_FRAMES, 3, 256, 256), dtype=np.float32)
    states = rng.standard_normal((SURFACE_DIR_FRAMES, 14)).astype(np.float32)
    reset_launch_counts()
    actions = policy.forward(frames, states, "insert the peg")
    torch.cuda.synchronize()
    check_surface_launches(f"config.json directory: one forward of {SURFACE_DIR_FRAMES} frames", launch_counts(), 1)
    if tuple(actions.shape) != (SURFACE_DIR_FRAMES, 14) or not bool(torch.isfinite(actions).all()):
        fail(f"config.json directory: actions {tuple(actions.shape)} not finite or misshapen")
    return {"image_size": mcfg.image_size, "warned": True}


def phase_surfaces() -> dict:
    import shutil

    import torch

    from vla_fastvlm_tpu_torch.data import SyntheticAlohaSource

    log(f"[9/14] surfaces: FastVLA-0.5B at configs/train_aloha.yaml's settings (batch {TRAIN_BATCH}, {TRAIN_IMAGE} px "
        f"from {TRAIN_FRAME_HW[0]}x{TRAIN_FRAME_HW[1]} frames, bf16 over fp32 parameters): checkpoints, "
        "eval_dataset, the legacy FastVLMPolicy, the LeRobot plugin, a config.json directory")
    out = ROOT / "build" / "surfaces_smoke"
    shutil.rmtree(out, ignore_errors=True)
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    records = SyntheticAlohaSource(num_samples=SURFACE_PLUGIN_STEPS * TRAIN_BATCH, image_hw=TRAIN_FRAME_HW, seed=SEED)
    result = {}
    try:
        for kind in ("mlp", "legacy"):
            result[kind] = surface_checkpoint(kind, records, out)
            torch.cuda.empty_cache()
            lap(kind)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    result["plugin"] = surface_plugin(records)
    torch.cuda.empty_cache()
    lap("plugin")
    result["hf_directory"] = surface_hf_directory()
    lap("config.json directory")
    result["card"] = card_line()
    log(f"  seconds by part: {laps}; card: {result['card']}")
    log(json.dumps({"surfaces": result}))
    return result


# LoRA (phase 10): rank-16 adapters on the decoder's seven projections over a
# frozen base (vla_fastvlm_tpu_torch/io/lora.py). (a) FastVLA-0.5B at
# configs/train_aloha.yaml's settings through ``python -m
# vla_fastvlm_tpu_torch.scripts.train --lora-rank 16``, MLP and token heads,
# LORA_STEPS steps saving at the last; (b) FastVLA-7B, bf16 base and fp32
# adapters, LORA_7B_STEPS steps through Trainer; (c) multi-LoRA serving through
# the serve CLI's ``--lora-dir`` on phase 7's stream (FastVLM-0.5B, 1024 px);
# (d) the speculative-paged server with target adapters at phase 6's
# self-draft shape; (e) ``python -m vla_fastvlm_tpu_torch.scripts.merge_lora``
# on (a)'s MLP checkpoint.
LORA_RANK, LORA_STEPS, LORA_7B_STEPS = 16, 10, 3
# LoRA train steps timed a path and turn (kernel, plain, plain, kernel).
LORA_TIMED_STEPS = 8
# The two seeded adapters of (c) and (d): B ~ N(0, 0.02^2), a delta of about
# 8% of each projection's output at rank 16 (h = x A has unit variance).
LORA_B_STD = 0.02
# The merged policy's actions against the adapted policy's: in fp32 the fold
# W + A B against x A B added at run time (summation order only); in bf16
# (the policy's limit) for an adapter whose delta bf16 can hold in W.
LORA_MERGE_REL_L2, LORA_MERGE_FP32_REL_L2 = POLICY_REL_L2, 1e-4


def lora_policy(head="mlp", impl="auto", image=TRAIN_IMAGE, dtype="bfloat16", model=TRAIN_MODEL,
                param_dtype="float32", quantization="none"):
    """FastVLA with LoRA adapters of rank LORA_RANK at the yaml's settings, on the card
    (over a base quantized with ``quantization``: QLoRA)."""
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy, FastVLMTokenPolicy

    cfg = FastVLAConfig(
        vlm_model_name=model, bootstrap_model_name=model, image_size=image, tokenizer_max_length=TEXT_LEN,
        dtype=dtype, param_dtype=param_dtype, dropout=TRAIN_DROPOUT, attention_impl=impl, vision_block_impl=impl,
        hidden_dim=1024, fusion_dim=1024, lora_rank=LORA_RANK, action_head=head, state_dim=ALOHA_DIM,
        action_dim=ALOHA_DIM, quantization=quantization, seed=SEED)
    return (FastVLMTokenPolicy if head == "token" else FastVLAPolicy)(cfg, device=TRAIN_DEVICE)


def lora_owner(policy):
    """The object holding ``backbone`` and ``lora`` (and the MLP ``head``)."""
    return policy.model if hasattr(policy, "model") else policy


def copy_lora_weights(dst, src) -> None:
    import torch

    d, s = lora_owner(dst), lora_owner(src)
    d.backbone.model.load_state_dict(s.backbone.model.state_dict())
    if hasattr(d, "head"):
        d.head.load_state_dict(s.head.state_dict())
    with torch.no_grad():
        for name, p in dst.params["lora"].items():
            p.copy_(src.params["lora"][name])


def seeded_b(policy_or_tree, seed: int):
    """Set every B of a policy's adapters (or of an adapter tree) to N(0, LORA_B_STD^2) from ``seed``."""
    import torch

    from vla_fastvlm_tpu_torch.io.bridge import flatten_params

    flat = policy_or_tree.params["lora"] if hasattr(policy_or_tree, "params") else flatten_params(policy_or_tree)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name in sorted(flat):
            if name.endswith(".b"):
                p = flat[name]
                p.copy_(torch.randn(p.shape, generator=gen) * LORA_B_STD)
    return policy_or_tree


@contextlib.contextmanager
def count_backwards():
    """Counts the backward calls of the kernels' autograd Functions while
    inside (they recompute through the plain versions, so no launch counter
    sees them)."""
    functions = {"flash_attention": importlib.import_module(
                     "vla_fastvlm_tpu_torch.ops.kernels.flash_attention")._FlashAttention,
                 "repmixer_block": importlib.import_module("vla_fastvlm_tpu_torch.ops.kernels.repmixer")._RepMixerBlock}
    counts = dict.fromkeys(functions, 0)
    originals = {name: fn.backward for name, fn in functions.items()}

    def counter(name):
        def counted(ctx, *grads):
            counts[name] += 1
            return originals[name](ctx, *grads)
        return staticmethod(counted)

    for name, fn in functions.items():
        fn.backward = counter(name)
    try:
        yield counts
    finally:
        for name, fn in functions.items():
            fn.backward = staticmethod(originals[name])


def check_lora_launches(what: str, counts: dict, backwards: dict, steps: int, layers: int = DECODER_LAYERS) -> None:
    """A LoRA train step: the decoder's forward and its remat recompute
    launch flash (2 x layers), its backward recomputes through the plain
    version (layers calls), the tower runs forward only (38 RepMixer, no
    backward: nothing in it requires a gradient)."""
    expect = {"flash_attention": 2 * layers * steps, "repmixer_block": REPMIXER_A_FORWARD * steps,
              "paged_attention": 0, "paged_attention_window": 0}
    expect_bw = {"flash_attention": layers * steps, "repmixer_block": 0}
    log(f"  {what}: launches {counts}, kernel backward calls {backwards} (expected {expect}, {expect_bw})")
    if counts != expect or backwards != expect_bw:
        fail(f"{what}: launches {counts} / backward calls {backwards} != {expect} / {expect_bw}")


def lora_train_cli(head: str, out: Path, extra: tuple = ()) -> dict:
    """``python -m vla_fastvlm_tpu_torch.scripts.train --lora-rank 16`` in-process
    at the yaml's settings (their values as flags: the card's machine may
    lack ``yaml``) on synthetic records, LORA_STEPS steps saving at the last;
    ``extra``: more flags (``--quantization int8``: QLoRA)."""
    import torch

    from vla_fastvlm_tpu_torch.io.lora import load_lora, lora_num_params
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.scripts import train as train_cli
    from vla_fastvlm_tpu_torch.utils import parse_cli

    flags = ["--synthetic-data", "--synthetic-samples", str(LORA_STEPS * TRAIN_BATCH), "--synthetic-image-size",
             str(TRAIN_FRAME_HW[0]), "--model-id", TRAIN_MODEL, "--bootstrap-model-id", TRAIN_MODEL,
             "--batch-size", str(TRAIN_BATCH), "--image-size", str(TRAIN_IMAGE), "--dtype", "bfloat16",
             "--hidden-dim", "1024", "--fusion-dim", "1024", "--dropout", str(TRAIN_DROPOUT),
             "--tokenizer-max-length", str(TEXT_LEN), "--learning-rate", str(TRAIN_LR), "--weight-decay",
             str(TRAIN_WD), "--max-steps", str(LORA_STEPS), "--save-steps", str(LORA_STEPS), "--logging-steps", "1",
             "--eval-split", "none", "--num-workers", "2", "--lora-rank", str(LORA_RANK), "--action-head", head,
             "--output-dir", str(out), "--device", TRAIN_DEVICE, "--seed", str(TRAIN_SEED), *extra]
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with count_backwards() as backwards:
        train_cli.main(parse_cli(train_cli.TrainArgs, flags))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_lora_launches(f"{head} head: scripts.train --lora-rank {LORA_RANK} {' '.join(extra)}, {LORA_STEPS} steps",
                        launch_counts(), dict(backwards), LORA_STEPS)
    lines = read_metrics(out)
    ckpt = out / "checkpoints" / f"step-{LORA_STEPS}"
    if [ln["step"] for ln in lines] != list(range(1, LORA_STEPS + 1)) or not ckpt.is_dir():
        fail(f"{head} head LoRA training: logged steps {[ln['step'] for ln in lines]}, checkpoint {ckpt.is_dir()}")
    adapters = lora_num_params(load_lora(ckpt))
    log(f"  {head} head: loss {lines[0]['train/loss']:.4f} -> {lines[-1]['train/loss']:.4f}, grad norm "
        f"{lines[-1]['train/grad_norm']:.4f}; {adapters / 1e6:.2f} M adapter parameters; {seconds:.1f} s with the "
        f"build; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(first_loss=lines[0]["train/loss"], last_loss=lines[-1]["train/loss"], adapter_params=adapters,
                seconds=seconds, checkpoint=str(ckpt))


def lora_train_checks(head: str, ckpt: Path, records, profile_dir: Path | None) -> dict:
    """One head's LoRA step: the first updates on fresh adapters, the kernel
    path against the plain path (bf16 at the yaml's batch, fp32 at batch 2 /
    256 px), launches a step, peak memory, and the p50 step of both paths."""
    import torch

    from vla_fastvlm_tpu_torch.io.checkpoint import load_policy_from_checkpoint
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.training import Trainer

    result = {}
    batch8 = aloha_batch(records[:TRAIN_BATCH])

    # Fresh adapters (B = 0): step 1 moves B; A, whose gradient is zero while
    # B is, moves at step 2; the base stays bit-equal.
    fresh = lora_policy(head)
    arrays8 = fresh.to_device(fresh.prepare_batch(batch8))
    lora = fresh.params["lora"]
    a0 = {n: p.detach().clone() for n, p in lora.items() if n.endswith(".a")}
    base0 = {n: p.detach().clone() for n, p in fresh.params["backbone"].items()}
    # No warmup (the first update at the full rate) and no weight decay.
    trainer = Trainer(fresh, [], None, train_config(ROOT / "build", max_steps=LORA_STEPS, warmup_ratio=0.0,
                                                    weight_decay=0.0))
    trainer._train_step(arrays8)
    b_zero = [n for n, p in lora.items() if n.endswith(".b") and not bool(p.any())]
    a_moved1 = sum(not torch.equal(p, a0[n]) for n, p in lora.items() if n in a0)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with count_backwards() as backwards:
        trainer._train_step(arrays8)
    torch.cuda.synchronize()
    result["step_peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    check_lora_launches(f"{head} head, one LoRA step", launch_counts(), dict(backwards), 1)
    a_moved2 = sum(not torch.equal(p, a0[n]) for n, p in lora.items() if n in a0)
    base_same = all(torch.equal(p, base0[n]) for n, p in fresh.params["backbone"].items())
    log(f"  {head} head, fresh adapters: after step 1 {len(b_zero)} of {len(a0)} B all zero, {a_moved1} A moved "
        f"(no weight decay: their gradient is zero while B is); after step 2 {a_moved2} of {len(a0)} A moved; "
        f"{len(base0)} base tensors bit-equal: {base_same}; a step's own peak {result['step_peak_gib']:.2f} GiB")
    if b_zero or a_moved1 or a_moved2 != len(a0) or not base_same:
        fail(f"{head} head fresh adapters: B zero {b_zero[:3]}, A moved {a_moved1} then {a_moved2}, base {base_same}")
    del trainer, fresh, base0
    torch.cuda.empty_cache()

    # The trained adapters of the CLI run: kernel path against plain path.
    loaded, _ = load_policy_from_checkpoint(ckpt, device=TRAIN_DEVICE)
    plain = lora_policy(head, "xla")
    copy_lora_weights(plain, loaded)
    arrays8 = loaded.to_device(loaded.prepare_batch(batch8))
    limits = {"loss": TRAIN_REL_L2, "grad_norm": TRAIN_REL_L2, "lora grads": TRAIN_REL_L2}
    if head == "mlp":
        limits["head grads"] = TRAIN_REL_L2
    result["bf16"] = compare_paths(f"{head} head, bf16 LoRA step", step_grads(loaded, arrays8),
                                   step_grads(plain, arrays8), limits)
    kf = seeded_b(lora_policy(head, image=TRAIN_FP32["image"], dtype="float32"), SEED + 3)
    pf = lora_policy(head, "xla", image=TRAIN_FP32["image"], dtype="float32")
    copy_lora_weights(pf, kf)
    arrays2 = kf.to_device(kf.prepare_batch(aloha_batch(records[:TRAIN_FP32["batch"]])))
    result["fp32"] = compare_paths(
        f"{head} head, fp32 LoRA step, batch {TRAIN_FP32['batch']}, {TRAIN_FP32['image']} px",
        step_grads(kf, arrays2), step_grads(pf, arrays2), {"loss": TRAIN_FP32_REL_L2, "leaf": TRAIN_FP32_REL_L2})
    del kf, pf
    torch.cuda.empty_cache()
    result["steps"] = time_train_steps(f"LoRA {head} head, batch {TRAIN_BATCH}, {TRAIN_IMAGE} px",
                                       step_trainers(loaded, plain), arrays8, TRAIN_BATCH, profile_dir,
                                       LORA_TIMED_STEPS)
    del loaded, plain
    torch.cuda.empty_cache()
    return result


def lora_train_7b(records, profile_dir: Path | None, quantization: str = "none") -> dict:
    """FastVLA-7B with rank-16 adapters: bf16 base (quantized with
    ``quantization``: QLoRA), fp32 adapters, the yaml's batch."""
    import math

    import torch

    from vla_fastvlm_tpu_torch.io.lora import lora_num_params
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.training import Trainer

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    policy = lora_policy(model="fastvlm-7b", param_dtype="bfloat16", quantization=quantization)
    lora = policy.params["lora"]
    adapters = lora_num_params(lora_owner(policy).lora)
    base = lora_owner(policy).backbone.model.state_dict()  # a quantized base's codes and scales too
    probe = {n: base[n].detach().clone() for n in list(base)[::40]}
    trainer = Trainer(policy, [], None, train_config(ROOT / "build", max_steps=LORA_7B_STEPS, warmup_ratio=0.0))
    arrays = policy.to_device(policy.prepare_batch(aloha_batch(records[:TRAIN_BATCH])))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    with count_backwards() as backwards:
        for _ in range(LORA_7B_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(trainer._train_step(arrays)["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    label = "FastVLA-7B LoRA" if quantization == "none" else f"FastVLA-7B QLoRA ({quantization} base)"
    check_lora_launches(f"{label}, {LORA_7B_STEPS} steps", launch_counts(), dict(backwards), LORA_7B_STEPS,
                        TARGET_LAYERS)
    b_any = all(bool(p.any()) for n, p in lora.items() if n.endswith(".b"))
    base_same = all(torch.equal(base[n], v) for n, v in probe.items())
    dtypes = sorted({str(p.dtype) for p in lora.values()}), sorted({str(p.dtype) for p in base.values()})
    result = dict(adapter_params=adapters, base_params=sum(p.numel() for p in base.values()), build_s=build_s,
                  p50_step_ms=statistics.median(times), step_ms=times, losses=losses, peak_gib=peak,
                  adapter_dtypes=dtypes[0], base_dtypes=dtypes[1])
    log(f"  {label}: {adapters / 1e6:.2f} M adapter parameters ({dtypes[0]}) over "
        f"{result['base_params'] / 1e9:.2f} B base ({dtypes[1]}); steps {[round(t, 1) for t in times]} ms "
        f"(p50 {result['p50_step_ms']:.1f}, the first includes warm-up), losses {[round(x, 4) for x in losses]}; "
        f"peak memory of the policy and its steps {peak:.2f} GiB; every B non-zero {b_any}, {len(probe)} sampled "
        f"base tensors bit-equal {base_same}; built in {build_s:.1f} s")
    if not (b_any and base_same) or not all(map(math.isfinite, losses)):
        fail(f"{label}: B non-zero {b_any}, base bit-equal {base_same}, losses {losses}")
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer._train_step(arrays)
            torch.cuda.synchronize()
        name = "train_lora_7b" if quantization == "none" else f"train_qlora_7b_{quantization}"
        (profile_dir / f"{name}_profile.txt").write_text(
            prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
        result["device_ms_by_part"] = step_parts(prof, 1)
        log(f"  {label} step device time by part: {json.dumps(result['device_ms_by_part'])}")
    del trainer, policy, probe
    torch.cuda.empty_cache()
    return result


def lora_adapter_dirs(trained: Path, out: Path) -> list:
    """(c)'s three adapter directories: the MLP head's trained checkpoint and
    two policy-checkpoint directories holding only a ``"lora"`` tree of the
    trained adapter's shapes with seeded B (A kept)."""
    from vla_fastvlm_tpu_torch.io.bridge import torch_lora_to_jax
    from vla_fastvlm_tpu_torch.io.checkpoint import save_policy_checkpoint
    from vla_fastvlm_tpu_torch.io.lora import load_lora

    dirs = [str(trained)]
    for i in (1, 2):
        tree = seeded_b(load_lora(trained), SEED + 10 + i)
        save_policy_checkpoint(out / f"adapter_{i}", {"lora_rank": LORA_RANK},
                               {"lora": torch_lora_to_jax(tree, as_numpy=False)})
        dirs.append(str(out / f"adapter_{i}"))
    return dirs


def tick_profile(server, ticks: int = 3) -> dict:
    """Device launches and device time a decode tick, and the host p50 tick,
    over ``ticks`` profiled ticks and 5 timed ones from the server's state."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            server.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        server.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(launches_per_tick=sum(e.count for e in kernels) / ticks,
                device_ms_per_tick=sum(e.self_device_time_total for e in kernels) / 1e3 / ticks,
                p50_tick_ms=statistics.median(times))


def lora_serving_checks(model, adapters: list) -> dict:
    """On the paged server of ``model`` at the SERVE shape: adapted tick
    logits kernel against gathered, launches and time a tick against no
    adapters, first-token logits of the multi-LoRA server against a
    single-adapter server per row, prefix-cache hits by adapter."""
    import numpy as np
    import torch

    from vla_fastvlm_tpu_torch.serving import PagedGenerationServer

    reqs = serve_stream()
    routes = [None if i % 4 == 0 else i % 4 - 1 for i in range(len(reqs))]
    result = {}

    def new(lora, **kw):
        return PagedGenerationServer(model, eos_token_id=-1, temperature=0.0, seed=SEED, decode_impl="kernel",
                                     lora=lora, **dict(SERVE, **kw))

    for name, lora in (("multi_lora", adapters), ("no_lora", None)):
        server = new(lora)
        for req, route in zip(reqs[: SERVE["num_slots"]], routes):
            server.submit(*req, **({} if lora is None else {"lora_index": route}))
        for _ in range(8):
            server.step()
        if lora is not None:
            kernel, gathered = server.tick_logits("kernel").float(), server.tick_logits("gathered").float()
            rel = float((kernel - gathered).norm() / gathered.norm())
            log(f"  multi-LoRA kernel vs gathered tick logits, 64 slots over base + 3 adapters: rel_l2={rel:.3e} "
                f"(limit {SERVE_LOGITS_REL_L2:g})")
            if not rel <= SERVE_LOGITS_REL_L2:
                fail(f"multi-LoRA kernel tick differs from the gathered tick: rel_l2={rel:.3e}")
            result["tick_logits_rel_l2"] = rel
        result[name] = tick_profile(server)
        log(f"  {name}, 64 active slots: {json.dumps(result[name])}")
        del server
        torch.cuda.empty_cache()

    # First-token logits (the prefix cache's entry for each prompt) of one
    # multi-LoRA server against a single-adapter server per adapter.
    few, few_routes = reqs[:8], [None, 0, 1, 2, 0, 1, 2, None]
    kw = dict(num_slots=8, prefill_batch=8, prefix_cache_size=8, max_new_tokens=4)
    multi = new(adapters, **kw)
    for req, route in zip(few, few_routes):
        multi.submit(*req, lora_index=route)
    multi.flush()
    errs = []
    for route, lora in [(None, None)] + list(enumerate(adapters)):
        single = new(lora, **kw)
        rows = [i for i, r in enumerate(few_routes) if r == route]
        for i in rows:
            single.submit(*few[i])
        single.flush()
        for i in rows:
            lidx = 0 if route is None else route + 1
            got = multi._prefix_cache[multi._prompt_hashes(*few[i], lidx)[0]]["logits"]
            ref = single._prefix_cache[single._prompt_hashes(*few[i])[0]]["logits"]
            errs.append(rel_rows(got[None], ref[None]))
        single.evict_prefix_cache()
        del single
    result["first_token_rel_l2"] = max(errs)
    log(f"  first-token logits, multi-LoRA server against a single-adapter server per row: worst rel_l2 "
        f"{max(errs):.3e} over {len(errs)} rows (limit {SERVE_LOGITS_REL_L2:g})")
    if not max(errs) <= SERVE_LOGITS_REL_L2:
        fail(f"multi-LoRA first-token logits differ from single-adapter ones: rel_l2={max(errs):.3e}")

    # The same prompt under adapter 0, adapter 1, adapter 0: miss, miss, hit.
    cache_server = new(adapters, **kw)
    for route in (0, 1, 0):
        cache_server.submit(*reqs[-1], lora_index=route)
        cache_server.flush()
    counts = (cache_server.prefix_cache_hits, cache_server.prefix_cache_partial_hits, cache_server.prefix_cache_misses)
    log(f"  one prompt under adapters 0, 1, 0: (hits, partial hits, misses) = {counts}")
    if counts != (1, 0, 2):
        fail(f"prefix cache by adapter: (hits, partial, misses) = {counts}, expected (1, 0, 2)")
    for server in (multi, cache_server):
        server.run_to_completion()
        server.evict_prefix_cache()
        if server.pool.free_pages != server.pool.num_pages - 1:
            fail(f"multi-LoRA server: {server.pool.free_pages} of {server.pool.num_pages - 1} pages back")
    return result


def lora_speculative(model, adapters: list, profile_dir: Path | None) -> dict:
    """The speculative-paged server, FastVLM-0.5B as its own draft at the
    SPEC shape, target adapters on base + 3 adapters round-robin."""
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.serving import SpeculativePagedGenerationServer

    def new():
        return SpeculativePagedGenerationServer(model, model, eos_token_id=-1, temperature=0.0, seed=SEED,
                                                decode_impl="kernel", lora=adapters, **SPEC)

    reqs = serve_stream()[:SELF_DRAFT_REQUESTS]
    routes = [None if i % 4 == 0 else i % 4 - 1 for i in range(len(reqs))]
    server = new()
    for req, route in zip(reqs, routes):
        server.submit(*req, lora_index=route)
    for _ in range(3):
        server.step()
    kernel, gathered = server.verify_logits("kernel").float(), server.verify_logits("gathered").float()
    rel = float((kernel - gathered).norm() / gathered.norm())
    log(f"  speculative paged with target adapters: kernel vs gathered verify logits rel_l2={rel:.3e} "
        f"(limit {SERVE_LOGITS_REL_L2:g})")
    if not rel <= SERVE_LOGITS_REL_L2:
        fail(f"adapted kernel verify differs from the gathered verify: rel_l2={rel:.3e}")
    del server
    torch.cuda.empty_cache()
    server = new()
    reset_launch_counts()
    finished, summary = run_stream(server, reqs, None if profile_dir is None else profile_dir / "spec_lora_rounds.txt",
                                   SPEC["num_slots"], SPEC_ARRIVALS, lora_routes=routes)
    counts = launch_counts()
    check_answers("spec-paged LoRA", server, finished, len(reqs), SPEC["max_new_tokens"])
    expect = {"flash_attention": 0, "repmixer_block": 2 * 38 * server.admissions, "paged_attention": 0,
              "paged_attention_window": DECODER_LAYERS * server.spec_ticks}
    log(f"  speculative paged with target adapters: {json.dumps(summary)}; launches {counts}")
    if counts != expect:
        fail(f"spec-paged LoRA: launch counts {counts} != {expect}")
    summary["verify_logits_rel_l2"] = rel
    return summary


def phase_lora(profile_dir: Path | None = None, base_cli: dict | None = None, self_draft: dict | None = None) -> dict:
    """Phase 10. ``base_cli``: phase 7's summaries of the same CLI runs
    without adapters (run here when not given); ``self_draft``: phase 6's
    self-draft run without adapters, for the acceptance."""
    import shutil

    import torch

    from vla_fastvlm_tpu_torch.data import SyntheticAlohaSource
    from vla_fastvlm_tpu_torch.io.checkpoint import save_policy_checkpoint
    from vla_fastvlm_tpu_torch.io.lora import load_lora
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.scripts import serve

    log(f"[10/14] LoRA: rank {LORA_RANK} on the decoder's 7 projections, frozen base: FastVLA-0.5B training at "
        f"configs/train_aloha.yaml's settings (MLP and token heads), FastVLA-7B training, multi-LoRA serving "
        f"(FastVLM-0.5B, 1024 px), speculative paged with target adapters, merge_lora")
    out = ROOT / "build" / "lora_smoke"
    shutil.rmtree(out, ignore_errors=True)
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    records = SyntheticAlohaSource(num_samples=TRAIN_BATCH, image_hw=TRAIN_FRAME_HW, seed=SEED)
    result = {}
    try:
        for head in ("mlp", "token"):
            result[f"{head}_cli"] = lora_train_cli(head, out / head)
            torch.cuda.empty_cache()
            lap(f"{head} cli")
            result[f"{head}_steps"] = lora_train_checks(head, Path(result[f"{head}_cli"]["checkpoint"]), records,
                                                        profile_dir)
            lap(f"{head} checks")
        result["7b"] = lora_train_7b(records, profile_dir)
        lap("7b")

        # (e) merge_lora on the MLP head's checkpoint, and on the same
        # checkpoint with seeded B (an adapter above bf16's resolution of W).
        ckpt = Path(result["mlp_cli"]["checkpoint"])
        batch8 = aloha_batch(records[:TRAIN_BATCH])
        obs = (batch8["images"], batch8["states"], batch8["tasks"])
        result["merge_trained"] = merge_check(ckpt, out / "merged", obs, "trained adapter", bf16_limit=None)
        seeded = seeded_b(policy_as(ckpt, "bfloat16"), SEED + 20)
        save_policy_checkpoint(out / "seeded", seeded.config, seeded.jax_params(as_numpy=False))
        del seeded
        result["merge_seeded"] = merge_check(out / "seeded", out / "merged_seeded", obs, "seeded adapter",
                                             bf16_limit=LORA_MERGE_REL_L2)
        torch.cuda.empty_cache()
        lap("merge")

        # (c) multi-LoRA serving, (d) speculative paged with target adapters.
        dirs = lora_adapter_dirs(ckpt, out)
        cli = {}
        runs = [("paged", {}), ("paged_prefix", dict(prefix_cache=16, repeat_fraction=0.5))]
        for name, extra in runs:
            for adapted_run in (True, False):
                if not adapted_run and base_cli is not None and name in base_cli:
                    cli[name] = base_cli[name]
                    continue
                args = serve.ServeArgs(**dict(SERVE_CLI, **extra, lora_dir=tuple(dirs) if adapted_run else ()))
                reset_launch_counts()
                summary = serve.main(args)
                torch.cuda.synchronize()
                counts = launch_counts()
                label = f"{name}_lora" if adapted_run else name
                check_cli_run(label, args, summary, counts)
                if adapted_run and summary.get("lora_adapters") != 3:
                    fail(f"serve_cli {label}: lora_adapters {summary.get('lora_adapters')}")
                summary["launches"] = counts
                cli[label] = summary
                torch.cuda.empty_cache()
        result["serve_cli"] = cli
        for name, _ in runs:
            a, b = cli[f"{name}_lora"], cli[name]
            log(f"  serve_cli {name} --lora-dir x3 against no adapters: tokens/s {a['tokens_per_sec']:.1f} vs "
                f"{b['tokens_per_sec']:.1f}, p50 tick {a['p50_tick_ms']:.2f} vs {b['p50_tick_ms']:.2f} ms, max tick "
                f"{a['max_tick_ms']:.2f} vs {b['max_tick_ms']:.2f} ms, p50 decode tick {a['p50_decode_tick_ms']:.2f} "
                f"vs {b['p50_decode_tick_ms']:.2f} ms, ticks {a['ticks']} vs {b['ticks']}"
                + ("" if "prefix_cache_hits" not in a else
                   f", hits / partial / misses {a['prefix_cache_hits']} / {a['prefix_cache_partial_hits']} / "
                   f"{a['prefix_cache_misses']} vs {b['prefix_cache_hits']} / {b['prefix_cache_partial_hits']} / "
                   f"{b['prefix_cache_misses']}"))
        lap("serve cli")
        model = serving_backbone().model
        adapters = [load_lora(d) for d in dirs]
        result["serving"] = lora_serving_checks(model, adapters)
        lap("serving checks")
        result["spec_paged"] = lora_speculative(model, adapters, profile_dir)
        base_tps = None if self_draft is None else self_draft["tokens_per_slot_round"]
        log(f"  speculative paged acceptance: {result['spec_paged']['tokens_per_slot_round']:.3f} tokens per slot and "
            f"round with target adapters on 3 of 4 rows (the draft is the base)"
            + ("" if base_tps is None else f", against {base_tps:.3f} for phase 6's self-draft without adapters"))
        del model
        torch.cuda.empty_cache()
        lap("speculative")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    result["card"] = card_line()
    log(f"  seconds by part: {laps}; card: {result['card']}")
    log(json.dumps({"lora": result}))
    return result


def policy_as(ckpt: Path, dtype: str):
    """A FastVLA MLP checkpoint's policy on the card, computing in ``dtype``
    (its parameters as the checkpoint holds them)."""
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy
    from vla_fastvlm_tpu_torch.io.checkpoint import load_policy_state

    config, params = load_policy_state(ckpt)
    known = {f.name for f in dataclasses.fields(FastVLAConfig)}
    policy = FastVLAPolicy(FastVLAConfig(**dict({k: v for k, v in config.items() if k in known}, dtype=dtype)),
                           device=TRAIN_DEVICE)
    policy.load_jax_params(params)
    return policy


def merge_check(ckpt: Path, out: Path, obs, label: str, bf16_limit) -> dict:
    """``python -m vla_fastvlm_tpu_torch.scripts.merge_lora`` on the card, then
    the merged policy's actions against the adapted policy's, and the base's
    (adapters unmounted) for scale, computing in fp32 and in bf16. In fp32
    the merged policy must be within LORA_MERGE_FP32_REL_L2 and closer than
    the base; in bf16 the same at ``bf16_limit`` where given (else printed). In bf16 the merged
    kernels are ``bf16(W + A B)``: a delta under half an ulp of W is rounded
    away where the adapted path adds ``x A B`` at the activations' scale."""
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.scripts import merge_lora

    summary = merge_lora.main(merge_lora.MergeArgs(checkpoint=str(ckpt), output=str(out)))
    result = dict(summary)
    for dtype in ("float32", "bfloat16"):
        adapted, merged = policy_as(ckpt, dtype), policy_as(out, dtype)
        if merged.config.lora_rank != 0 or merged.model.lora is not None:
            fail(f"merge_lora {label}: the merged checkpoint mounts adapters (lora_rank {merged.config.lora_rank})")
        reset_launch_counts()
        got, ref = merged.forward(*obs), adapted.forward(*obs)
        torch.cuda.synchronize()
        check_surface_launches(f"merge_lora {label}, {dtype}: merged and adapted forwards", launch_counts(), 2)
        adapted.model.lora = None
        base = adapted.forward(*obs)
        err, base_err = rel_l2(got, ref), rel_l2(base, ref)
        result[dtype] = dict(merged_vs_adapted=err, base_vs_adapted=base_err)
        limit = LORA_MERGE_FP32_REL_L2 if dtype == "float32" else bf16_limit
        log(f"  merge_lora {label}, {dtype}: merged against adapted actions rel_l2 {err:.3e} (limit "
            f"{'none' if limit is None else f'{limit:g}'}); the base is {base_err:.3e} away")
        if limit is not None and not (err <= limit and err < base_err):
            fail(f"merge_lora {label}, {dtype}: merged actions rel_l2 {err:.3e} (the base {base_err:.3e})")
        del adapted, merged
        torch.cuda.empty_cache()
    log(f"  merge_lora {label}: {json.dumps(summary)}")
    return result


# ---------------------------------------------------------------------------
# weight quantization

# One FastVLM-7B decoder layer's projections (out, in): the fused q/k/v
# (28 + 2 x 4 heads of 128), the fused gate/up, and down.
QUANT_OPS = [("qkv_proj", 4608, 3584), ("gate_up_proj", 2 * 18944, 3584), ("down_proj", 3584, 18944)]
# Tokens of a decode tick (16 slots) and of a prefill; w8a8 engages at 1024.
QUANT_DECODE_TOKENS, QUANT_PREFILL_TOKENS = 16, 2048
# A product against x @ dequant(W)^T in fp32 on the same bf16 inputs,
# relative L2: the weight-only paths round only in bf16 (the output, the
# scale, the scaled int4 weights; 2^-8 = 3.9e-3 per rounding); w8a8 also
# rounds each token's activations to 127 steps of its absmax, 0.9% of a
# unit-variance input at K = 3584 (absmax near 4 sigma, error of a step over
# sqrt(12)).
QUANT_OP_REL_L2 = {"int8": 1e-2, "int4": 1e-2, "w8a8": 3e-2}
# The quantized policy's actions against the float policy's, relative L2, on
# random weights. The init truncates at 2 std, so a row's (int8) or a
# 128-group's (int4) absmax is near 2.2 sigma: a rounding error of 0.52%
# rms of a weight for int8 and 8.7% for int4 (a step over sqrt(12)); w8a8
# adds about 1% on each projection's input. The 48 quantized sublayers
# carry it to the actions about 7-fold (measured on an H100: int8 3.97e-2,
# int4 0.554). Bounds at about twice that, under the sqrt(2) of unrelated
# actions; the products themselves are held against the dequantized
# reference above (QUANT_OP_REL_L2) and the kernel path against the plain path.
QUANT_ACTION_REL_L2 = {"int8": 1e-1, "w8a8": 2e-1, "int4": 1.0}
# w8a8's kernel path against its plain path: each projection rounds its
# input to 127 steps of the token's absmax, a step function, so any
# difference between the paths moves some codes by a step, and the moved
# codes move more in the next layers: over 48 quantized sublayers the gap
# grows to the scale of w8a8's own error against float (6.2e-2). Measured on
# an H100: 4.92e-2 in bf16, and 2.73e-2 in fp32, where the paths differ by
# 1e-6 per op. Held at 1e-1, about the sum of the two paths' distances to
# float; int8 and int4, continuous in their inputs, keep POLICY_REL_L2.
QUANT_W8A8_REL_L2 = 1e-1
# The serving CLI runs of the phase: SERVE_CLI's stream, whole-prompt admission.
QUANT_CLI_RUNS = [("paged_int8", dict(quantization="int8")), ("paged_int4", dict(quantization="int4")),
                  ("paged_int8_kv_int8", dict(quantization="int8", kv_cache_quantization="int8"))]
# FastVLM-7B's QLoRA steps against PR 12's bf16 base on the same card (16.89 GiB).
QLORA_BF16_PEAK_GIB = 16.89


def weight_bytes(module) -> int:
    """Bytes of a module's parameters and buffers (codes and scales of a quantized one)."""
    return sum(t.numel() * t.element_size() for t in module.state_dict().values())


def quant_ops() -> dict:
    """Each product of QUANT_OPS in bf16 against the fp32 dequantized
    reference, and its time beside ``F.linear`` on the bf16 weight."""
    import torch
    import torch.nn.functional as F

    from vla_fastvlm_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for name, n, k in QUANT_OPS:
        w = (torch.randn((n, k), generator=gen, device="cuda") / k ** 0.5).to(torch.bfloat16)
        leaves = {"int8": quant.quantize_kernel(w), "int4": quant.quantize_kernel_int4(w)}
        deq = {"int8": leaves["int8"]["qweight"].float() * leaves["int8"]["scale"][:, None],
               "int4": (quant.unpack_int4(leaves["int4"]["qweight"]).float().reshape(n, leaves["int4"]["scale"].shape[0], -1)
                        * leaves["int4"]["scale"].t()[:, :, None]).reshape(n, k)}
        sizes = {"bf16": w.numel() * 2, **{m: sum(t.numel() * t.element_size() for t in leaves[m].values())
                                           for m in leaves}}
        for tokens in (QUANT_DECODE_TOKENS, QUANT_PREFILL_TOKENS):
            x = torch.randn((tokens, k), generator=gen, device="cuda").to(torch.bfloat16)
            iters = 50 if tokens == QUANT_DECODE_TOKENS else 10
            row = {"bf16_ms": time_ms(lambda: F.linear(x, w), iters)}
            for mode in ("int8", "int4", "w8a8"):
                if mode == "w8a8" and tokens < quant.W8A8_MIN_TOKENS:
                    continue
                leaf, aq = leaves["int4" if mode == "int4" else "int8"], mode == "w8a8"
                y = quant.dense_apply(x, leaf, torch.bfloat16, act_quant=aq)
                ref = x.float() @ deq["int4" if mode == "int4" else "int8"].t()
                err = rel_l2(y, ref)
                row[f"{mode}_rel_l2"] = err
                row[f"{mode}_ms"] = time_ms(lambda: quant.dense_apply(x, leaf, torch.bfloat16, act_quant=aq), iters)
                if not (bool(torch.isfinite(y).all()) and err <= QUANT_OP_REL_L2[mode]):
                    fail(f"{name} {mode} at {tokens} tokens: rel_l2 {err:.3e} (limit {QUANT_OP_REL_L2[mode]:g})")
            out[f"{name} M={tokens}"] = row
            log(f"  7B {name} ({n} x {k}) at {tokens} tokens: " + ", ".join(
                f"{key} {v:.4f}" if key.endswith("_ms") else f"{key} {v:.2e}" for key, v in row.items()))
        out[f"{name} bytes"] = sizes
        log(f"  7B {name} weight bytes: {sizes}")
        del w, leaves, deq
        torch.cuda.empty_cache()
    return out


def quant_policy_steps() -> dict:
    """FastVLA-0.5B at phase 3's shape per mode: launches, the kernel path
    against the plain path, actions against float, the p50 step."""
    import torch

    from vla_fastvlm_tpu_torch.io.quantize import count_quantized
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    images, states, tasks = policy_inputs()
    out, float_actions = {}, None
    for mode in ("none", "int8", "int4", "w8a8"):
        policy = build_policy("auto", "auto", mode)
        bb = policy.model.backbone
        reset_launch_counts()
        actions = policy.forward(images, states, tasks)
        torch.cuda.synchronize()
        counts = launch_counts()
        expect = {"flash_attention": 24, "repmixer_block": 38, "paged_attention": 0, "paged_attention_window": 0}
        if counts != expect or tuple(actions.shape) != (BATCH, 14) or not bool(torch.isfinite(actions).all()):
            fail(f"policy {mode}: launches {counts} (expected {expect}), actions {tuple(actions.shape)}")
        row = dict(quantized_kernels=count_quantized(bb.model), weight_bytes=weight_bytes(bb.model), launches=counts)
        if mode == "none":
            float_actions = actions.float()
        else:
            plain = build_policy("xla", "xla", mode)
            row["kernel_vs_plain"] = rel_l2(actions, plain.forward(images, states, tasks))
            row["vs_float"] = rel_l2(actions, float_actions)
            del plain
            limit = QUANT_W8A8_REL_L2 if mode == "w8a8" else POLICY_REL_L2
            if not (row["quantized_kernels"] == 7 and row["kernel_vs_plain"] <= limit
                    and row["vs_float"] <= QUANT_ACTION_REL_L2[mode]):
                fail(f"policy {mode}: {row}")
        ids, mask = (bb.to_device(a) for a in bb._prep_text(policy.processor.prepare_tasks(tasks, BATCH)))
        img, st = bb.to_device(bb._as_bchw(images)), bb.to_device(states)
        times = []
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            policy.model.apply_fn(img, ids, mask, st)
            torch.cuda.synchronize()
            if i >= 2:  # two warm-up steps
                times.append((time.perf_counter() - t0) * 1e3)
        row.update(p50_step_ms=statistics.median(times), min_step_ms=min(times), max_step_ms=max(times))
        out[mode] = row
        log(f"  policy step {mode}: {json.dumps(row)}")
        del policy, bb, img, ids, mask, st
        torch.cuda.empty_cache()
    return out


def quant_serving(profile_dir: Path | None) -> dict:
    """The serve CLI quantized, then the paged server on the stream per mode
    (tokens/s, device time a decode tick, greedy agreement with float)."""
    import numpy as np
    import torch

    from vla_fastvlm_tpu_torch.models.qwen2 import init_kv_cache
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    out = {name: serve_cli_run(name, extra, profile_dir) for name, extra in QUANT_CLI_RUNS}
    for name, s in out.items():
        log(f"  serve_cli {name}: tokens/s {s['tokens_per_sec']:.1f}, p50 tick {s['p50_tick_ms']:.2f} ms, p50 decode "
            f"tick {s['p50_decode_tick_ms']:.2f} ms, max tick {s['max_tick_ms']:.2f} ms, ticks {s['ticks']}"
            + ("" if "device_idle_share" not in s else f", device idle share {s['device_idle_share']:.3f}"))
    reqs = serve_stream()
    models = {mode: serving_backbone(quantization=mode).model for mode in ("none", "int8", "int4")}
    # The largest |quantized - float| first-token logit over 8 requests: the
    # scale of a divergence quantization alone explains.
    ids, mask, images = (torch.from_numpy(np.concatenate([r[j] for r in reqs[:8]])).cuda() for j in range(3))
    first = {}
    with torch.no_grad():
        for mode, m in models.items():
            cache = init_kv_cache(m.cfg.text, 8, N_IMG + ids.shape[1] + 1, device="cuda")
            first[mode] = m.prefill(images, ids, mask, cache)[0].float()
    outputs = {}
    for mode, m in models.items():
        server = new_server(m, "kernel")
        reset_launch_counts()
        table = None if profile_dir is None else profile_dir / f"serve_quant_{mode}_ticks.txt"
        finished, summary = run_stream(server, reqs, table)
        counts = launch_counts()
        check_answers(f"paged {mode}", server, finished, SERVE_REQUESTS, SERVE["max_new_tokens"])
        expect = {"flash_attention": 0, "repmixer_block": 38 * server.admissions,
                  "paged_attention": DECODER_LAYERS * server.ticks, "paged_attention_window": 0}
        if counts != expect:
            fail(f"paged {mode}: launch counts {counts} != {expect}")
        outputs[mode] = finished
        if mode != "none":
            summary["greedy_agreement_with_float"] = same_tokens(finished, outputs["none"])
            summary["first_token_logit_err"] = float((first[mode] - first["none"]).abs().max())
            summary["first_token_rel_l2"] = rel_rows(first[mode], first["none"])
        out[f"stream_{mode}"] = summary
        log(f"  paged {mode}: {json.dumps(summary)}")
        del server
        torch.cuda.empty_cache()
    for mode in ("int8", "int4"):
        divergence_report(models["none"], reqs, outputs[mode], outputs["none"],
                          out[f"stream_{mode}"]["first_token_logit_err"], f"paged {mode} against float")
    del models
    torch.cuda.empty_cache()
    return out


def quant_speculative() -> dict:
    """The speculative cell's shape with the FastVLM-7B target in bf16 and
    then quantized to int8 in place: acceptance, window launches, the
    weights' bytes and the peak memory of each run."""
    import torch

    from vla_fastvlm_tpu_torch.io.quantize import quantize_params
    from vla_fastvlm_tpu_torch.models import FastVLMConfig, fastvithd, qwen2_0_5b, qwen2_7b
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    target = build_model(FastVLMConfig(vision=fastvithd(**bf16), text=qwen2_7b(**bf16), image_size=1024), SEED)
    draft = build_model(FastVLMConfig(vision=fastvithd(**bf16), text=qwen2_0_5b(vocab_size=TARGET_VOCAB, **bf16),
                                      image_size=1024), SEED + 1)
    reqs = serve_stream()[:SPEC_REQUESTS]
    out, outputs = {}, {}
    for mode in ("bf16", "int8"):
        if mode == "int8":
            t0 = time.perf_counter()
            quantize_params(target, mode="int8")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            out["quantize_s"] = time.perf_counter() - t0
        server = new_spec_server(target, draft, "kernel")
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        finished, summary = run_stream(server, reqs, None, SPEC["num_slots"], SPEC_ARRIVALS)
        counts = launch_counts()
        check_answers(f"spec {mode}", server, finished, SPEC_REQUESTS, SPEC["max_new_tokens"])
        expect = {"flash_attention": 0, "repmixer_block": 2 * 38 * server.admissions, "paged_attention": 0,
                  "paged_attention_window": TARGET_LAYERS * server.spec_ticks}
        if counts != expect:
            fail(f"spec {mode}: launch counts {counts} != {expect}")
        summary.update(target_weight_bytes=weight_bytes(target), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       window_launches_per_round=counts["paged_attention_window"] / server.spec_ticks)
        outputs[mode] = finished
        out[mode] = summary
        log(f"  7B {mode} target, 0.5B draft: {json.dumps(summary)}")
        del server
        torch.cuda.empty_cache()
    out["greedy_agreement"] = same_tokens(outputs["int8"], outputs["bf16"])
    log(f"  7B int8 against bf16 target: weights {out['int8']['target_weight_bytes'] / 2**30:.2f} GiB against "
        f"{out['bf16']['target_weight_bytes'] / 2**30:.2f} GiB, peak {out['int8']['peak_gib']:.2f} against "
        f"{out['bf16']['peak_gib']:.2f} GiB, tokens per slot and round {out['int8']['tokens_per_slot_round']:.3f} "
        f"against {out['bf16']['tokens_per_slot_round']:.3f}, greedy agreement {out['greedy_agreement']:.4f}")
    del target, draft
    torch.cuda.empty_cache()
    return out


def quant_qlora(records, profile_dir: Path | None, out_dir: Path) -> dict:
    """``scripts.train --quantization int8 --lora-rank 16`` at the yaml's
    settings (B moves, the int8 base bit-equal to a fresh build), then
    FastVLA-7B QLoRA over an int8 base."""
    import torch

    from vla_fastvlm_tpu_torch.fastvla import FastVLAPolicy
    from vla_fastvlm_tpu_torch.io.checkpoint import load_policy_from_checkpoint
    from vla_fastvlm_tpu_torch.io.quantize import count_quantized

    result = {"cli": lora_train_cli("mlp", out_dir / "qlora", ("--quantization", "int8"))}
    loaded, _ = load_policy_from_checkpoint(result["cli"]["checkpoint"], device=TRAIN_DEVICE)
    fresh = FastVLAPolicy(loaded.config, device=TRAIN_DEVICE)
    got, ref = loaded.model.backbone.model.state_dict(), fresh.model.backbone.model.state_dict()
    base_same = sorted(got) == sorted(ref) and all(torch.equal(got[k], ref[k]) for k in ref)
    b_moved = all(bool(p.any()) for n, p in loaded.params["lora"].items() if n.endswith(".b"))
    quantized = count_quantized(loaded.model.backbone.model)
    codes = sum(t.dtype == torch.int8 for t in got.values())
    log(f"  QLoRA checkpoint: {quantized} quantized kernels ({codes} int8 tensors), every B moved {b_moved}, the "
        f"int8 base bit-equal to a fresh build's {base_same}")
    if not (base_same and b_moved and quantized == 7):
        fail(f"QLoRA checkpoint: base bit-equal {base_same}, B moved {b_moved}, {quantized} quantized kernels")
    result.update(base_bit_equal=base_same, b_moved=b_moved)
    del loaded, fresh, got, ref
    torch.cuda.empty_cache()
    result["7b"] = lora_train_7b(records, profile_dir, quantization="int8")
    log(f"  FastVLA-7B QLoRA peak memory {result['7b']['peak_gib']:.2f} GiB against the bf16 base's "
        f"{QLORA_BF16_PEAK_GIB} GiB (PR 12)")
    return result


def quant_quality() -> dict:
    """``python -m vla_fastvlm_tpu_torch.scripts.eval_quant_quality`` at
    FastVLM-0.5B, 256 px, in-process (its w8a8 gate restored after)."""
    import math

    from vla_fastvlm_tpu_torch.ops import quant
    from vla_fastvlm_tpu_torch.scripts import eval_quant_quality

    gate = quant.W8A8_MIN_TOKENS
    try:
        summary = eval_quant_quality.main(eval_quant_quality.Args(model_id="fastvlm-0.5b", image_size=256,
                                                                  device="cuda"))
    finally:
        quant.W8A8_MIN_TOKENS = gate
    bad = [k for k, v in summary.items() if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        fail(f"eval_quant_quality: non-finite {bad}")
    return summary


def phase_quant(profile_dir: Path | None = None) -> dict:
    """Phase 11."""
    import shutil

    import torch

    from vla_fastvlm_tpu_torch.data import SyntheticAlohaSource

    log("[11/14] weight quantization: int8 / int4 / w8a8 products at FastVLM-7B's layer shapes, the FastVLA-0.5B "
        "policy step, paged serving and the serve CLI, the 7B int8 target behind a 0.5B draft, QLoRA (0.5B CLI, "
        "7B), eval_quant_quality")
    out_dir = ROOT / "build" / "quant_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    result = {}
    try:
        result["ops"] = quant_ops()
        lap("ops")
        result["policy"] = quant_policy_steps()
        lap("policy")
        result["serving"] = quant_serving(profile_dir)
        lap("serving")
        result["speculative"] = quant_speculative()
        lap("speculative")
        records = SyntheticAlohaSource(num_samples=TRAIN_BATCH, image_hw=TRAIN_FRAME_HW, seed=SEED)
        result["qlora"] = quant_qlora(records, profile_dir, out_dir)
        lap("qlora")
        result["quality"] = quant_quality()
        lap("quality")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    result["card"] = card_line()
    log(f"  seconds by part: {laps}; card: {result['card']}")
    log(json.dumps({"quant": result}))
    return result


# ---------------------------------------------------------------------------
# Apple FastVLM checkpoints (phase 12): a FastVLM-0.5B HF directory
# (FASTVLM_05B_CONFIG: full width and depth, 1024 px) written here from
# seeds, nothing downloaded: the decoder and projector of a seeded port
# model under HF names in two bf16 shards, and the FastViTHD tower in
# Apple's train-mode layout (every branch kind, random BatchNorm statistics,
# layer scales near 1e-2) in an fp32 shard. Loaded through FastVLAPolicy;
# the policy step at phase 9's directory shape (16 frames of 256 px at the
# tower's 1024 px); the serve CLI on 16 requests of 16 new tokens; the
# native letterbox on phase 7's 1024-px frames and ALOHA's 480 x 640 frames
# as uint8.
HF_STEPS, HF_SERVE = 10, dict(num_requests=16, max_new_tokens=16)
# A fused module against its branch sum, both fp32 on the card: relative
# L2 error. Only the order of the sums differs.
HF_FOLD_REL_L2 = 1e-4
# The native letterbox against its numpy plain version (fp32 arithmetic in
# another order) and against the card's letterbox (two fp32 matmuls), on
# [0, 1] pixels: the JAX package's own bounds.
HF_LETTERBOX_ATOL, HF_DEVICE_LETTERBOX_ATOL = 1e-5, 2e-3
HF_FALLBACK_WARNINGS = ("randomly initialized", "could not be converted")
APPLE_PREFIX = "model.vision_tower.vision_tower.model."


class WarningRecords:
    """The package's warnings while inside (``with``)."""

    def __init__(self):
        import logging

        self.logger, self.messages = logging.getLogger("vla_fastvlm_tpu_torch"), []
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda record: self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)

    def fallbacks(self) -> list:
        return [m for m in self.messages if any(w in m for w in HF_FALLBACK_WARNINGS)]


def hf_tower(cfg, gen):
    """Apple's train-mode FastViTHD names (the mobileclip layout) for
    ``cfg``, fp32 values from ``gen`` on the card; and where each of the
    port's modules sits in it. MobileOne blocks carry a conv branch, a 1x1
    scale branch where k > 1 and a BN skip where C_in = C_out at stride 1."""
    import math

    import torch

    sd, where = {}, {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    def weight(*shape):
        return randn(*shape) / math.sqrt(math.prod(shape[1:]))

    def bn(base, c):
        sd[f"{base}.weight"], sd[f"{base}.bias"] = 1 + 0.1 * randn(c), 0.1 * randn(c)
        sd[f"{base}.running_mean"] = 0.1 * randn(c)
        sd[f"{base}.running_var"] = 0.5 + torch.rand(c, generator=gen, device=gen.device)

    def mobileone(base, out, in_per_group, k, conv=True, skip=False):
        if conv:
            sd[f"{base}.rbr_conv.0.conv.weight"] = weight(out, in_per_group, k, k)
            bn(f"{base}.rbr_conv.0.bn", out)
        if conv and k > 1:
            sd[f"{base}.rbr_scale.conv.weight"] = weight(out, in_per_group, 1, 1)
            bn(f"{base}.rbr_scale.bn", out)
        if skip:
            bn(f"{base}.rbr_skip", out)

    def layer_scale(c):
        return 0.01 * (1 + 0.1 * randn(c, 1, 1))

    d0 = cfg.embed_dims[0]
    for i, (in_per_group, k, skip) in enumerate([(3, 3, False), (1, 3, False), (d0, 1, True)]):
        mobileone(f"patch_embed.{i}", d0, in_per_group, k, skip=skip)
        where[f"stem_{i}"] = f"patch_embed.{i}"
    net, prev = 0, d0
    for stage, (dim, depth, mixer, ratio, cpe) in enumerate(
            zip(cfg.embed_dims, cfg.depths, cfg.token_mixers, cfg.mlp_ratios, cfg.pos_embs)):
        if stage > 0:
            groups = math.gcd(prev, dim)
            for part, k in (("lkb_origin", 7), ("small_conv", 3)):
                sd[f"network.{net}.proj.0.{part}.conv.weight"] = weight(dim, prev // groups, k, k)
                bn(f"network.{net}.proj.0.{part}.bn", dim)
            mobileone(f"network.{net}.proj.1", dim, dim, 1, skip=True)
            where[f"patch_embed_{stage}"] = f"network.{net}"
            net += 1
        if cpe:
            sd[f"network.{net}.pe.weight"], sd[f"network.{net}.pe.bias"] = weight(dim, 1, 7, 7), 0.1 * randn(dim)
            where[f"pos_emb_{stage}"] = f"network.{net}"
            net += 1
        for blk in range(depth):
            base = f"network.{net}.{blk}"
            where[f"stage{stage}_block{blk}"] = base
            if mixer == "repmixer":
                mobileone(f"{base}.token_mixer.norm", dim, 1, 3, conv=False, skip=True)
                mobileone(f"{base}.token_mixer.mixer", dim, 1, 3, skip=True)
                sd[f"{base}.token_mixer.layer_scale"] = layer_scale(dim)
                sd[f"{base}.layer_scale"] = layer_scale(dim)
            else:
                bn(f"{base}.norm", dim)
                sd[f"{base}.token_mixer.qkv.weight"] = weight(3 * dim, dim)
                sd[f"{base}.token_mixer.proj.weight"] = weight(dim, dim)
                sd[f"{base}.token_mixer.proj.bias"] = 0.1 * randn(dim)
                sd[f"{base}.layer_scale_1"], sd[f"{base}.layer_scale_2"] = layer_scale(dim), layer_scale(dim)
            hidden = int(dim * ratio)
            sd[f"{base}.convffn.conv.conv.weight"] = weight(dim, 1, 7, 7)
            bn(f"{base}.convffn.conv.bn", dim)
            sd[f"{base}.convffn.fc1.weight"], sd[f"{base}.convffn.fc1.bias"] = weight(hidden, dim, 1, 1), 0.1 * randn(hidden)
            sd[f"{base}.convffn.fc2.weight"], sd[f"{base}.convffn.fc2.bias"] = weight(dim, hidden, 1, 1), 0.1 * randn(dim)
        net += 1
        prev = dim
    mobileone("conv_exp", cfg.out_channels, 1, 3)
    where["conv_exp"] = "conv_exp"
    return {APPLE_PREFIX + k: v for k, v in sd.items()}, where


def hf_decoder(model) -> dict:
    """A port FastVLM's decoder and projector under HF llava_qwen2 names:
    ``qkv_proj`` split into q/k/v and ``gate_up_proj`` into gate/up."""
    text = model.cfg.text
    d = text.resolved_head_dim
    sizes = {"qkv_proj": (("q_proj", "k_proj", "v_proj"),
                          [text.num_attention_heads * d, text.num_key_value_heads * d, text.num_key_value_heads * d]),
             "gate_up_proj": (("gate_proj", "up_proj"), [text.intermediate_size] * 2)}
    out = {}
    for name, t in model.language_model.state_dict().items():
        owner, leaf = name.rsplit(".", 1)
        parent, _, module = owner.rpartition(".")
        if module in sizes:
            for part, piece in zip(sizes[module][0], t.split(sizes[module][1])):
                out[f"model.{parent}.{part}.{leaf}"] = piece
        else:
            out[f"model.{name}"] = t
    for name, t in model.mm_projector.state_dict().items():
        module, leaf = name.split(".")
        out[f"model.mm_projector.{dict(fc1=0, fc2=2)[module]}.{leaf}"] = t
    return out


def hf_write_directory(path: Path) -> tuple:
    """FASTVLM_05B_CONFIG's directory at ``path``: shards 1-2 the decoder and
    projector (bf16) of a port FastVLM seeded with SEED, shard 3 the
    train-mode tower (fp32). Returns (the source model on the card, the
    tower's Apple names on the card, where the port's modules sit)."""
    import torch

    from vla_fastvlm_tpu_torch.io.checkpoint import save_safetensors
    from vla_fastvlm_tpu_torch.io.presets import resolve_fastvlm_config
    from vla_fastvlm_tpu_torch.models.fastvlm import FastVLM
    from vla_fastvlm_tpu_torch.models.layers import init_weights

    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(FASTVLM_05B_CONFIG))
    cfg, _ = resolve_fastvlm_config(str(path), dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(SEED)
    with torch.device(TRAIN_DEVICE):
        model = FastVLM(cfg)
    init_weights(model.eval().requires_grad_(False), gen)
    decoder = hf_decoder(model)
    half = cfg.text.num_hidden_layers // 2
    second = {k: v for k, v in decoder.items() if k == "model.norm.weight" or
              (k.startswith("model.layers.") and int(k.split(".")[2]) >= half)}
    save_safetensors({k: v for k, v in decoder.items() if k not in second}, path / "model-00001-of-00003.safetensors")
    save_safetensors(second, path / "model-00002-of-00003.safetensors")
    tower, where = hf_tower(cfg.vision, gen)
    save_safetensors(tower, path / "model-00003-of-00003.safetensors")
    return model, tower, where


def hf_fold_checks(tower: dict, fused: dict, where: dict, vcfg) -> dict:
    """One module of each kind at full width: the fused conv's fp32 output
    against the sum of its train-time branches (``F.conv2d`` +
    ``F.batch_norm`` in eval on the shard's own tensors), on the card."""
    import math

    import torch
    import torch.nn.functional as F

    src = {k[len(APPLE_PREFIX):]: v.float() for k, v in tower.items()}
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(SEED + 7)

    def bn(x, base):
        return F.batch_norm(x, src[f"{base}.running_mean"], src[f"{base}.running_var"], src[f"{base}.weight"],
                            src[f"{base}.bias"], False, 0.0, 1e-5)

    def conv(x, w, b=None, stride=1, groups=1):
        return F.conv2d(x, w, b, stride, w.shape[-1] // 2, 1, groups)

    def mobileone(x, base, stride, groups):
        out = 0
        if f"{base}.rbr_conv.0.conv.weight" in src:
            out = out + bn(conv(x, src[f"{base}.rbr_conv.0.conv.weight"], None, stride, groups), f"{base}.rbr_conv.0.bn")
        if f"{base}.rbr_scale.conv.weight" in src:
            out = out + bn(conv(x, src[f"{base}.rbr_scale.conv.weight"], None, stride, groups), f"{base}.rbr_scale.bn")
        if f"{base}.rbr_skip.weight" in src:
            out = out + bn(x, f"{base}.rbr_skip")
        return out

    def fused_conv(x, name, stride=1, groups=1):
        w = fused[f"{name}.conv.weight"].to(TRAIN_DEVICE)
        w = w[:, :, None, None] if w.ndim == 2 else w
        return conv(x, w, fused[f"{name}.conv.bias"].to(TRAIN_DEVICE), stride, groups)

    def rand(c, hw):
        return torch.randn((2, c, hw, hw), generator=gen, device=TRAIN_DEVICE)

    d = vcfg.embed_dims
    cases = {}
    for i, (c_in, stride, groups) in enumerate([(3, 2, 1), (d[0], 2, d[0]), (d[0], 1, 1)]):
        x = rand(c_in, 64)
        cases[f"stem_{i}"] = (mobileone(x, where[f"stem_{i}"], stride, groups), fused_conv(x, f"stem_{i}", stride, groups))
    for stage, c in enumerate(d[:3]):
        x, base = rand(c, 32), where[f"stage{stage}_block0"] + ".token_mixer"
        ls = src[f"{base}.layer_scale"].reshape(1, -1, 1, 1)
        ref = x + ls * (mobileone(x, f"{base}.mixer", 1, c) - mobileone(x, f"{base}.norm", 1, c))
        cases[f"RepMixer C={c}"] = (ref, fused_conv(x, f"stage{stage}_block0.token_mixer", 1, c))
    x, base, groups = rand(d[0], 32), where["patch_embed_1"] + ".proj.0", math.gcd(d[0], d[1])
    ref = bn(conv(x, src[f"{base}.lkb_origin.conv.weight"], None, 2, groups), f"{base}.lkb_origin.bn") + \
        bn(conv(x, src[f"{base}.small_conv.conv.weight"], None, 2, groups), f"{base}.small_conv.bn")
    cases["large-kernel patch embed"] = (ref, fused_conv(x, "patch_embed_1.large_kernel", 2, groups))
    x, base = rand(d[3], 16), where["pos_emb_3"]
    cases["RepCPE"] = (x + conv(x, src[f"{base}.pe.weight"], src[f"{base}.pe.bias"], 1, d[3]),
                       fused_conv(x, "pos_emb_3", 1, d[3]))
    x, base = rand(d[0], 32), where["stage0_block0"] + ".convffn.conv"
    cases["ConvFFN conv+BN"] = (bn(conv(x, src[f"{base}.conv.weight"], None, 1, d[0]), f"{base}.bn"),
                                fused_conv(x, "stage0_block0.convffn.dw", 1, d[0]))
    x = rand(d[-1], 16)
    cases["conv_exp"] = (mobileone(x, "conv_exp", 1, d[-1]), fused_conv(x, "conv_exp", 1, d[-1]))
    errs = {}
    for kind, (ref, out) in cases.items():
        errs[kind] = rel_l2(out, ref)
        log(f"  fold {kind}: fused conv vs branch sum, fp32, {tuple(ref.shape)}: rel_l2 {errs[kind]:.3e}, max_abs_err "
            f"{float((out - ref).abs().max()):.3e} (limit {HF_FOLD_REL_L2:g})")
    if not all(e <= HF_FOLD_REL_L2 for e in errs.values()):
        fail(f"hf: a fused module differs from its branch sum: {errs}")
    return errs


def hf_inference_names(fused: dict, where: dict) -> dict:
    """The fused tower under Apple's inference-mode names (``reparam_conv``,
    ``lkb_reparam``), fp32. The ConvFFN's conv and the attention blocks'
    norm have no fused form there: they keep ``conv.bn`` / ``norm`` with an
    identity BatchNorm (mean 0, var + eps == 1 in fp32), so each fold gives
    back the stored values exactly."""
    import torch

    one = torch.tensor(1.0 - 1e-5, dtype=torch.float32)
    if float(one + 1e-5) != 1.0:
        fail("hf: no fp32 variance folds to an exact identity")
    out = {}

    def conv_weight(t):
        return t[:, :, None, None] if t.ndim == 2 else t

    def identity_bn(base, c, weight=None, bias=None):
        out[f"{base}.weight"] = torch.ones(c) if weight is None else weight
        out[f"{base}.bias"] = torch.zeros(c) if bias is None else bias
        out[f"{base}.running_mean"], out[f"{base}.running_var"] = torch.zeros(c), one.expand(c).clone()

    for key, t in fused.items():
        module, rest = key.split(".", 1)
        base = where.get(module)
        if module.startswith(("stem_", "conv_exp", "pos_emb_")):
            out[f"{base}.reparam_conv.{rest.rsplit('.', 1)[1]}"] = conv_weight(t)
        elif module.startswith("patch_embed_"):
            part, _, leaf = rest.split(".")
            out[f"{base}.proj.{0 if part == 'large_kernel' else 1}."
                f"{'lkb_reparam' if part == 'large_kernel' else 'reparam_conv'}.{leaf}"] = conv_weight(t)
        elif rest.startswith("token_mixer.conv."):
            out[f"{base}.token_mixer.reparam_conv.{rest.rsplit('.', 1)[1]}"] = conv_weight(t)
        elif rest.startswith("convffn.dw.conv."):
            out[f"{base}.convffn.conv.conv.{rest.rsplit('.', 1)[1]}"] = t
            identity_bn(f"{base}.convffn.conv.bn", t.shape[0])
        elif rest.startswith(("convffn.fc1.", "convffn.fc2.")):
            out[f"{base}.{rest.replace('.conv.', '.')}"] = conv_weight(t)
        elif rest.endswith(".gamma"):
            out[f"{base}.{rest[:-len('.gamma')]}"] = t.reshape(-1, 1, 1)
        elif rest.startswith("norm."):
            if rest == "norm.weight":
                identity_bn(f"{base}.norm", t.shape[0], weight=t, bias=fused[f"{module}.norm.bias"])
        else:  # token_mixer.qkv / proj
            out[f"{base}.{rest}"] = t
    return {APPLE_PREFIX + k: v.float().contiguous() for k, v in out.items()}


def hf_policy(path, impl="auto"):
    """FastVLAPolicy on the card from ``path`` (a directory or a preset), the
    configuration ``scripts.convert_checkpoint`` writes with ``--dtype
    bfloat16`` (bf16 parameters, seed 0, the tower's 1024 px)."""
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy

    return FastVLAPolicy(FastVLAConfig(vlm_model_name=str(path), bootstrap_model_name=str(path), dtype="bfloat16",
                                       param_dtype="bfloat16", attention_impl=impl, vision_block_impl=impl,
                                       seed=SEED), device=TRAIN_DEVICE)


def hf_load(path, what: str, impl="auto"):
    """``hf_policy`` of a directory, failing on any fallback warning; the
    policy and its load seconds by part."""
    import torch

    with WarningRecords() as records:
        t0 = time.perf_counter()
        policy = hf_policy(path, impl)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    if records.fallbacks():
        fail(f"hf: {what}: {records.fallbacks()}")
    parts = {k: round(v, 3) for k, v in policy.model.backbone.load_seconds.items()}
    log(f"  {what}: FastVLAPolicy built in {seconds:.2f} s, the directory's load by part {parts} s; no fallback warning")
    return policy, dict(parts, policy_s=seconds)


def hf_letterbox() -> dict:
    """The native letterbox: built, against its numpy plain version and the
    port's letterbox on the card, ms a frame."""
    import numpy as np
    import torch

    from vla_fastvlm_tpu_torch import native
    from vla_fastvlm_tpu_torch.ops.image import resize_with_pad

    t0 = time.perf_counter()
    if not native.native_available():
        fail("hf: the native letterbox did not build")
    result = {"build_s": time.perf_counter() - t0}
    rng = np.random.default_rng(SEED)
    frame_sets = {
        "phase 7's 1024x1024 frames": np.stack([np.rint(r[2][0] * 255).astype(np.uint8) for r in serve_stream(n=8)]),
        "ALOHA's 480x640 frames": rng.integers(0, 256, (16, 3) + TRAIN_FRAME_HW, dtype=np.uint8),
    }
    for name, frames in frame_sets.items():
        out = native.letterbox_batch(frames, LOOP_IMAGE)
        plain = native._letterbox_numpy(frames, LOOP_IMAGE, 0.0, 1.0 / 255.0)
        card = resize_with_pad(torch.from_numpy(frames).to(TRAIN_DEVICE).float() / 255.0, LOOP_IMAGE, LOOP_IMAGE)
        errs = {"numpy": float(np.abs(out - plain).max()),
                "card": float((torch.from_numpy(out).to(TRAIN_DEVICE) - card).abs().max())}
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            native.letterbox_batch(frames, LOOP_IMAGE)
            times.append((time.perf_counter() - t0) * 1e3 / len(frames))
        result[name] = dict(errs, ms_a_frame=statistics.median(times), frames=len(frames))
        log(f"  native letterbox, {name} -> {LOOP_IMAGE} px: max_abs_err {errs['numpy']:.3e} against numpy (limit "
            f"{HF_LETTERBOX_ATOL:g}), {errs['card']:.3e} against the card's resize_with_pad (limit "
            f"{HF_DEVICE_LETTERBOX_ATOL:g}); {result[name]['ms_a_frame']:.3f} ms a frame (median of 3 batches of "
            f"{len(frames)}, every host core, host clock)")
        if out.shape != (len(frames), 3, LOOP_IMAGE, LOOP_IMAGE) or errs["numpy"] > HF_LETTERBOX_ATOL or \
                errs["card"] > HF_DEVICE_LETTERBOX_ATOL:
            fail(f"hf: native letterbox {name}: shape {out.shape}, errors {errs}")
    return result


def phase_hf() -> dict:
    """Phase 12."""
    import os
    import shutil

    import numpy as np
    import torch

    import vla_fastvlm_tpu_torch as port
    from vla_fastvlm_tpu_torch.io.checkpoint import load_safetensors, save_safetensors
    from vla_fastvlm_tpu_torch.io.vision_convert import convert_vision_tower
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.scripts import convert_checkpoint, serve

    log("[12/14] Apple FastVLM checkpoints: a FastVLM-0.5B HF directory (bf16 decoder shards, train-mode tower) "
        "through FastVLAPolicy, the fold per module kind, the policy step, an inference-mode twin, "
        "convert_checkpoint, the serve CLI, the native letterbox")
    out = ROOT / "build" / "hf_smoke"
    shutil.rmtree(out, ignore_errors=True)
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    result = {}
    try:
        train_dir = out / "train_mode"
        source, tower, where = hf_write_directory(train_dir)
        sizes = {p.name: round(p.stat().st_size / 2**20, 1) for p in sorted(train_dir.glob("*.safetensors"))}
        log(f"  wrote {train_dir.name}/: shards (MiB) {sizes}")
        lap("write")

        policy, result["load_s"] = hf_load(train_dir, "train-mode directory")
        backbone = policy.model.backbone
        state = backbone.model.state_dict()
        src = {**{f"language_model.{k}": v for k, v in source.language_model.state_dict().items()},
               **{f"mm_projector.{k}": v for k, v in source.mm_projector.state_dict().items()}}
        differ = [k for k, v in src.items() if not torch.equal(state[k], v)]
        fused = convert_vision_tower(load_safetensors(train_dir / "model-00003-of-00003.safetensors"),
                                     backbone.model_config.vision)
        tower_differ = [k for k, v in fused.items() if not torch.equal(state[f"vision_tower.{k}"].cpu(),
                                                                       v.to(torch.bfloat16))]
        log(f"  {len(src)} decoder and projector tensors bit-equal to the source: {not differ}; {len(fused)} tower "
            f"tensors equal to the fp32 fold cast to bf16: {not tower_differ}")
        if differ or tower_differ or set(state) != set(src) | {f"vision_tower.{k}" for k in fused}:
            fail(f"hf: loaded tensors differ: decoder {differ[:3]}, tower {tower_differ[:3]}")
        del source
        torch.cuda.empty_cache()
        result["fold_rel_l2"] = hf_fold_checks(tower, fused, where, backbone.model_config.vision)
        lap("load and folds")

        # The policy step: kernel path against plain path on the same weights.
        rng = np.random.default_rng(SEED)
        frames = rng.random((SURFACE_DIR_FRAMES, 3, 256, 256), dtype=np.float32)
        states = rng.standard_normal((SURFACE_DIR_FRAMES, 14)).astype(np.float32)
        task = "insert the peg"
        reset_launch_counts()
        actions = policy.forward(frames, states, task)
        torch.cuda.synchronize()
        check_surface_launches(f"hf: loaded policy, one forward of {SURFACE_DIR_FRAMES} frames", launch_counts(), 1)
        plain = hf_policy(TRAIN_MODEL, "xla")
        plain.model.backbone.model.load_state_dict(state)
        plain.model.head.load_state_dict(policy.model.head.state_dict())
        reset_launch_counts()
        plain_actions = plain.forward(frames, states, task)
        torch.cuda.synchronize()
        if any(launch_counts().values()) or tuple(actions.shape) != (SURFACE_DIR_FRAMES, 14) or \
                not bool(torch.isfinite(actions).all()):
            fail(f"hf: plain path launched {launch_counts()}, or actions {tuple(actions.shape)} are not finite")
        bb, pbb = backbone, plain.model.backbone
        img = bb.to_device(bb._as_bchw(frames))
        ids, mask = (bb.to_device(a) for a in bb._prep_text(policy.processor.prepare_tasks(task, SURFACE_DIR_FRAMES)))
        errs = {"pooled features": rel_l2(bb.features_fn(img, ids, mask), pbb.features_fn(img, ids, mask)),
                "actions": rel_l2(actions, plain_actions)}
        log(f"  kernel vs plain path on the loaded weights: rel_l2 {json.dumps({k: f'{v:.3e}' for k, v in errs.items()})} "
            f"(limit {POLICY_REL_L2:g})")
        if not all(e <= POLICY_REL_L2 for e in errs.values()):
            fail(f"hf: the kernel path differs from the plain path: {errs}")
        del plain, pbb
        torch.cuda.empty_cache()
        states_dev = bb.to_device(states)
        step_ms = []
        for _ in range(HF_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            policy.model.apply_fn(img, ids, mask, states_dev)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        result.update(policy_rel_l2=errs, p50_step_ms=statistics.median(step_ms[1:]), step_ms=step_ms[1:])
        log(f"  p50 policy step {result['p50_step_ms']:.2f} ms (batch {SURFACE_DIR_FRAMES}, {LOOP_IMAGE} px, "
            f"{HF_STEPS} steps after one warm-up, min {min(step_ms[1:]):.2f}, max {max(step_ms[1:]):.2f}; host clock "
            f"around synchronized steps); card: {card_line()}")
        lap("policy step")

        # The same fused weights under inference-mode names: a bit-equal load.
        infer_dir = out / "inference_mode"
        infer_dir.mkdir()
        for p in train_dir.glob("*"):
            if p.name != "model-00003-of-00003.safetensors":
                os.symlink(p.resolve(), infer_dir / p.name)
        save_safetensors(hf_inference_names(fused, where), infer_dir / "model-00003-of-00003.safetensors")
        twin, result["inference_mode_load_s"] = hf_load(infer_dir, "inference-mode directory")
        twin_state = twin.model.backbone.model.state_dict()
        same_state = set(twin_state) == set(state) and all(torch.equal(twin_state[k], v) for k, v in state.items())
        same_actions = torch.equal(twin.forward(frames, states, task), actions)
        log(f"  inference-mode twin (reparam_conv / lkb_reparam): state_dict bit-equal {same_state}, actions "
            f"bit-equal {same_actions}")
        if not (same_state and same_actions):
            fail("hf: the inference-mode directory does not load the train-mode directory's weights")
        del twin, twin_state
        torch.cuda.empty_cache()
        lap("inference mode")

        # convert_checkpoint, then the policy loader on its output.
        ckpt = out / "converted"
        with WarningRecords() as records:
            t0 = time.perf_counter()
            convert_checkpoint.main(convert_checkpoint.ConvertArgs(checkpoint_dir=str(train_dir), output_dir=str(ckpt),
                                                                   dtype="bfloat16", device=TRAIN_DEVICE))
            result["convert_s"] = time.perf_counter() - t0
            loaded, device = port.load_policy_from_checkpoint(ckpt, device=TRAIN_DEVICE)
        same = torch.equal(loaded.forward(frames, states, task), actions)
        log(f"  convert_checkpoint in {result['convert_s']:.1f} s; load_policy_from_checkpoint: "
            f"{type(loaded).__name__} on {device}, actions bit-equal to the loaded policy's {same}")
        if records.fallbacks() or not same:
            fail(f"hf: convert_checkpoint: warnings {records.fallbacks()}, actions bit-equal {same}")
        del loaded, policy, backbone, state
        torch.cuda.empty_cache()
        lap("convert_checkpoint")

        # The serve CLI from the directory.
        args = serve.ServeArgs(**dict(SERVE_CLI, model_id=str(train_dir), **HF_SERVE))
        with WarningRecords() as records:
            reset_launch_counts()
            summary = serve.main(args)
            torch.cuda.synchronize()
            counts = launch_counts()
        if records.fallbacks():
            fail(f"hf: serve: {records.fallbacks()}")
        check_cli_run("hf serve", args, summary, counts)
        result["serve"] = {k: summary[k] for k in ("tokens_per_sec", "p50_tick_ms", "ticks", "decode_ticks",
                                                   "admissions")}
        log(f"  serve --model-id {train_dir.name}/ --paged: {args.num_requests} requests x {args.max_new_tokens} new "
            f"tokens, tokens/s {summary['tokens_per_sec']:.1f}, p50 tick {summary['p50_tick_ms']:.2f} ms, launches "
            f"{counts} (paged = {DECODER_LAYERS} x {summary['decode_ticks']} ticks), every page back")
        torch.cuda.empty_cache()
        lap("serve")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    result["letterbox"] = hf_letterbox()
    lap("letterbox")
    result["card"] = card_line()
    log(f"  seconds by part: {laps}; card: {result['card']}")
    log(json.dumps({"hf": result}))
    return result


def phase_timing(policy, plain, step):
    import torch

    from vla_fastvlm_tpu_torch.utils.flops import device_peak_flops, fastvlm_serve_flops, mfu

    log("[13/14] timing (kernels: CUDA graph replay between CUDA events; steps: host clock around synchronized steps)")

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
    t0 = time.perf_counter()
    step_flops = fastvlm_serve_flops(policy.model, BATCH, TEXT_LEN)
    count_s = time.perf_counter() - t0
    card = card_line()
    for what, ms in (("kernel path", kernel_ms), ("plain path", plain_ms)):
        p50 = statistics.median(ms)
        log(f"  step {what}: p50 {p50:.2f} ms, {BATCH / p50 * 1e3:.1f} actions/s "
            f"(min {min(ms):.2f}, max {max(ms):.2f}, n={len(ms)}); {step_flops / 1e9:.1f} GFLOP a step "
            f"(fastvlm_serve_flops, counted in {count_s:.2f} s), MFU {mfu(step_flops, p50 / 1e3):.4f} of "
            f"{device_peak_flops() / 1e12:.1f} TFLOP/s; {card}")

    results = {"flash_attention": time_flash(sweep=False)["flash_attention"]}
    results.update(time_paged(sweep=False))
    results["repmixer_block"] = time_repmixer()
    return results


# Flash shapes timed, bf16, causal: (name, shape). The policy step's (24
# launches a step), the 7B decoder's heads, and the streamed instance's.
FLASH_TIMED = [("flash_attention", FLASH_MAIN), ("flash_attention d128", FLASH_7B)] + [
    (f"flash_attention S={shape['t']} d{shape['d']}", shape) for shape in FLASH_LONG]
# Block shapes swept at the main shape and at D = 128 (35 tiles of 16 packed
# rows a (batch row, KV head) at both): (tiles a block, warps).
FLASH_SWEEP = [(1, 1), (2, 2), (4, 2), (4, 4), (5, 5), (7, 4), (7, 7), (8, 4), (8, 8), (14, 7), (35, 8)]


def time_flash(sweep: bool) -> dict:
    """At each of FLASH_TIMED's shapes: the wrapper call (``ms``), the
    kernel's launch alone (``kernel_ms``: the mask already int32), the plain
    version, ``scaled_dot_product_attention`` on the same inputs with a
    boolean mask (``library_ms``) and the bound; with ``sweep`` also the
    launch alone with the L2 emptied first (``cold_ms``), at the main shape
    with every key valid, and at the first two shapes for each of
    FLASH_SWEEP's block shapes, with the blocks an SM holds."""
    import torch
    import torch.nn.functional as F

    from vla_fastvlm_tpu_torch.ops.kernels import flash_attention, flash_attention_reference, flash_attention_streamed

    fa = importlib.import_module("vla_fastvlm_tpu_torch.ops.kernels.flash_attention")  # the module, not the function
    results = {}
    for i, (name, shape) in enumerate(FLASH_TIMED):
        q, k, v, mask = flash_inputs(**shape, dtype=torch.bfloat16)
        long = shape in FLASH_LONG
        out = flash_attention(q, k, v, mask, True)
        t, s = q.shape[1], k.shape[1]
        bool_mask = mask.bool()[:, None, None, :] & torch.ones(t, s, dtype=torch.bool, device="cuda").tril()
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        alone = lambda q=q, k=k, v=v, mask=mask: fa._launch(q, k, v, mask, True, q.shape[-1] ** -0.5)
        bound, by = flash_bound_ms(q, k, v, mask, out)
        r = dict(ms=time_ms(lambda: flash_attention(q, k, v, mask, True), 10 if long else 50),
                 kernel_ms=time_ms(alone, 10 if long else 50),
                 plain_ms=time_ms(lambda: flash_attention_reference(q, k, v, mask, True), 3 if long else 20),
                 library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bool_mask,
                                                                         enable_gqa=True), 10 if long else 50),
                 bound_ms=bound, bound_by=by)
        extra = ""
        if sweep:
            r["cold_ms"] = time_cold_ms(alone, 10 if long else 20)
            extra += f", cold L2 {r['cold_ms']:.4f} ms"
        if i == 0:
            r["streamed_ms"] = time_ms(lambda: flash_attention_streamed(q, k, v, mask, True), 50)
            extra += f", streamed instance {r['streamed_ms']:.4f} ms"
            if sweep:
                qf, kf, vf, full = flash_inputs(**shape, dtype=torch.bfloat16, pad="none")
                r["all_keys_kernel_ms"] = time_ms(lambda: fa._launch(qf, kf, vf, full, True, q.shape[-1] ** -0.5), 50)
                extra += f", every key valid {r['all_keys_kernel_ms']:.4f} ms"
        if sweep and not long:
            r["by_block"] = {}
            for tiles, warps in FLASH_SWEEP:
                run = lambda: fa._launch(q, k, v, mask, True, q.shape[-1] ** -0.5, tiles=tiles, warps=warps)
                r["by_block"][f"{tiles}x{warps}"] = (time_ms(run, 50), fa.blocks_per_sm(q, k, tiles=tiles, warps=warps))
            extra += ", by (tiles, warps): " + ", ".join(
                f"{key} {ms:.4f} ({per} a SM)" for key, (ms, per) in r["by_block"].items())
        if not long:
            r["plan"] = fa.flash_plan(q.shape[1], q.shape[2], k.shape[2], q.shape[3])
            r["blocks_per_sm"] = fa.blocks_per_sm(q, k)
            extra += f", plan (tiles, warps) {r['plan']}, {r['blocks_per_sm']} blocks a SM"
        results[name] = r
        per = "; x24 per step" if shape is FLASH_MAIN else ""
        log(f"  {name} q{tuple(q.shape)} k{tuple(k.shape)}: wrapper {r['ms']:.4f} ms, kernel alone "
            f"{r['kernel_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
            f"bound {bound:.4f} ms ({by}){extra}{per}")
    return results


# The 8 paged shapes timed, bf16 queries: (name, shape, int8 pools). The
# decode tick's (one launch per layer and tick) at the 0.5B serving shape and
# with the 7B decoder's heads; the verify window's (one launch per target
# layer and round) at the 7B verify shape, the main path's, and with the
# 0.5B heads.
PAGED_TIMED = [("paged_attention", PAGED_MAIN, False), ("paged_attention_int8", PAGED_MAIN, True),
               ("paged_attention d128", PAGED_7B, False), ("paged_attention_int8 d128", PAGED_7B, True),
               ("paged_attention_window", WINDOW_7B, False), ("paged_attention_window_int8", WINDOW_7B, True),
               ("paged_attention_window 0.5B heads", WINDOW_MAIN, False),
               ("paged_attention_window_int8 0.5B heads", WINDOW_MAIN, True)]
SWEEP_SPLITS = (1, 2, 3, 6)


def kernel_alone(args, scales, splits=None):
    """The paged kernel's launch alone: mask and tables already int32, so
    the wrapper converts nothing."""
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import paged_attention as pa

    q, pk, pv, tables, mask, _, kn, vn = args
    t32, m32 = tables.to(torch.int32).contiguous(), mask.to(torch.int32).contiguous()
    ks, vs = scales.get("pool_k_scale"), scales.get("pool_v_scale")
    return lambda: pa._launch(q, pk, pv, t32, m32, kn, vn, ks, vs, q.shape[-1] ** -0.5, splits=splits)


def time_cold_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn`` with the L2 emptied before it: a
    graph of ``iters`` (flush, call) pairs less one of ``iters`` flushes,
    each flush a write of twice the L2."""
    import torch

    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    flush = torch.empty(2 * l2 // 4, dtype=torch.int32, device="cuda")

    def both():
        flush.zero_()
        fn()

    return time_ms(both, iters) - time_ms(flush.zero_, iters)


def time_paged(sweep: bool) -> dict:
    """At each of PAGED_TIMED's shapes: the wrapper call (``ms``; inputs as
    ``paged_inputs`` makes them: a bool mask), the kernel's launch alone
    (``kernel_ms``), the plain version, the bound and the planned parts;
    with ``sweep`` also the launch alone with the L2 emptied first
    (``cold_ms``) and at each of SWEEP_SPLITS parts the window has tiles
    for."""
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import paged_attention as pa

    results = {}
    for name, shape, int8 in PAGED_TIMED:
        args, scales = paged_inputs(**shape, dtype=torch.bfloat16, int8=int8)
        wrapper, plain = paged_fns("w" in shape)
        out = wrapper(*args, **scales)
        bound, by = paged_bound_ms(args, scales, out)
        r = dict(ms=time_ms(lambda: wrapper(*args, **scales), 50), kernel_ms=time_ms(kernel_alone(args, scales), 50),
                 plain_ms=time_ms(lambda: plain(*args, **scales), 20), library_ms=None, bound_ms=bound, bound_by=by,
                 splits=pa.planned_splits(args[0], args[1], args[3]), wave=pa.instance_wave(args[0], args[1]))
        extra = f", {r['splits']} parts (one wave: {r['wave']} blocks)"
        if sweep:
            r["cold_ms"] = time_cold_ms(kernel_alone(args, scales), 20)
            tiles = -(-args[4].shape[1] // pa.TILE)
            r["ms_by_splits"] = {s: time_ms(kernel_alone(args, scales, s), 50) for s in SWEEP_SPLITS if s <= tiles}
            extra += f", cold L2 {r['cold_ms']:.4f} ms, by parts " + ", ".join(
                f"{s}: {t:.4f}" for s, t in r["ms_by_splits"].items())
        results[name] = r
        per = (f"x{TARGET_LAYERS} per round at 7B" if "w" in shape
               else f"x{TARGET_LAYERS} per 7B tick" if shape["d"] == 128 else f"x{DECODER_LAYERS} per 0.5B tick")
        log(f"  {name} q{tuple(args[0].shape)} pool{tuple(args[1].shape)} {args[1].dtype}: wrapper {r['ms']:.4f} ms, "
            f"kernel alone {r['kernel_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by})"
            f"{extra}; {per}")
    return results


def time_repmixer() -> dict:
    """Time per launch of the RepMixer kernel and its plain version at each
    stage's main-path shape, with the bound, and their mean over a policy
    step's launches."""
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import repmixer_block, repmixer_block_reference
    from vla_fastvlm_tpu_torch.ops.kernels.repmixer import _dw_weight

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
        # A launch's time is linear in its hidden chunks of 64: the same
        # input with F = 64 and 128 separates the per-chunk cost (fc1, GELU,
        # fc2, the weight copies) from the fixed part (the depthwise pair,
        # the epilogue).
        f = shape[-1]
        cut = lambda k: args[:5] + [args[5][:, :k].contiguous(), args[6][:k], args[7][:k].contiguous()] + args[8:]
        t64, t128 = (time_ms(lambda a=cut(k): repmixer_block(*a), 20) for k in (64, 128))
        chunk = (ms - t64) / (f // 64 - 1)
        log(f"    F=64 {t64:.4f} ms, F=128 {t128:.4f} ms: {chunk:.4f} ms a hidden chunk "
            f"(F=128 predicts {t64 + chunk:.4f}), fixed part {t64 - chunk:.4f} ms = "
            f"{(t64 - chunk) / ms:.1%} of the launch")
    log(f"  repmixer_block per step: kernel {total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, "
        f"bound {total['bound_ms']:.3f} ms over {launches} launches")
    args = repmixer_inputs(16, 16, 16, 384, 1536, torch.float32)
    log(f"  repmixer_block fp32 (16, 16, 16, 384) F 1536: kernel {time_ms(lambda: repmixer_block(*args), 10):.4f} ms, "
        f"plain {time_ms(lambda: repmixer_block_reference(*args), 5):.4f} ms")
    return dict(
        ms=total["ms"] / launches, plain_ms=total["plain_ms"] / launches, library_ms=None,
        bound_ms=total["bound_ms"] / launches,
        bound_by="operations" if total["ops_ms"] >= total["bytes_ms"] else "bytes",
    )


# Kernel-name patterns of the step's parts, first match wins; the rest is
# unfused elementwise work (PyTorch's elementwise, reduction, copy and cat
# kernels) and other kernels.
STEP_PARTS = [("RepMixer", ("repmixer_kernel",)), ("flash", ("flash_fwd",)),
              ("paged attention", ("paged_decode", "paged_window")),
              ("convolutions", ("conv", "cudnn", "fprop")), ("GEMMs", ("nvjet", "gemm", "cutlass", "xmma")),
              ("optimizer", ("Adam", "adam"))]
OTHER_PART = "elementwise and other"
# Autograd nodes whose kernels form a part of their own, whatever their names:
# the backward of the kernels' autograd Functions (``_FlashAttention``,
# ``_RepMixerBlock``), which recompute through the plain versions. The
# profiler records each node's backward as a range of this name.
RECOMPUTE_PARTS = {"_FlashAttentionBackward": "flash backward (plain recompute)",
                   "_RepMixerBlockBackward": "RepMixer backward (plain recompute)"}


def _part_of(kernel_name: str) -> str:
    return next((part for part, keys in STEP_PARTS if any(k in kernel_name for k in keys)), OTHER_PART)


def step_parts(prof, steps: int) -> dict:
    """Device time a step (ms) of each part of STEP_PARTS and RECOMPUTE_PARTS
    that took any, and of the rest, summed over the kernels ``prof``
    recorded. A kernel launched inside a recompute node's backward counts
    for that node and not for its name's part."""
    from torch.autograd import DeviceType

    parts = dict.fromkeys([name for name, _ in STEP_PARTS] + list(RECOMPUTE_PARTS.values()) + [OTHER_PART], 0.0)
    for evt in prof.key_averages():
        # A profiler range (record_function, Optimizer.step) also shows as a
        # device event spanning its kernels: count the kernels only.
        annotation = getattr(evt, "is_user_annotation", False) or evt.key.startswith("Optimizer.")
        if evt.device_type == DeviceType.CUDA and not annotation:
            parts[_part_of(evt.key)] += evt.self_device_time_total / 1e3 / steps
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        node = evt
        while node is not None and node.name not in RECOMPUTE_PARTS:
            node = node.cpu_parent
        if node is not None:
            for kernel in evt.kernels:
                ms = kernel.duration / 1e3 / steps
                parts[RECOMPUTE_PARTS[node.name]] += ms
                parts[_part_of(kernel.name)] -= ms
    return {name: ms for name, ms in parts.items() if ms > 0}


def profile_step(policy, plain, step, out_dir: Path) -> None:
    """torch.profiler tables of three steps of the kernel path and of the
    plain path, and each one's device time a step by part (STEP_PARTS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    for name, p in (("step", policy), ("plain_step", plain)):
        step(p)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step(p)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        (out_dir / f"{name}_profile.txt").write_text(table)
        parts = step_parts(prof, 3)
        total = sum(parts.values())
        log(f"  {name}: profile of 3 steps in {out_dir / f'{name}_profile.txt'}; device time a step {total:.2f} ms: "
            + ", ".join(f"{part} {ms:.2f} ms ({ms / total:.1%})" for part, ms in parts.items()))


# ---------------------------------------------------------------------------
# the device mesh (phase 14)

# Phase 14 runs FastVLA-0.5B (phase 3's step) and FastVLM-0.5B (phase 5's
# 1024-px model) on meshes of one card: one rank (nccl) and two ranks sharing
# the card (gloo on CUDA tensors, by the backend rule of parallel/mesh.py).
# Two ranks on one card share it: their times are recorded, never read as
# scaling. Greedy agreement of the TP-2 generation and paged server with the
# one-rank run: PAR_GEN requests of serve_stream, PAR_NEW new tokens each.
# The two groups' prefill logits agree within SERVE_LOGITS_REL_L2, the limit
# phase 5 holds two programs' logits of one state to; each first divergence
# of the greedy tokens must be a near-tie: the two tokens' logits within the
# largest prefill logit difference.
PAR_GEN, PAR_NEW, PAR_TIMED = 16, 16, 3
PAR_SERVER = dict(num_slots=PAR_GEN, prefill_batch=8, prompt_len=SERVE["prompt_len"], max_new_tokens=PAR_NEW,
                  page_size=SERVE["page_size"])
# Collectives the two-rank gloo group runs on CUDA tensors (TP's and DP's
# first three, FSDP's last two) and the pipeline's point-to-point shift
# (batch_isend_irecv: under gloo through pinned host copies, by the backend
# rule of parallel/pipeline.py); one that fails fails the phase.
PAR_COLLECTIVES = ("all_reduce", "all_gather", "broadcast", "all_gather_into_tensor", "reduce_scatter_tensor",
                   "batch_isend_irecv")
# The GPipe pipeline (parallel/pipeline.py) of the Qwen2-0.5B decoder at its
# full width and depth (24 layers, hidden 896, 14 query and 2 KV heads,
# head_dim 64), bf16 over fp32 parameters, weights from the seed: batch 16
# at the 1024-px policy's decoder length (256 image + 64 text tokens,
# FLASH_LOOP's T = 320), 2 and 4 microbatches, on one rank (nccl) and on two
# ranks sharing the card (gloo). The hidden states against the unpipelined
# forward within SERVE_LOGITS_REL_L2; PIPE_STEPS AdamW steps (the yaml's lr
# and weight decay, remat, the MSE loss in fp32) whose first gradients match
# the unpipelined step's jointly within TRAIN_REL_L2, and every leaf within
# TRAIN_FP32_REL_L2 in fp32 at PIPE_FP32_BATCH.
PIPE_BATCH, PIPE_T, PIPE_MICRO, PIPE_STEPS, PIPE_FP32_BATCH = 16, N_IMG + TEXT_LEN, (2, 4), 3, 4
PIPE_HIDDEN = 896


def par_p50(fn, iters: int = PAR_TIMED) -> dict:
    """p50, min and max of ``fn`` in ms over ``iters`` synchronized calls, after one more."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(p50_ms=statistics.median(times), min_ms=min(times), max_ms=max(times))


def par_collectives() -> list:
    """Run each collective of the phase once on CUDA tensors in the group;
    returns their names (a collective the backend lacks raises)."""
    import torch
    import torch.distributed as dist

    n, dev = dist.get_world_size(), torch.device("cuda", torch.cuda.current_device())
    x = torch.ones(4, device=dev)
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(n)], x),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(torch.empty(4 * n, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(torch.empty(4, device=dev),
                                                                    torch.ones(4 * n, device=dev)),
        "batch_isend_irecv": lambda: [w.wait() for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.cpu().pin_memory(), (dist.get_rank() + 1) % n),
            dist.P2POp(dist.irecv, torch.empty(4).pin_memory(), (dist.get_rank() - 1) % n)])],
    }
    for name in PAR_COLLECTIVES:
        ops[name]()
    torch.cuda.synchronize()
    return list(PAR_COLLECTIVES)


def par_policy(policy, mesh, images, states, tasks, label: str) -> dict:
    """The policy step through ``ShardedPolicyRuntime`` on ``mesh``: actions,
    this rank's launches of one forward (24 flash and 38 RepMixer each rank,
    on its share of the rows or heads) and the p50 step."""
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.serving import ShardedPolicyRuntime

    runtime = ShardedPolicyRuntime(policy, mesh)
    reset_launch_counts()
    actions = runtime.forward(images, states, tasks)
    torch.cuda.synchronize()
    counts = launch_counts()
    expect = {"flash_attention": FLASH_A_FORWARD, "repmixer_block": REPMIXER_A_FORWARD, "paged_attention": 0,
              "paged_attention_window": 0}
    if counts != expect:
        fail(f"{label}: launches of one rank-forward {counts} != {expect}")
    if tuple(actions.shape) != (BATCH, 14) or not torch.isfinite(actions).all():
        fail(f"{label}: actions {tuple(actions.shape)} finite={bool(torch.isfinite(actions).all())}")
    timed = par_p50(lambda: runtime.forward(images, states, tasks))
    return dict(actions=actions.float().cpu().numpy(), launches=counts, **timed)


def par_tokens(model, mesh, reqs) -> dict:
    """Greedy tokens of ``sharded_generate`` over the requests as one batch,
    of a paged server on ``mesh`` (``decode_impl`` "auto": "gathered"), and
    the prefill's last logits of the batch."""
    import numpy as np
    import torch

    from vla_fastvlm_tpu_torch.models.qwen2 import init_kv_cache
    from vla_fastvlm_tpu_torch.parallel.sharding import rank_text_config
    from vla_fastvlm_tpu_torch.serving import PagedGenerationServer, sharded_generate

    ids, mask, images = (np.concatenate([r[j] for r in reqs]) for j in range(3))
    t0 = time.perf_counter()
    gen = sharded_generate(model, None, images, ids, mask, mesh, max_new_tokens=PAR_NEW, eos_token_id=-1)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    with torch.no_grad():
        dev = next(model.parameters()).device
        cache = init_kv_cache(rank_text_config(model), len(reqs), N_IMG + ids.shape[1] + 1, device=dev)
        logits = model.prefill(*(torch.from_numpy(a).to(dev) for a in (images, ids, mask)), cache)[0]
    server = PagedGenerationServer(model, mesh=mesh, eos_token_id=-1, temperature=0.0, seed=SEED, **PAR_SERVER)
    if server.decode_impl != "gathered":
        fail(f"paged server on a mesh: decode_impl {server.decode_impl!r}, expected 'gathered'")
    rids = [server.submit(*r) for r in reqs]
    t0 = time.perf_counter()
    finished = server.run_to_completion()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    return dict(generate={i: [int(t) for t in row] for i, row in enumerate(gen.cpu().numpy())},
                server={i: finished[rid] for i, rid in enumerate(rids)}, logits=logits.float().cpu().numpy(),
                generate_s=gen_s, server_s=serve_s, ticks=server.ticks)


def par_rank() -> dict:
    """One of two ranks sharing the card: the phase's collectives, the policy
    at (2, 1) then (1, 2), generation and the paged server at (1, 2), and the
    FSDP train step at (2, 1). Rank 0 returns the results."""
    import torch
    import torch.distributed as dist

    from vla_fastvlm_tpu_torch.device import strict_fp32
    from vla_fastvlm_tpu_torch.parallel import make_mesh

    strict_fp32()
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    out = {"backend": dist.get_backend(), "collectives": par_collectives(), "seconds": laps}
    policy = build_policy("auto", "auto")
    images, states, tasks = policy_inputs()
    # DP leaves the model whole; TP then cuts it in place.
    out["dp2"] = par_policy(policy, make_mesh(2, 1), images, states, tasks, "(2, 1)")
    lap("policy (2, 1)")
    out["tp2"] = par_policy(policy, make_mesh(1, 2), images, states, tasks, "(1, 2)")
    lap("policy (1, 2)")
    del policy
    torch.cuda.empty_cache()
    out["tokens"] = par_tokens(serving_backbone().model, make_mesh(1, 2), serve_stream(n=PAR_GEN))
    lap("tokens (1, 2)")
    out["fsdp_dp2"] = par_train_step(make_mesh(2, 1))
    lap("FSDP step (2, 1)")
    torch.cuda.empty_cache()
    out["pipeline"] = pipe_cell(2)
    lap("pipeline (2 stages)")
    return out if dist.get_rank() == 0 else None


def par_train_step(mesh) -> dict:
    """One full-backbone ``Trainer`` step with ``fsdp=True`` at phase 4's
    settings (batch 8 at 512 px, dropout 0): loss, gradient norm, launches."""
    import torch

    from vla_fastvlm_tpu_torch.data import SyntheticAlohaSource
    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.parallel.sharding import is_fsdp_param
    from vla_fastvlm_tpu_torch.training import Trainer

    policy = train_policy(full=True, dropout=0.0)  # the same loss on one rank and on two
    batch = aloha_batch(SyntheticAlohaSource(num_samples=TRAIN_BATCH, image_hw=TRAIN_FRAME_HW, seed=SEED))
    trainer = Trainer(policy, [batch], None, train_config(ROOT / "build" / "parallel_smoke", max_steps=1, fsdp=True),
                      mesh=mesh)
    reset_launch_counts()
    metrics = trainer._train_step(trainer._place_batch(batch))
    torch.cuda.synchronize()
    counts = launch_counts()
    loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
    if not (torch.isfinite(torch.tensor([loss, norm])).all()):
        fail(f"FSDP step on {mesh}: loss {loss}, gradient norm {norm}")
    check_launches(f"FSDP step at {tuple(mesh.mesh.shape)}", counts, 1, flash_runs=2)
    return dict(loss=loss, grad_norm=norm, fsdp_leaves=sum(is_fsdp_param(p) for p in trainer._params),
                leaves=len(trainer._params))


def pipe_decoder(dtype):
    """Qwen2-0.5B's decoder at full width and depth on this rank's card,
    fp32 parameters from the seed, computing in ``dtype``."""
    import torch

    from vla_fastvlm_tpu_torch.models.layers import init_weights
    from vla_fastvlm_tpu_torch.models.qwen2 import Qwen2Model, qwen2_0_5b
    from vla_fastvlm_tpu_torch.parallel.mesh import local_device

    with torch.device(local_device()):
        model = Qwen2Model(qwen2_0_5b(dtype=dtype, param_dtype=torch.float32))
    init_weights(model, torch.Generator(device=local_device()).manual_seed(SEED))
    return model


def pipe_batch(batch: int):
    """Token ids, a mask (the image tokens and 4..64 text tokens of each row
    valid) and targets ~ N(0, 0.1^2) of the hidden states, alike on every rank."""
    import numpy as np
    import torch

    from vla_fastvlm_tpu_torch.parallel.mesh import local_device

    rng = np.random.default_rng(SEED)
    ids = rng.integers(3, 151_000, (batch, PIPE_T))
    lengths = N_IMG + rng.integers(4, TEXT_LEN + 1, batch)
    mask = (np.arange(PIPE_T)[None, :] < lengths[:, None]).astype(np.int32)
    targets = rng.standard_normal((batch, PIPE_T, PIPE_HIDDEN)).astype(np.float32) * 0.1
    return tuple(torch.from_numpy(a).to(local_device()) for a in (ids, mask, targets))


def pipe_loss(hidden, targets):
    """The pipeline's MSE loss, in fp32 (a bf16 loss rounds away a step's change)."""
    import torch

    return torch.mean(torch.square(hidden.float() - targets.float()))


def pipe_grads(model, ids, mask, targets) -> dict:
    """The unpipelined step's loss and gradients (the reference)."""
    import torch

    names, params = zip(*model.named_parameters())
    loss = pipe_loss(model(input_ids=ids, attention_mask=mask)[0], targets)
    return dict(loss=float(loss.detach()), grads=dict(zip(names, torch.autograd.grad(loss, params))))


def pipe_compare(what, got: dict, ref: dict, leaf_limit=None, joint_limit=None) -> dict:
    """Gathered pipelined gradients (CPU) against the reference (card): the
    joint relative L2 and the worst leaf's."""
    import torch

    if sorted(got) != sorted(ref):
        fail(f"{what}: gathered leaves {len(got)} differ from the unpipelined model's {len(ref)}")
    num = den = 0.0
    leaf = {}
    for name, r in ref.items():
        g = got[name].to(r.device).float()
        if not bool(torch.isfinite(g).all()):
            fail(f"{what}: non-finite gradient in {name}")
        num += float((g - r.float()).square().sum())
        den += float(r.float().square().sum())
        leaf[name] = rel_l2(g, r)
    worst = max(leaf, key=leaf.get)
    out = dict(joint_rel_l2=(num / den) ** 0.5, worst_leaf=worst, worst_leaf_rel_l2=leaf[worst], leaves=len(leaf))
    log(f"  {what}: gradients against the unpipelined step's: joint rel_l2 {out['joint_rel_l2']:.3e}, worst of "
        f"{len(leaf)} leaves {worst} {leaf[worst]:.3e}")
    if joint_limit is not None and not out["joint_rel_l2"] <= joint_limit:
        fail(f"{what}: joint gradient rel_l2 {out['joint_rel_l2']:.3e} beyond {joint_limit:g}")
    over = {n: e for n, e in leaf.items() if leaf_limit is not None and not e <= leaf_limit}
    if over:
        fail(f"{what}: {len(over)} gradient leaves beyond rel_l2 {leaf_limit:g}, e.g. {sorted(over.items())[:3]}")
    return out


def pipe_shared_equal(model, mesh) -> bool:
    """Whether ``embed_tokens`` and ``norm`` are bit-equal on every stage:
    the last stage's copies broadcast to the others and compared there."""
    import torch
    import torch.distributed as dist

    if mesh.size() == 1:
        return True
    same = True
    for name in ("embed_tokens.weight", "norm.weight"):
        mine = model.get_parameter(name).detach()
        theirs = mine.clone()
        dist.broadcast(theirs, int(mesh.mesh[-1]), group=mesh.get_group("pipe"))
        same &= torch.equal(mine, theirs)
    return same


def pipe_profile(what: str, fn, out_dir: Path, steps: int = 3) -> dict:
    """Device time a call of ``fn`` by part (``step_parts``) over ``steps``
    calls, its table written to ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    (out_dir / f"{what}_profile.txt").write_text(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    parts = step_parts(prof, steps)
    total = sum(parts.values())
    log(f"  {what}: device time a call {total:.2f} ms: "
        + ", ".join(f"{part} {v:.2f} ms ({v / total:.1%})" for part, v in parts.items()))
    return dict(device_ms=total, device_ms_by_part=parts)


def pipe_cell(stages: int, profile_dir: Path | None = None) -> dict:
    """The pipelined decoder on a pipe mesh of ``stages`` ranks (every rank
    calls it; stage 0 holds the unpipelined references and returns the
    numbers): forwards at PIPE_MICRO microbatches, launches, the train
    step's gradients, falling loss, equal replicated leaves, p50 times
    (with ``profile_dir``, device time by part), and the fp32 gradients at
    PIPE_FP32_BATCH."""
    import torch

    from vla_fastvlm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from vla_fastvlm_tpu_torch.parallel import gather_stages, make_pipe_mesh, make_pipeline_train_step, pipeline_forward

    t0 = time.perf_counter()
    mesh = make_pipe_mesh(stages)
    lead = mesh.get_local_rank("pipe") == 0
    per_stage = DECODER_LAYERS // stages
    out = {"stages": stages, "flash_launches": 0}
    model = pipe_decoder(torch.bfloat16)
    ids, mask, targets = pipe_batch(PIPE_BATCH)
    ref = None
    if lead:  # before placement drops the other stages' blocks
        with torch.no_grad():
            ref_hidden = model(input_ids=ids, attention_mask=mask)[0]
        ref = pipe_grads(model, ids, mask, targets)
    for n in PIPE_MICRO:
        reset_launch_counts()
        with torch.no_grad():
            hidden = pipeline_forward(model, ids, mask, mesh, n_microbatches=n)
        torch.cuda.synchronize()
        flash = launch_counts()["flash_attention"]
        if flash != per_stage * n:
            fail(f"pipeline at {stages} stages, {n} microbatches: {flash} flash launches a rank-forward, "
                 f"expected {per_stage * n}")
        out["flash_launches"] += flash
        entry = {"flash_launches": flash}
        if tuple(hidden.shape) != (PIPE_BATCH, PIPE_T, PIPE_HIDDEN) or not bool(torch.isfinite(hidden).all()):
            fail(f"pipeline at {stages} stages: hidden states {tuple(hidden.shape)} not finite or misshaped")
        if lead:
            entry["hidden_rel_l2"] = rel_l2(hidden, ref_hidden)
            log(f"  pipeline, {stages} stage(s), {n} microbatches: hidden states against the unpipelined "
                f"forward rel_l2 {entry['hidden_rel_l2']:.3e} (limit {SERVE_LOGITS_REL_L2:g}); {flash} flash "
                f"launches a rank-forward")
            if not entry["hidden_rel_l2"] <= SERVE_LOGITS_REL_L2:
                fail(f"pipeline at {stages} stages, {n} microbatches: hidden rel_l2 {entry['hidden_rel_l2']:.3e}")
        out[f"forward_micro{n}"] = entry
    @torch.no_grad()
    def forward():
        pipeline_forward(model, ids, mask, mesh, n_microbatches=PIPE_MICRO[0])

    out["forward"] = par_p50(forward)

    step, _ = make_pipeline_train_step(
        model, lambda params: torch.optim.AdamW(params, lr=TRAIN_LR, weight_decay=TRAIN_WD), mesh,
        n_microbatches=PIPE_MICRO[0], loss_fn=pipe_loss, remat=True)
    reset_launch_counts()
    losses = [float(step(ids, mask, targets))]
    torch.cuda.synchronize()
    # remat: each stage-tick's blocks run again in the backward (flash's own backward recomputes on the plain path).
    flash, want = launch_counts()["flash_attention"], 2 * per_stage * PIPE_MICRO[0]
    if flash != want:
        fail(f"pipeline train step at {stages} stages: {flash} flash launches a rank-step, expected {want}")
    out["flash_launches"] += flash
    out["train_flash_launches"] = flash
    grads = gather_stages(model, mesh, grads=True)
    if lead:
        out["first_loss_rel"] = abs(losses[0] - ref["loss"]) / abs(ref["loss"])
        out["bf16_grads"] = pipe_compare(f"pipeline train step, {stages} stage(s), bf16", grads, ref["grads"],
                                         joint_limit=TRAIN_REL_L2)
        if not out["first_loss_rel"] <= TRAIN_REL_L2:
            fail(f"pipeline train step: loss {losses[0]} against the unpipelined {ref['loss']}")
    del grads, ref
    equal = [pipe_shared_equal(model, mesh)]
    for _ in range(PIPE_STEPS - 1):
        losses.append(float(step(ids, mask, targets)))
        equal.append(pipe_shared_equal(model, mesh))
    out["losses"], out["shared_equal"] = losses, equal
    if not all(equal):
        fail(f"pipeline at {stages} stages: embed_tokens / norm differ across ranks after steps {equal}")
    if not losses[-1] < losses[0]:
        fail(f"pipeline at {stages} stages: the loss did not fall over {PIPE_STEPS} steps: {losses}")
    out["train_step"] = par_p50(lambda: step(ids, mask, targets))
    if profile_dir is not None:
        out["forward_profile"] = pipe_profile(f"pipeline_{stages}_forward", forward, profile_dir)
        out["train_step_profile"] = pipe_profile(f"pipeline_{stages}_train_step", lambda: step(ids, mask, targets),
                                                 profile_dir)
    del step, model, hidden, forward
    torch.cuda.empty_cache()

    model = pipe_decoder(torch.float32)
    ids, mask, targets = pipe_batch(PIPE_FP32_BATCH)
    ref = pipe_grads(model, ids, mask, targets) if lead else None
    step, _ = make_pipeline_train_step(model, lambda params: torch.optim.SGD(params, lr=0.0), mesh,
                                       n_microbatches=PIPE_MICRO[0], loss_fn=pipe_loss, remat=True)
    step(ids, mask, targets)
    grads = gather_stages(model, mesh, grads=True)
    if lead:
        out["fp32_grads"] = pipe_compare(f"pipeline train step, {stages} stage(s), fp32, batch {PIPE_FP32_BATCH}",
                                         grads, ref["grads"], leaf_limit=TRAIN_FP32_REL_L2)
    del step, model, grads, ref
    torch.cuda.empty_cache()
    out["seconds"] = round(time.perf_counter() - t0, 1)
    return out


def log_pipe_cell(cell: dict, card: str) -> None:
    log(f"  pipeline, {cell['stages']} stage(s): forward ({PIPE_MICRO[0]} microbatches) p50 "
        f"{cell['forward']['p50_ms']:.2f} ms (min {cell['forward']['min_ms']:.2f}, max "
        f"{cell['forward']['max_ms']:.2f}); train step p50 {cell['train_step']['p50_ms']:.2f} ms (min "
        f"{cell['train_step']['min_ms']:.2f}, max {cell['train_step']['max_ms']:.2f}); losses {cell['losses']}; "
        f"replicated leaves bit-equal after each step {cell['shared_equal']}; {cell['seconds']} s; {card}")


def phase_parallel(profile_dir: Path | None = None) -> dict:
    """Phase 14: the policy, the FSDP train step, generation and the paged
    server on one-rank and two-rank meshes of the card, and the pipeline
    (``profile_dir``: its one-rank forward and train step by part)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vla_fastvlm_tpu_torch.parallel import initialize_distributed, make_mesh, spawn_ranks

    log("[14/14] the device mesh: one rank (nccl) and two ranks sharing the card (gloo on CUDA tensors)")
    t_phase = time.perf_counter()
    initialize_distributed()
    result = {"one_rank_backend": dist.get_backend()}
    mesh = make_mesh(1, 1)

    # (a) one rank: the runtime against the unsharded policy, bit for bit.
    policy = build_policy("auto", "auto")
    images, states, tasks = policy_inputs()
    ref = policy.forward(images, states, tasks).float()
    one = par_policy(policy, mesh, images, states, tasks, "(1, 1)")
    same = bool(np.array_equal(one["actions"], ref.cpu().numpy()))
    log(f"  (1, 1) runtime against the unsharded policy: bit-equal {same}")
    if not same:
        fail("(1, 1): ShardedPolicyRuntime's actions differ from the unsharded policy's")
    result["one_rank"] = {k: v for k, v in one.items() if k != "actions"}
    del policy
    torch.cuda.empty_cache()
    result["fsdp_one_rank"] = par_train_step(mesh)
    log(f"  (1, 1) full-backbone Trainer step, fsdp=True: {json.dumps(result['fsdp_one_rank'])} (at data 1 "
        "FSDP shards nothing, JAX's rule)")
    torch.cuda.empty_cache()
    backbone = serving_backbone()
    reqs = serve_stream(n=PAR_GEN)
    base = par_tokens(backbone.model, mesh, reqs)
    torch.cuda.empty_cache()

    # The pipeline on one rank: the flash kernel at its microbatch shapes first.
    from vla_fastvlm_tpu_torch.ops.kernels import flash_attention, flash_attention_reference

    micro = [("bf16", PIPE_BATCH // n) for n in PIPE_MICRO] + [("fp32", PIPE_FP32_BATCH // PIPE_MICRO[0])]
    for kind, b in micro:
        q, k, v, kmask = flash_inputs(b, PIPE_T, 14, 2, 64, {"bf16": torch.bfloat16, "fp32": torch.float32}[kind])
        check_close(f"flash {kind} pipeline microbatch, batch {b}", flash_attention(q, k, v, kmask, True),
                    flash_attention_reference(q, k, v, kmask, True), TOL[("flash", kind)])
    result["pipeline_one_rank"] = pipe_cell(1, profile_dir)
    torch.cuda.empty_cache()

    # (b) two ranks on the card.
    t0 = time.perf_counter()
    two = spawn_ranks(par_rank, 2, device="cuda")
    result["two_ranks_s"] = round(time.perf_counter() - t0, 1)
    result["two_rank_backend"], result["collectives"] = two["backend"], two["collectives"]
    log(f"  two ranks: backend {two['backend']}; collectives run on CUDA tensors: {', '.join(two['collectives'])}; "
        f"seconds by part of rank 0: {two['seconds']}")
    for name in ("dp2", "tp2"):
        rel = rel_l2(torch.from_numpy(two[name]["actions"]), ref.cpu())
        if not rel <= POLICY_REL_L2:
            fail(f"{name}: actions differ from one rank's, rel_l2={rel:.3e}")
        result[name] = {k: v for k, v in two[name].items() if k != "actions"}
        result[name]["actions_rel_l2"] = rel
    logit_err = float(np.abs(two["tokens"]["logits"] - base["logits"]).max())
    logit_rel = rel_l2(torch.from_numpy(two["tokens"]["logits"]), torch.from_numpy(base["logits"]))
    result["tp2_prefill_logit_max_abs_err"], result["tp2_prefill_logit_rel_l2"] = logit_err, logit_rel
    log(f"  TP 2 prefill logits against one rank's: rel_l2 {logit_rel:.3e} (limit {SERVE_LOGITS_REL_L2:g}), "
        f"max |difference| {logit_err:.4f}")
    if not logit_rel <= SERVE_LOGITS_REL_L2:
        fail(f"TP 2 prefill logits differ from one rank's: rel_l2={logit_rel:.3e}")
    for kind in ("generate", "server"):
        got, want = two["tokens"][kind], base[kind]
        if any(len(got[i]) != PAR_NEW for i in got):
            fail(f"TP 2 {kind}: {[len(v) for v in got.values()]} tokens, expected {PAR_NEW} each")
        share = same_tokens(got, want)
        result[f"tp2_{kind}_token_share"] = share
        log(f"  TP 2 {kind}: greedy tokens equal to one rank's in {share:.4f} of positions "
            f"({two['tokens'][kind + '_s']:.2f} s against {base[kind + '_s']:.2f} s one rank)")
        report = divergence_report(backbone.model, reqs, got, want, logit_err, f"TP 2 {kind}")
        if report["within_logit_err"] != report["diverged"]:
            fail(f"TP 2 {kind}: {report['diverged'] - report['within_logit_err']} first divergences are no "
                 f"near-tie (the two tokens' logits {report['max_token_gap']:.4f} apart, more than the "
                 f"{logit_err:.4f} prefill logit difference)")
    result["fsdp_dp2"] = two["fsdp_dp2"]
    rel = abs(two["fsdp_dp2"]["loss"] - result["fsdp_one_rank"]["loss"]) / abs(result["fsdp_one_rank"]["loss"])
    if not rel <= TRAIN_REL_L2:
        fail(f"FSDP step at (2, 1): loss {two['fsdp_dp2']['loss']} against one rank's, rel {rel:.3e}")
    result["pipeline_two_ranks"] = two["pipeline"]
    result["pipeline_flash_launches"] = sum(result[k]["flash_launches"] for k in ("pipeline_one_rank",
                                                                                   "pipeline_two_ranks"))
    card = card_line()
    for name in ("one_rank", "dp2", "tp2"):
        r = result[name]
        log(f"  policy step {name}: p50 {r['p50_ms']:.2f} ms (min {r['min_ms']:.2f}, max {r['max_ms']:.2f}), "
            f"launches a rank-forward {r['launches']}; {card}")
    for name in ("pipeline_one_rank", "pipeline_two_ranks"):
        log_pipe_cell(result[name], card)
    dist.destroy_process_group()
    result["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log(json.dumps({"parallel": result}))
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", type=Path, default=None,
                        help="directory for torch.profiler tables of three policy steps (kernel and plain "
                             "paths, with device time by part) and of "
                             f"{IDLE_TICKS} decode ticks or verify rounds of each server")
    parser.add_argument("--only", choices=["flash", "repmixer", "paged", "train", "closed_loop", "serve", "surfaces",
                                           "lora", "quant", "hf", "parallel"],
                        default=None,
                        help="build, check and time one kernel family and nothing else (flash: the "
                             "flash-attention library, its checks, its times at the policy's, the 7B "
                             "heads' and the streamed shapes and by block shape; repmixer: "
                             "the RepMixer library, its checks against the plain version, its "
                             "per-width times; paged: the two paged-attention libraries, their "
                             "checks, their times at the 8 paged shapes and by part count; train: the "
                             "flash and RepMixer libraries and the training phase; closed_loop: the four "
                             "libraries, their checks and the closed-loop phase; serve: the RepMixer and paged "
                             "libraries, their checks and the serving-CLI phase; surfaces: the flash and RepMixer "
                             "libraries, their checks and the surfaces phase; lora: the four libraries, their checks "
                             "and the LoRA phase; quant: the four libraries, their checks and the weight-quantization "
                             "phase; hf: the four libraries, their checks and the HF-checkpoint phase; parallel: the "
                             "flash and RepMixer libraries, their checks and the device-mesh phase)")
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
    if args.only == "flash":
        phase_build(("flash_attention",))
        log("[2/14] flash-attention kernel against its plain version")
        err = check_flash()
        log("[13/14] flash-attention timing (CUDA graph replay between CUDA events)")
        r = time_flash(sweep=True)
        r["flash_attention"]["max_abs_err"] = err
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        log(json.dumps({"flash": r}))
        return 0
    if args.only == "repmixer":
        phase_build(("repmixer",))
        log("[2/14] RepMixer kernel against its plain version")
        err = check_repmixer()
        log("[13/14] RepMixer timing (CUDA graph replay between CUDA events)")
        r = time_repmixer()
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        log(json.dumps({"repmixer_block": dict(r, max_abs_err=err)}))
        return 0
    if args.only == "train":
        phase_build(("flash_attention", "repmixer"))
        log("[2/14] flash-attention and RepMixer kernels against their plain versions")
        check_flash()
        check_repmixer()
        if args.profile is not None:
            args.profile.mkdir(parents=True, exist_ok=True)
        phase_train(args.profile)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if args.only == "closed_loop":
        phase_build()
        phase_kernels()
        if args.profile is not None:
            args.profile.mkdir(parents=True, exist_ok=True)
        log_loop_summaries(phase_closed_loop(args.profile))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if args.only == "serve":
        phase_build(("repmixer", "paged_attention", "paged_window"))
        log("[2/14] RepMixer and paged-attention kernels against their plain versions")
        check_repmixer()
        check_paged()
        if args.profile is not None:
            args.profile.mkdir(parents=True, exist_ok=True)
        log_serve_cli_summaries(phase_serve_cli(make_servers()[0], args.profile))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if args.only == "surfaces":
        phase_build(("flash_attention", "repmixer"))
        log("[2/14] flash-attention and RepMixer kernels against their plain versions")
        check_flash()
        check_repmixer()
        phase_surfaces()
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if args.only == "lora":
        phase_build()
        phase_kernels()
        if args.profile is not None:
            args.profile.mkdir(parents=True, exist_ok=True)
        phase_lora(args.profile)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if args.only == "quant":
        phase_build()
        phase_kernels()
        if args.profile is not None:
            args.profile.mkdir(parents=True, exist_ok=True)
        phase_quant(args.profile)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if args.only == "hf":
        phase_build()
        phase_kernels()
        phase_hf()
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if args.only == "parallel":
        phase_build(("flash_attention", "repmixer"))
        log("[2/14] flash-attention and RepMixer kernels against their plain versions")
        check_flash()
        check_repmixer()
        if args.profile is not None:
            args.profile.mkdir(parents=True, exist_ok=True)
        phase_parallel(args.profile)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}))
        return 0
    if args.only == "paged":
        phase_build(("paged_attention", "paged_window"))
        log("[2/14] paged-attention kernels against their plain versions")
        errs = check_paged()
        log("[13/14] paged-attention timing (CUDA graph replay between CUDA events)")
        r = time_paged(sweep=True)
        for name in errs:
            r[name]["max_abs_err"] = errs[name]
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        log(json.dumps({"paged": r}))
        return 0
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        log(f"  {name}: {phase_s[name]} s (total {time.perf_counter() - t_start:.1f} s)")
        return out

    timed("build", phase_build)
    errs = timed("kernels", phase_kernels)
    policy, plain, step, counts = timed("policy", phase_policy)
    if args.profile is not None:
        args.profile.mkdir(parents=True, exist_ok=True)
    timed("train", phase_train, args.profile)
    torch.cuda.empty_cache()  # the training phase's blocks, before the 7B target's
    summaries, serve_counts, model_05b = timed("serving", phase_serving, args.profile)
    spec_summaries, spec_counts = timed("speculative", phase_speculative, model_05b, args.profile)
    cli_summaries = timed("serve_cli", phase_serve_cli, model_05b, args.profile)
    del model_05b
    loop_summaries = timed("closed_loop", phase_closed_loop, args.profile)
    torch.cuda.empty_cache()
    timed("surfaces", phase_surfaces)
    torch.cuda.empty_cache()
    timed("lora", phase_lora, args.profile, cli_summaries, spec_summaries.get("self_draft"))
    torch.cuda.empty_cache()
    timed("quant", phase_quant, args.profile)
    torch.cuda.empty_cache()
    timed("hf", phase_hf)
    torch.cuda.empty_cache()
    timings = timed("timing", phase_timing, policy, plain, step)
    if args.profile is not None:
        profile_step(policy, plain, step, args.profile)
    del policy, plain, step
    torch.cuda.empty_cache()
    parallel = timed("parallel", phase_parallel, args.profile)
    log(f"seconds per phase: {phase_s}")

    # name: (source, TPU kernel it replaces, launches on its main path's run; flash: the policy
    # step's and the pipeline's checked forwards and first train steps, phase 14)
    meta = {
        "flash_attention": ("vla_fastvlm_tpu_torch/csrc/flash_attention.cu",
                            "vla_fastvlm_tpu/ops/pallas/flash_attention.py:51",
                            counts["flash_attention"] + parallel["pipeline_flash_launches"]),
        "repmixer_block": ("vla_fastvlm_tpu_torch/csrc/repmixer.cu",
                           "vla_fastvlm_tpu/ops/pallas/repmixer.py:67", counts["repmixer_block"]),
        "paged_attention": ("vla_fastvlm_tpu_torch/csrc/paged_attention.cu",
                            "vla_fastvlm_tpu/ops/pallas/paged_attention.py:65",
                            serve_counts["kernel"]["paged_attention"]),
        "paged_attention_int8": ("vla_fastvlm_tpu_torch/csrc/paged_attention.cu",
                                 "vla_fastvlm_tpu/ops/pallas/paged_attention.py:96",
                                 serve_counts["kernel_int8"]["paged_attention"]),
        "paged_attention_window": ("vla_fastvlm_tpu_torch/csrc/paged_window.cu",
                                   "vla_fastvlm_tpu/ops/pallas/paged_attention.py:140",
                                   spec_counts["spec_kernel"]["paged_attention_window"]),
        "paged_attention_window_int8": ("vla_fastvlm_tpu_torch/csrc/paged_window.cu",
                                        "vla_fastvlm_tpu/ops/pallas/paged_attention.py:140",
                                        spec_counts["spec_kernel_int8"]["paged_attention_window"]),
    }
    for name, summary in summaries.items():
        log(f"serve {name}: tokens/s {summary['tokens_per_sec']:.1f}, p50 tick {summary['p50_tick_ms']:.2f} ms, "
            f"ticks {summary['ticks']}, device idle share {summary['device_idle_share']}")
    for name, summary in spec_summaries.items():
        extra = "" if "tokens_per_tick" not in summary else (
            f", tokens_per_tick {summary['tokens_per_tick']:.3f}, "
            f"tokens per slot and round {summary['tokens_per_slot_round']:.3f}")
        log(f"serve {name}: tokens/s {summary['tokens_per_sec']:.1f}, p50 round {summary['p50_tick_ms']:.2f} ms, "
            f"rounds {summary['ticks']}, admissions {summary['admissions']}{extra}, "
            f"device idle share {summary['device_idle_share']}")
    log_serve_cli_summaries(cli_summaries)
    log_loop_summaries(loop_summaries)
    kernels = []
    for name, (source, replaces, launches) in meta.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{k: t[k] for k in ("kernel_ms", "splits") if k in t},
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
