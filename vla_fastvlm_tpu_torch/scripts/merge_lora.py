"""Fold trained LoRA adapters into a deployable base checkpoint (twin of the
repository's ``scripts/merge_lora.py``).

    python -m vla_fastvlm_tpu_torch.scripts.merge_lora --checkpoint out/checkpoints/step-100 --output out/merged
    python -m vla_fastvlm_tpu_torch.scripts.merge_lora --device cpu --checkpoint CKPT --output OUT

A policy trained with ``--lora-rank`` saves its adapters in the checkpoint
(the ``"lora"`` tree of ``policy_state_dict.safetensors``). Serving can mount
them at run time (``scripts.serve --lora-dir``); when one adapter owns the
deployment, this folds it into the base so the served model has no delta to
add. Every adapted ``kernel`` becomes ``W + A @ B`` (``io/lora.py::merge_lora``:
the sum in fp32, cast back to the kernel's dtype), on the card unless
``--device cpu`` is given. The output is the same checkpoint layout without
the ``"lora"`` tree and with ``lora_rank = 0`` in its config, so loading it
mounts no fresh adapters. Prints and returns a JSON summary:
``merged_from``, ``output``, ``adapter_params``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from ..device import resolve_device
from ..io.checkpoint import load_policy_state, save_policy_checkpoint
from ..io.lora import lora_num_params, map_lora, merge_lora
from ..utils import configure_logging, parse_cli


@dataclass
class MergeArgs:
    # Policy checkpoint dir (policy_config.json + policy_state_dict.safetensors)
    # trained with lora_rank > 0.
    checkpoint: str = ""
    # Output checkpoint dir: same layout, adapters folded, lora_rank = 0.
    output: str = ""
    # The card unless "cpu" is asked for.
    device: str = "cuda"


def main(args: MergeArgs) -> dict:
    configure_logging()
    if not args.checkpoint or not args.output:
        raise SystemExit("--checkpoint and --output are required")
    device = resolve_device(args.device)
    config, params = load_policy_state(args.checkpoint)
    if "lora" not in params:
        raise SystemExit(f"{args.checkpoint} holds no 'lora' adapters (trained without --lora-rank?)")
    lora = params.pop("lora")
    backbone = map_lora(lambda t: t.to(device), params["backbone"])
    merged = merge_lora(backbone, map_lora(lambda t: t.to(device), lora))
    params["backbone"] = map_lora(lambda t: t.cpu(), merged)
    config = dict(config, lora_rank=0)
    save_policy_checkpoint(Path(args.output), config, params)
    summary = {"merged_from": args.checkpoint, "output": args.output, "adapter_params": lora_num_params(lora)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(parse_cli(MergeArgs, prog="python -m vla_fastvlm_tpu_torch.scripts.merge_lora"))
