"""Offline dataset evaluation CLI of the port (twin of the repository's
``scripts/eval_dataset.py``).

    python -m vla_fastvlm_tpu_torch.scripts.eval_dataset --checkpoint-dir outputs/train/aloha_fastvlm/checkpoints/step-1000
    python -m vla_fastvlm_tpu_torch.scripts.eval_dataset --checkpoint-dir CKPT --synthetic-data --state-dim 14 --action-dim 14

The same ``EvalArgs`` flags as the JAX script, as ``--kebab-case`` flags
(``utils/cli.py``), and the same flow: the checkpoint through
``load_policy_from_checkpoint`` (FastVLA MLP head, action-token head or the
legacy ``FastVLMPolicy``), the split falling back to "train" when it is
unknown and ``--allow-missing-split`` holds, then the sample-weighted mean
of every scalar the policy's ``compute_loss`` reports, printed as JAX prints
it: ``MSE on split '<split>': <mse>`` and, for the other metrics (the token
head's loss, token accuracy and ``binning_floor_mse``, the MSE of encoding
and decoding the targets), ``Additional metrics on split '<split>': {...}``.
``--synthetic-data`` scores ``SyntheticAlohaSource`` records made from
``--seed`` (the training script's default, 42: the records training saw).
``--device`` is the card unless ``--device cpu`` is given; without CUDA the
script raises. There is no compilation cache to enable: PyTorch runs eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from ..data import AlohaDataset, AlohaIterableDataset, SyntheticAlohaSource, create_aloha_dataloader
from ..device import move_batch_to_device, resolve_device
from ..io.checkpoint import load_policy_from_checkpoint
from ..utils import configure_logging, parse_cli


@dataclass
class EvalArgs:
    checkpoint_dir: str = "outputs/train/aloha_fastvlm/checkpoints/step-1000"
    dataset_repo_id: str = "lerobot/aloha_sim_insertion_human_image"
    split: str = "validation"
    allow_missing_split: bool = True
    streaming: bool = False
    batch_size: int = 8
    num_workers: int = 4
    limit_samples: Optional[int] = None

    synthetic_data: bool = False
    synthetic_samples: int = 64
    synthetic_image_size: int = 64
    state_dim: int = 14
    action_dim: int = 14
    # The synthetic records are made from this seed: keep the training run's.
    seed: int = 42
    # The card unless "cpu" is asked for.
    device: str = "cuda"


def _build_dataset(args: EvalArgs):
    synthetic = (
        SyntheticAlohaSource(
            num_samples=args.synthetic_samples,
            image_hw=(args.synthetic_image_size, args.synthetic_image_size),
            state_dim=args.state_dim,
            action_dim=args.action_dim,
            seed=args.seed,
        )
        if args.synthetic_data
        else None
    )
    # An in-memory source ignores the split: these are the records training saw.
    resolved_split = "synthetic(train-records)" if args.synthetic_data else args.split

    def make(split):
        if args.streaming and not args.synthetic_data:
            return AlohaIterableDataset(split=split, repo_id=args.dataset_repo_id)
        return AlohaDataset(split=split, repo_id=args.dataset_repo_id, limit_samples=args.limit_samples,
                            source=synthetic)

    try:
        dataset = make(args.split)
    except ValueError as exc:
        if args.allow_missing_split and "Unknown split" in str(exc):
            resolved_split = "train"
            dataset = make(resolved_split)
            print(f"[eval_dataset] Split '{args.split}' not found; using '{resolved_split}' instead.")
        else:
            raise
    return dataset, resolved_split


def main(args: EvalArgs) -> Dict[str, Any]:
    """Print the split's MSE (and the other metrics); return them with the
    split, the sample count and the device."""
    device = resolve_device(args.device)
    configure_logging()
    policy, device = load_policy_from_checkpoint(args.checkpoint_dir, device=device)

    dataset, resolved_split = _build_dataset(args)
    dataloader = create_aloha_dataloader(dataset, batch_size=args.batch_size, shuffle=False,
                                         num_workers=args.num_workers)

    # Sample-weighted sums of every scalar compute_loss reports; for the token
    # head also the binning floor, the best MSE any predictor of discretized
    # actions reaches: the targets' encode -> decode round trip.
    totals: Dict[str, float] = {}
    total_samples = 0
    action_tokenizer = getattr(policy, "tokenizer", None)
    for batch in dataloader:
        outputs = policy.compute_loss(move_batch_to_device(batch, device))
        n = batch["actions"].shape[0]
        for key, value in outputs.items():
            totals[key] = totals.get(key, 0.0) + float(value) * n
        if action_tokenizer is not None:
            acts = np.asarray(batch["actions"], np.float32).reshape(n, -1)
            rt = action_tokenizer.decode(action_tokenizer.encode(acts))
            totals["binning_floor_mse"] = totals.get("binning_floor_mse", 0.0) + float(np.mean(np.square(rt - acts))) * n
        total_samples += n

    mse = totals.get("mse", 0.0) / max(total_samples, 1)
    print(f"MSE on split '{resolved_split}': {mse:.6f}")
    extras = {key: round(value / max(total_samples, 1), 6) for key, value in sorted(totals.items()) if key != "mse"}
    if extras:
        print(f"Additional metrics on split '{resolved_split}': {extras}")
    return {"split": resolved_split, "samples": total_samples, "mse": mse, **extras, "device": str(device)}


if __name__ == "__main__":
    main(parse_cli(EvalArgs, prog="python -m vla_fastvlm_tpu_torch.scripts.eval_dataset"))
