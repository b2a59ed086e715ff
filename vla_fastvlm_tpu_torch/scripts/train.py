"""Training CLI of the port (twin of the repository's ``scripts/train.py``).

    python -m vla_fastvlm_tpu_torch.scripts.train --synthetic-data --max-steps 10
    python -m vla_fastvlm_tpu_torch.scripts.train --config configs/train_aloha.yaml --synthetic-data

Same ``TrainArgs`` flags as the JAX script, as ``--kebab-case`` flags (``utils/cli.py``),
and the same flow: config -> policy -> datasets -> ``Trainer.fit()``, eval tolerating
an unknown split. ``--synthetic-data`` trains on ``SyntheticAlohaSource`` records
(offline). Flags of the port: ``--device`` (``cuda`` by default; the script raises
without CUDA unless ``--device cpu``) and ``--train-backbone`` (with
``--no-freeze-backbone``: the whole policy trains, through the kernels' backward,
decoder blocks rematerialized). ``--lora-rank N`` (``--lora-alpha``) trains LoRA
adapters on the decoder's projections over the frozen base (``io/lora.py``;
decoder blocks rematerialized), with the head for the MLP head, alone for the
token head; checkpoints carry them as the ``"lora"`` tree, for ``scripts.serve
--lora-dir`` and ``scripts.merge_lora``. ``--action-head token`` trains the
action-token policy (``FastVLMTokenPolicy``), which has no head and trains with
``--lora-rank`` or ``--train-backbone``, as in JAX. ``--quantization
int8|int4|w8a8`` quantizes the frozen base (``io/quantize.py``): with
``--lora-rank`` that is QLoRA, float adapters over int8 or int4 codes; with
``--train-backbone`` it raises, as in JAX. An int4 policy's checkpoint
cannot be written (safetensors has no int4), as in JAX. ``--dp`` / ``--tp``
train on a ("data", "model") mesh (``Trainer(mesh=...)``; ``--dp -1``
absorbs the ranks ``--tp`` leaves) and ``--fsdp`` shards parameters,
gradients and AdamW state over ``data``: under ``torchrun`` on its ranks,
else on ``dp * tp`` ranks the command starts itself. ``--batch-size`` is
the global batch; rank 0 writes logs and checkpoints.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ..data import AlohaDataset, AlohaIterableDataset, SyntheticAlohaSource, create_aloha_dataloader
from ..fastvla import FastVLAConfig, FastVLAPolicy, FastVLMTokenPolicy
from ..io.presets import resolve_fastvlm_config
from ..parallel import cli_mesh, needs_own_ranks, spawn_ranks
from ..parallel.sharding import tp_text_config
from ..training import Trainer, TrainingConfig
from ..utils import configure_logging, parse_cli

logger = logging.getLogger(__name__)


@dataclass
class TrainArgs:
    output_dir: str = "outputs/train/aloha_fastvlm"
    dataset_repo_id: str = "lerobot/aloha_sim_insertion_human_image"
    train_split: str = "train"
    eval_split: Optional[str] = "validation"
    streaming: bool = False
    limit_train_samples: Optional[int] = None
    limit_eval_samples: Optional[int] = 1024
    batch_size: int = 4
    eval_batch_size: int = 4
    num_workers: int = 4

    model_id: str = "apple/FastVLM-0.5B"
    bootstrap_model_id: str = "apple/FastVLM-0.5B"
    freeze_backbone: bool = True
    hidden_dim: int = 1024
    fusion_dim: int = 1024
    dropout: float = 0.1
    image_size: Optional[int] = None
    resize_with_padding: bool = True
    pad_value: float = 0.0
    tokenizer_max_length: int = 64
    tokenizer_padding_side: str = "right"
    pad_to_max_length: bool = False

    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    num_epochs: int = 5
    max_steps: Optional[int] = None
    gradient_accumulation_steps: int = 1
    logging_steps: int = 50
    eval_steps: int = 500
    save_steps: int = 1000
    mixed_precision: Optional[str] = "bf16"
    seed: int = 42

    state_dim: int = 14
    action_dim: int = 14
    dtype: str = "float32"
    image_token_mode: str = "prefix"
    synthetic_data: bool = False
    synthetic_samples: int = 64
    synthetic_image_size: int = 64
    # The card unless "cpu" is asked for.
    device: str = "cuda"
    # Train the backbone too (with --no-freeze-backbone).
    train_backbone: bool = False
    # Mesh axes: dp (-1 absorbs the ranks tp leaves) x tp.
    dp: int = -1
    tp: int = 1
    fsdp: bool = False
    lora_rank: int = 0
    lora_alpha: Optional[float] = None
    quantization: str = "none"
    action_head: str = "mlp"
    action_bins: int = 256
    action_token_low: float = -1.0
    action_token_high: float = 1.0


def main(args: TrainArgs) -> None:
    world = max(args.dp, 1) * args.tp
    if needs_own_ranks(world):
        if args.batch_size % max(args.dp, 1):
            raise ValueError(f"batch {args.batch_size} not divisible by data-parallel size {args.dp}")
        tp_text_config(resolve_fastvlm_config(args.model_id, args.bootstrap_model_id)[0].text, args.tp)
        return spawn_ranks(main, world, args, device=args.device)
    mesh, device = cli_mesh(args.dp, args.tp, args.device)
    configure_logging()
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)

    policy_config = FastVLAConfig(
        vlm_model_name=args.model_id,
        bootstrap_model_name=args.bootstrap_model_id,
        freeze_backbone=args.freeze_backbone,
        train_backbone=args.train_backbone,
        state_dim=args.state_dim,
        action_dim=args.action_dim,
        hidden_dim=args.hidden_dim,
        fusion_dim=args.fusion_dim,
        dropout=args.dropout,
        image_size=args.image_size,
        resize_with_padding=args.resize_with_padding,
        pad_value=args.pad_value,
        tokenizer_max_length=args.tokenizer_max_length,
        tokenizer_padding_side=args.tokenizer_padding_side,
        pad_to_max_length=args.pad_to_max_length,
        dtype=args.dtype,
        param_dtype=args.dtype if args.dtype != "bfloat16" else "float32",
        image_token_mode=args.image_token_mode,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        quantization=args.quantization,
        action_head=args.action_head,
        action_bins=args.action_bins,
        action_token_low=args.action_token_low,
        action_token_high=args.action_token_high,
        seed=args.seed,
    )
    policy_cls = FastVLMTokenPolicy if args.action_head == "token" else FastVLAPolicy
    policy = policy_cls(policy_config, device=device)

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
    if args.streaming and not args.synthetic_data:
        train_dataset = AlohaIterableDataset(split=args.train_split, repo_id=args.dataset_repo_id)
    else:
        train_dataset = AlohaDataset(
            split=args.train_split, repo_id=args.dataset_repo_id,
            limit_samples=args.limit_train_samples, source=synthetic,
        )
    train_loader = create_aloha_dataloader(
        train_dataset, batch_size=args.batch_size, shuffle=not args.streaming, num_workers=args.num_workers,
    )

    eval_loader = None
    if args.eval_split:
        try:
            if args.streaming and not args.synthetic_data:
                eval_dataset = AlohaIterableDataset(split=args.eval_split, repo_id=args.dataset_repo_id)
            else:
                eval_dataset = AlohaDataset(
                    split=args.eval_split, repo_id=args.dataset_repo_id,
                    limit_samples=args.limit_eval_samples, source=synthetic,
                )
            eval_loader = create_aloha_dataloader(
                eval_dataset, batch_size=args.eval_batch_size, shuffle=False, num_workers=args.num_workers,
            )
        except ValueError as exc:
            if "Unknown split" not in str(exc):
                raise
            logger.warning("Eval split '%s' not found for dataset %s; continuing without evaluation.",
                           args.eval_split, args.dataset_repo_id)

    trainer_config = TrainingConfig(
        output_dir=args.output_dir,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        num_epochs=args.num_epochs,
        max_steps=args.max_steps,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        logging_steps=args.logging_steps,
        eval_steps=args.eval_steps,
        save_steps=args.save_steps,
        mixed_precision=args.mixed_precision,
        seed=args.seed,
        fsdp=args.fsdp,
    )
    Trainer(model=policy, train_dataloader=train_loader, eval_dataloader=eval_loader, config=trainer_config,
            mesh=mesh).fit()


if __name__ == "__main__":
    main(parse_cli(TrainArgs, prog="python -m vla_fastvlm_tpu_torch.scripts.train"))
