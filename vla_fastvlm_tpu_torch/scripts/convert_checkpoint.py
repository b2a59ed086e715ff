"""Convert an Apple FastVLM (llava_qwen2) checkpoint to the policy checkpoint
format (twin of the repository's ``scripts/convert_checkpoint.py``).

    python -m vla_fastvlm_tpu_torch.scripts.convert_checkpoint --checkpoint-dir DIR --output-dir OUT
    python -m vla_fastvlm_tpu_torch.scripts.convert_checkpoint --device cpu --checkpoint-dir DIR --output-dir OUT

Reads a local HF checkpoint directory (``config.json`` + ``*.safetensors``),
converts the decoder and projector names and folds the vision tower
(``io/model_loader.py``), wraps them with a freshly initialized action head
(``FastVLAPolicy``, on the card unless ``--device cpu`` is given), and
writes ``policy_config.json`` + ``policy_state_dict.safetensors`` in the
JAX package's layout, which either package's ``load_policy_from_checkpoint``
and ``eval_dataset`` read. Returns the output directory.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from ..utils import configure_logging, parse_cli

logger = logging.getLogger(__name__)


@dataclass
class ConvertArgs:
    checkpoint_dir: str = "checkpoints/llava-fastvithd_0.5b_stage3"
    output_dir: str = "outputs/converted/fastvla_policy"
    state_dim: int = 14
    action_dim: int = 14
    hidden_dim: int = 1024
    fusion_dim: int = 1024
    image_size: Optional[int] = None
    dtype: str = "float32"
    # The card unless "cpu" is asked for.
    device: Optional[str] = None
    seed: int = 0


def main(args: ConvertArgs) -> str:
    configure_logging()

    from ..fastvla import FastVLAConfig, FastVLAPolicy
    from ..io.checkpoint import save_policy_checkpoint

    config = FastVLAConfig(
        vlm_model_name=args.checkpoint_dir,
        bootstrap_model_name=args.checkpoint_dir,
        state_dim=args.state_dim,
        action_dim=args.action_dim,
        hidden_dim=args.hidden_dim,
        fusion_dim=args.fusion_dim,
        image_size=args.image_size,
        dtype=args.dtype,
        param_dtype=args.dtype,
        seed=args.seed,
    )
    policy = FastVLAPolicy(config, device=args.device)  # loads + converts the checkpoint weights
    save_policy_checkpoint(args.output_dir, config, policy.jax_params(as_numpy=False))
    logger.info("Wrote converted policy checkpoint to %s", args.output_dir)
    return args.output_dir


if __name__ == "__main__":
    main(parse_cli(ConvertArgs, prog="python -m vla_fastvlm_tpu_torch.scripts.convert_checkpoint"))
