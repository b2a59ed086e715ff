"""LeRobot-registered config for ``policy.type=fastvla`` (counterpart of
``vla_fastvlm_tpu/lerobot_fastvla/configuration_fastvla.py``).

The field schema (names, defaults, order) and the registered type name are
those of the JAX plugin: the chunking interface, the normalization map, the
AdamW and cosine-with-warmup presets, the visual + state feature
requirement, the delta indices, and the two knobs at the end,
``image_token_mode`` and ``jax_dtype``. ``jax_dtype`` keeps its name so that
a config saved by either plugin loads in the other; here it names the
policy's compute dtype ("float32", "bfloat16"), the parameters staying fp32.

Importable only where LeRobot is installed (the plugin host).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

try:
    from lerobot.configs.policies import PreTrainedConfig
    from lerobot.configs.types import FeatureType, NormalizationMode
    from lerobot.optim.optimizers import AdamWConfig
    from lerobot.optim.schedulers import CosineDecayWithWarmupSchedulerConfig
except ImportError as exc:
    raise ImportError(
        "vla_fastvlm_tpu_torch.lerobot_fastvla requires the `lerobot` package "
        "(the plugin host). For LeRobot-free use, import the core policy "
        "from vla_fastvlm_tpu_torch.fastvla instead."
    ) from exc

_APPLE_05B = "apple/FastVLM-0.5B"


def _default_normalization() -> Dict[str, "NormalizationMode"]:
    # Camera frames pass through (the backbone letterboxes and rescales them);
    # proprioception and actions are z-scored with the dataset's statistics.
    modes = {"VISUAL": "IDENTITY", "STATE": "MEAN_STD", "ACTION": "MEAN_STD"}
    return {key: NormalizationMode[value] for key, value in modes.items()}


@PreTrainedConfig.register_subclass("fastvla")
@dataclasses.dataclass
class FastVLAConfig(PreTrainedConfig):
    """LeRobot-compatible FastVLA policy config."""

    # Chunking interface of LeRobot's rollout loop; chunk_size 1 is one
    # VLM forward per env step.
    n_obs_steps: int = 1
    chunk_size: int = 1
    n_action_steps: int = 1

    normalization_mapping: Dict[str, "NormalizationMode"] = dataclasses.field(
        default_factory=_default_normalization
    )

    # FastVLM backbone selection (preset id or local dir) and freezing.
    vlm_model_name: str = _APPLE_05B
    bootstrap_model_name: str = _APPLE_05B
    freeze_backbone: bool = True

    # Action-head MLP dimensions; state_dim / action_dim are fallbacks that
    # the policy overrides from the dataset's feature shapes.
    state_dim: int = 14
    action_dim: int = 14
    hidden_dim: int = 1024
    fusion_dim: int = 1024
    dropout: float = 0.1

    # Text and image preprocessing knobs forwarded to the backbone.
    tokenizer_max_length: int = 64
    tokenizer_padding_side: str = "right"
    pad_to_max_length: bool = False
    resize_with_padding: bool = True
    image_size: Optional[int] = None
    pad_value: float = 0.0
    add_trailing_newline: bool = True

    # AdamW preset consumed by lerobot-train.
    optimizer_lr: float = 1e-4
    optimizer_betas: Tuple[float, float] = (0.9, 0.95)
    optimizer_eps: float = 1e-8
    optimizer_weight_decay: float = 1e-4
    optimizer_grad_clip_norm: float = 1.0

    # Cosine-with-warmup preset consumed by lerobot-train.
    scheduler_warmup_steps: int = 500
    scheduler_decay_steps: int = 20_000
    scheduler_decay_lr: float = 2.5e-6

    # Knobs of the JAX plugin, kept by name: the image-token mode and the
    # compute dtype.
    image_token_mode: str = "prefix"
    jax_dtype: str = "float32"

    def __post_init__(self):
        super().__post_init__()
        if self.n_action_steps > self.chunk_size:
            raise ValueError(
                f"n_action_steps ({self.n_action_steps}) cannot exceed "
                f"chunk_size ({self.chunk_size}): the action queue is "
                "refilled from one predicted chunk."
            )

    def validate_features(self) -> None:
        if not self.input_features:
            return
        present = {feature.type for feature in self.input_features.values()}
        for required, label in ((FeatureType.VISUAL, "visual observation"),
                                (FeatureType.STATE, "state observation")):
            if required not in present:
                raise ValueError(f"FastVLA requires at least one {label} feature.")

    def get_optimizer_preset(self) -> "AdamWConfig":
        return AdamWConfig(
            lr=self.optimizer_lr,
            betas=self.optimizer_betas,
            eps=self.optimizer_eps,
            weight_decay=self.optimizer_weight_decay,
            grad_clip_norm=self.optimizer_grad_clip_norm,
        )

    def get_scheduler_preset(self) -> "CosineDecayWithWarmupSchedulerConfig":
        return CosineDecayWithWarmupSchedulerConfig(
            peak_lr=self.optimizer_lr,
            decay_lr=self.scheduler_decay_lr,
            num_warmup_steps=self.scheduler_warmup_steps,
            num_decay_steps=self.scheduler_decay_steps,
        )

    @property
    def observation_delta_indices(self) -> List[int]:
        return [0]

    @property
    def action_delta_indices(self) -> List[int]:
        return list(range(self.chunk_size))

    @property
    def reward_delta_indices(self) -> None:
        return None
