"""Training runtime of the port (counterpart of ``vla_fastvlm_tpu/training``)."""

from .schedule import clip_by_global_norm_, global_norm, linear_warmup_decay
from .trainer import Trainer, TrainingConfig

__all__ = ["Trainer", "TrainingConfig", "clip_by_global_norm_", "global_norm", "linear_warmup_decay"]
