"""Checkpoint loading util (counterpart of ``vla_fastvlm_tpu/utils/checkpoint.py``);
the implementation lives in ``io/checkpoint.py``."""

from ..io.checkpoint import load_policy_from_checkpoint

__all__ = ["load_policy_from_checkpoint"]
