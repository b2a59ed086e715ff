"""LeRobot pre/post processor pipelines of the fastvla plugin (counterpart of
``vla_fastvlm_tpu/lerobot_fastvla/processor_fastvla.py``).

The same pipelines, in the same step order:

* pre-processor: rename (no-op map) -> add the batch dim -> move to the
  policy's device -> normalize with the dataset stats (MEAN_STD for state
  and action, IDENTITY for camera frames, per the config's map);
* post-processor: unnormalize the action -> move to the CPU.

Here the policy's device is the card the policy runs on (``config.device``),
so the batch reaches it once, in the pre-processor.
"""

from __future__ import annotations

from typing import Any

import torch

from lerobot.processor import (
    AddBatchDimensionProcessorStep,
    DeviceProcessorStep,
    NormalizerProcessorStep,
    PolicyAction,
    PolicyProcessorPipeline,
    RenameObservationsProcessorStep,
    UnnormalizerProcessorStep,
)
from lerobot.processor.converters import policy_action_to_transition, transition_to_policy_action
from lerobot.utils.constants import POLICY_POSTPROCESSOR_DEFAULT_NAME, POLICY_PREPROCESSOR_DEFAULT_NAME

from .configuration_fastvla import FastVLAConfig


def _preprocessor(config: FastVLAConfig, stats) -> PolicyProcessorPipeline[dict[str, Any], dict[str, Any]]:
    # Normalization covers the input AND output features: LeRobot training
    # normalizes the ground-truth action through the same step.
    normalized_features = dict(config.input_features)
    normalized_features.update(config.output_features)
    return PolicyProcessorPipeline[dict[str, Any], dict[str, Any]](
        name=POLICY_PREPROCESSOR_DEFAULT_NAME,
        steps=[
            RenameObservationsProcessorStep(rename_map={}),
            AddBatchDimensionProcessorStep(),
            DeviceProcessorStep(device=config.device),
            NormalizerProcessorStep(
                features=normalized_features,
                norm_map=config.normalization_mapping,
                stats=stats,
                device=config.device,
            ),
        ],
    )


def _postprocessor(config: FastVLAConfig, stats) -> PolicyProcessorPipeline[PolicyAction, PolicyAction]:
    return PolicyProcessorPipeline[PolicyAction, PolicyAction](
        name=POLICY_POSTPROCESSOR_DEFAULT_NAME,
        steps=[
            UnnormalizerProcessorStep(
                features=config.output_features,
                norm_map=config.normalization_mapping,
                stats=stats,
            ),
            DeviceProcessorStep(device="cpu"),
        ],
        to_transition=policy_action_to_transition,
        to_output=transition_to_policy_action,
    )


def make_fastvla_pre_post_processors(
    config: FastVLAConfig,
    dataset_stats: dict[str, dict[str, torch.Tensor]] | None = None,
) -> tuple[
    PolicyProcessorPipeline[dict[str, Any], dict[str, Any]],
    PolicyProcessorPipeline[PolicyAction, PolicyAction],
]:
    """Build the (pre, post) LeRobot pipelines for ``policy.type=fastvla``."""
    return _preprocessor(config, dataset_stats), _postprocessor(config, dataset_stats)
