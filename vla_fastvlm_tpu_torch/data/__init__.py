"""Data layer of the port (counterpart of ``vla_fastvlm_tpu/data``)."""

from .aloha_dataset import (
    AlohaDataset,
    AlohaIterableDataset,
    AlohaSample,
    DataLoader,
    SyntheticAlohaSource,
    aloha_collate_fn,
    create_aloha_dataloader,
    default_aloha_transforms,
)
from .prefetch import device_prefetch

__all__ = [
    "AlohaDataset",
    "AlohaIterableDataset",
    "AlohaSample",
    "DataLoader",
    "SyntheticAlohaSource",
    "aloha_collate_fn",
    "create_aloha_dataloader",
    "default_aloha_transforms",
    "device_prefetch",
]
