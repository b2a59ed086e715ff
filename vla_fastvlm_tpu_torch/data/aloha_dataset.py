"""ALOHA / LeRobot dataset layer of the port: numpy-native, host-side,
prefetching (a copy of ``vla_fastvlm_tpu/data/aloha_dataset.py``, which the
port may not import).

Same surface: ``AlohaSample``, ``AlohaDataset``, ``AlohaIterableDataset``,
``create_aloha_dataloader``, ``aloha_collate_fn``,
``default_aloha_transforms``, the thread-prefetching ``DataLoader`` and
``SyntheticAlohaSource``. Samples stay numpy in host memory; the trainer
moves batches to the card (``data/prefetch.py``). The HF ``datasets``
package is imported only when a dataset is loaded from the Hub (the card's
machine does not have it); in-memory ``source`` records need nothing.

``SyntheticAlohaSource`` gives the LeRobot ALOHA schema (keys
``observation.images.top``, ``observation.state``, ``action``, ``task`` plus
episode/frame/timestamp/index/task_index metadata) from a seed, for offline
tests and the chip smoke run; the same seed gives the JAX package's records.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

ImageTransform = Callable[[np.ndarray], np.ndarray]
StateTransform = Callable[[np.ndarray], np.ndarray]


@dataclass
class AlohaSample:
    """Single record from a LeRobot-schema dataset."""

    image: np.ndarray
    state: np.ndarray
    action: np.ndarray
    task: str
    metadata: Dict[str, Any]


def default_aloha_transforms(image: np.ndarray) -> np.ndarray:
    """Standardise dataset images to float32 in [0, 1].

    Parity with reference ``default_aloha_transforms``
    (``aloha_dataset.py:26-37``): raw LeRobot images are (C, H, W) float32 in
    [0, 255]; anything with max > 1 is rescaled.
    """
    image = np.asarray(image)
    if image.dtype != np.float32:
        image = image.astype(np.float32)
    if image.size and image.max() > 1.0:
        image = image / 255.0
    return image


def _resolve_task(record: Dict[str, Any], task_key: Optional[str]) -> str:
    """Task label with fallback keys, 'unknown' otherwise
    (parity: reference ``aloha_dataset.py:225-241``)."""
    candidate_keys = []
    if task_key:
        candidate_keys.append(task_key)
    candidate_keys.extend(["task", "task_id", "task_name"])
    for key in candidate_keys:
        if key and key in record and record[key] is not None:
            value = record[key]
            if isinstance(value, str):
                return value
            return str(value)
    return "unknown"


def _to_numpy(value) -> np.ndarray:
    if hasattr(value, "numpy"):  # torch tensor from HF set_format
        value = value.numpy()
    return np.asarray(value)


_METADATA_KEYS = ("episode_index", "frame_index", "timestamp", "index", "task_index")


class _RecordAdapter:
    """Shared record -> AlohaSample conversion for both dataset variants."""

    def __init__(
        self,
        image_key: str,
        state_key: str,
        action_key: str,
        task_key: str,
        image_transform: ImageTransform,
        state_transform: Optional[StateTransform],
    ) -> None:
        self._image_key = image_key
        self._state_key = state_key
        self._action_key = action_key
        self._task_key = task_key
        self._image_transform = image_transform
        self._state_transform = state_transform

    def convert(self, record: Dict[str, Any]) -> AlohaSample:
        image = self._image_transform(_to_numpy(record[self._image_key]))
        state = _to_numpy(record[self._state_key]).astype(np.float32)
        action = _to_numpy(record[self._action_key]).astype(np.float32)
        if self._state_transform is not None:
            state = self._state_transform(state)
        task = _resolve_task(record, self._task_key)
        metadata = {
            key: (_to_numpy(record[key]) if record.get(key) is not None else None)
            for key in _METADATA_KEYS
        }
        return AlohaSample(
            image=image, state=state, action=action, task=task, metadata=metadata
        )


class AlohaDataset:
    """Finite (map-style) dataset wrapper for local training.

    Parity: reference ``AlohaDataset`` (``aloha_dataset.py:40-101``) —
    HF ``load_dataset`` + ``limit_samples`` select + per-sample transforms.
    """

    def __init__(
        self,
        split: str = "train",
        repo_id: str = "lerobot/aloha_sim_insertion_human_image",
        cache_dir: Optional[str] = None,
        image_key: str = "observation.images.top",
        state_key: str = "observation.state",
        action_key: str = "action",
        task_key: str = "task",
        image_transform: ImageTransform = default_aloha_transforms,
        state_transform: Optional[StateTransform] = None,
        limit_samples: Optional[int] = None,
        source: Optional[Sequence[Dict[str, Any]]] = None,
    ) -> None:
        if source is not None:
            records = list(source)
            if limit_samples is not None:
                records = records[:limit_samples]
            self._dataset = records
        else:
            from datasets import load_dataset

            dataset = load_dataset(repo_id, split=split, cache_dir=cache_dir)
            dataset = dataset.with_format("numpy")
            if limit_samples is not None:
                dataset = dataset.select(range(limit_samples))
            self._dataset = dataset
        self._adapter = _RecordAdapter(
            image_key, state_key, action_key, task_key,
            image_transform, state_transform,
        )

    def __len__(self) -> int:
        return len(self._dataset)

    def __getitem__(self, index: int) -> AlohaSample:
        return self._adapter.convert(self._dataset[index])


class AlohaIterableDataset:
    """Streaming dataset wrapper to avoid downloading the full dataset.

    Parity: reference ``AlohaIterableDataset`` (``aloha_dataset.py:104-182``).
    """

    def __init__(
        self,
        split: str = "train",
        repo_id: str = "lerobot/aloha_sim_insertion_human_image",
        cache_dir: Optional[str] = None,
        image_key: str = "observation.images.top",
        state_key: str = "observation.state",
        action_key: str = "action",
        task_key: str = "task",
        image_transform: ImageTransform = default_aloha_transforms,
        state_transform: Optional[StateTransform] = None,
        source: Optional[Any] = None,
    ) -> None:
        if source is not None:
            self._dataset = source
        else:
            from datasets import IterableDataset as HFIterableDataset
            from datasets import load_dataset

            dataset = load_dataset(
                repo_id, split=split, cache_dir=cache_dir, streaming=True
            )
            if not isinstance(dataset, HFIterableDataset):
                raise RuntimeError("Expected iterable dataset when streaming=True.")
            self._dataset = dataset
        self._adapter = _RecordAdapter(
            image_key, state_key, action_key, task_key,
            image_transform, state_transform,
        )

    def __iter__(self) -> Iterator[AlohaSample]:
        for record in self._dataset:
            yield self._adapter.convert(record)


def aloha_collate_fn(batch) -> Dict[str, Any]:
    """Stack a batch of ``AlohaSample`` into arrays/lists.

    Parity: reference ``aloha_collate_fn`` (``aloha_dataset.py:205-222``) —
    images/states/actions stacked, tasks and metadata as lists.
    """
    batch_list = list(batch)
    return {
        "images": np.stack([s.image for s in batch_list]),
        "states": np.stack([s.state for s in batch_list]),
        "actions": np.stack([s.action for s in batch_list]),
        "tasks": [s.task for s in batch_list],
        "metadata": [s.metadata for s in batch_list],
    }


class DataLoader:
    """Thread-prefetching batch loader over map-style or iterable datasets.

    The host assembles the next batches while the device runs the current
    step. ``shard_index``/``num_shards`` select this host's slice for
    multi-host data parallelism.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        collate_fn=aloha_collate_fn,
        drop_last: bool = False,
        seed: int = 0,
        prefetch: int = 4,
        shard_index: int = 0,
        num_shards: int = 1,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle and hasattr(dataset, "__len__")
        self.num_workers = max(0, num_workers)
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = num_shards
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        if not hasattr(self.dataset, "__len__"):
            raise TypeError("IterableDataset has no length")
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self) -> Iterator[List[int]]:
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(indices)
        indices = indices[self.shard_index :: self.num_shards]
        for start in range(0, len(indices), self.batch_size):
            chunk = indices[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk.tolist()

    def _iter_map(self) -> Iterator[Dict[str, Any]]:
        batches = self._index_batches()
        if self.num_workers == 0:
            for idx_batch in batches:
                yield self.collate_fn([self.dataset[i] for i in idx_batch])
            return

        out_queue: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for idx_batch in batches:
                    samples = [self.dataset[i] for i in idx_batch]
                    out_queue.put(self.collate_fn(samples))
            except BaseException as exc:  # surface worker errors to consumer
                out_queue.put(exc)
            finally:
                out_queue.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = out_queue.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        thread.join()

    def _iter_stream_sync(self) -> Iterator[Dict[str, Any]]:
        batch: List[Any] = []
        for i, sample in enumerate(self.dataset):
            if i % self.num_shards != self.shard_index:
                continue
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _iter_stream(self) -> Iterator[Dict[str, Any]]:
        if self.num_workers == 0:
            yield from self._iter_stream_sync()
            return
        # Single producer thread pulls/collates from the (network-bound)
        # stream while the consumer trains — same overlap as the map path.
        out_queue: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for item in self._iter_stream_sync():
                    out_queue.put(item)
            except BaseException as exc:
                out_queue.put(exc)
            finally:
                out_queue.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = out_queue.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        thread.join()

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if hasattr(self.dataset, "__len__"):
            yield from self._iter_map()
        else:
            yield from self._iter_stream()
        self._epoch += 1


def create_aloha_dataloader(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    num_workers: int = 4,
    **kwargs,
) -> DataLoader:
    """Construct a dataloader yielding dicts ready for FastVLM training.

    Parity: reference ``create_aloha_dataloader`` (``aloha_dataset.py:185-202``)
    — shuffle is forced off for iterable datasets.
    """
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=shuffle if hasattr(dataset, "__len__") else False,
        num_workers=num_workers,
        collate_fn=aloha_collate_fn,
        **kwargs,
    )


# ----------------------------------------------------------------------
# synthetic source (offline tests/benches; SURVEY.md §4 fixture)


def SyntheticAlohaSource(
    num_samples: int = 64,
    image_hw: tuple[int, int] = (48, 48),
    state_dim: int = 14,
    action_dim: int = 14,
    num_episodes: int = 4,
    task: str = "insert the peg",
    seed: int = 0,
) -> List[Dict[str, Any]]:
    """In-memory records with the LeRobot ALOHA schema, for offline use."""
    rng = np.random.default_rng(seed)
    h, w = image_hw
    records = []
    per_episode = max(1, num_samples // num_episodes)
    for i in range(num_samples):
        records.append(
            {
                "observation.images.top": rng.random((3, h, w)).astype(np.float32)
                * 255.0,
                "observation.state": rng.standard_normal(state_dim).astype(np.float32),
                "action": rng.standard_normal(action_dim).astype(np.float32),
                "task": task,
                "episode_index": i // per_episode,
                "frame_index": i % per_episode,
                "timestamp": float(i % per_episode) / 50.0,
                "index": i,
                "task_index": 0,
            }
        )
    return records
