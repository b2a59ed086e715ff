"""The port's data layer against the JAX package's, on the CPU.

``vla_fastvlm_tpu_torch/data`` is a copy of the JAX package's numpy data
layer (the port may not import it) plus a torch ``device_prefetch``: the
same seeds give the same records, batches, order and shuffles, exactly.
"""

import numpy as np
import pytest
import torch

from vla_fastvlm_tpu import data as jdata
from vla_fastvlm_tpu_torch import data as tdata
from vla_fastvlm_tpu_torch.data.aloha_dataset import _resolve_task


def _same_batch(a, b):
    assert set(a) == set(b)
    for key in ("images", "states", "actions"):
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])
    assert a["tasks"] == b["tasks"]
    assert [{k: None if v is None else np.asarray(v).tolist() for k, v in m.items()} for m in a["metadata"]] == \
        [{k: None if v is None else np.asarray(v).tolist() for k, v in m.items()} for m in b["metadata"]]


def test_synthetic_source_matches_jax():
    kw = dict(num_samples=6, image_hw=(8, 12), state_dim=5, action_dim=3, num_episodes=2, seed=7)
    ours, theirs = tdata.SyntheticAlohaSource(**kw), jdata.SyntheticAlohaSource(**kw)
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


@pytest.mark.parametrize("shuffle,drop_last,workers", [(True, False, 0), (True, True, 2), (False, False, 2)])
def test_loader_batches_match_jax_over_epochs(shuffle, drop_last, workers):
    """Order, shuffling by seed and epoch, collation and the last short batch."""
    records = jdata.SyntheticAlohaSource(num_samples=11, image_hw=(6, 6), state_dim=4, action_dim=4, seed=1)
    make = lambda m: m.create_aloha_dataloader(m.AlohaDataset(source=records), batch_size=4, shuffle=shuffle,
                                               num_workers=workers, drop_last=drop_last, seed=3)
    ours, theirs = make(tdata), make(jdata)
    assert len(ours) == len(theirs) == (2 if drop_last else 3)
    for _ in range(2):  # the second epoch reshuffles
        got, expect = list(ours), list(theirs)
        assert len(got) == len(expect)
        for a, b in zip(got, expect):
            _same_batch(a, b)


def test_sharded_and_streaming_loaders_match_jax():
    records = jdata.SyntheticAlohaSource(num_samples=9, image_hw=(4, 4), state_dim=2, action_dim=2, seed=2)
    module_pair = (tdata, jdata)
    loaders = [m.DataLoader(m.AlohaDataset(source=records), batch_size=2, shuffle=True, num_workers=0,
                            seed=5, shard_index=1, num_shards=2) for m in module_pair]
    for a, b in zip(*(list(loader) for loader in loaders)):
        _same_batch(a, b)
    streams = [m.create_aloha_dataloader(m.AlohaIterableDataset(source=records), batch_size=4, num_workers=1)
               for m in module_pair]
    got, expect = (list(s) for s in streams)
    assert [len(b["tasks"]) for b in got] == [4, 4, 1]
    for a, b in zip(got, expect):
        _same_batch(a, b)
    with pytest.raises(TypeError):
        len(streams[0])




def test_transforms_and_records():
    img = np.full((3, 4, 4), 255.0, dtype=np.float32)
    out = tdata.default_aloha_transforms(img)
    assert out.max() == pytest.approx(1.0)
    np.testing.assert_array_equal(tdata.default_aloha_transforms(out), out)
    assert _resolve_task({"task": "lift"}, "task") == "lift"
    assert _resolve_task({"task_id": 3}, None) == "3"
    assert _resolve_task({"task_name": "x"}, "missing") == "x"
    assert _resolve_task({}, "task") == "unknown"
    ds = tdata.AlohaDataset(source=tdata.SyntheticAlohaSource(num_samples=10), limit_samples=4)
    assert len(ds) == 4 and ds[0].image.shape == (3, 48, 48) and ds[0].image.max() <= 1.0
    assert ds[0].state.dtype == np.float32 and ds[0].metadata["index"] == 0


def test_loader_surfaces_worker_errors():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError("missing column")

    with pytest.raises(KeyError, match="missing column"):
        list(tdata.DataLoader(Broken(), batch_size=2, num_workers=1))


def test_device_prefetch_keeps_order_and_passes_strings():
    batches = [{"x": np.full((2, 3), i, np.float32), "tasks": [f"t{i}"] * 2, "ids": torch.full((2,), i)}
               for i in range(5)]
    placed = list(tdata.device_prefetch(iter(batches), size=2, device=torch.device("cpu")))
    assert len(placed) == 5
    for i, b in enumerate(placed):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        assert torch.equal(b["x"], torch.full((2, 3), float(i))) and b["ids"].tolist() == [i, i]
        assert b["tasks"] == [f"t{i}"] * 2
    with pytest.raises(ValueError):
        list(tdata.device_prefetch(iter(batches), size=0, device=torch.device("cpu")))
    with pytest.raises(ValueError, match="placer or a device"):
        list(tdata.device_prefetch(iter(batches)))


def test_device_prefetch_runs_size_ahead():
    pulled = []

    def source():
        for i in range(6):
            pulled.append(i)
            yield {"i": i}

    stream = tdata.device_prefetch(source(), size=3, placer=lambda b: b)
    assert next(stream) == {"i": 0} and pulled == [0, 1, 2]
    assert next(stream) == {"i": 1} and pulled == [0, 1, 2, 3]
    assert [b["i"] for b in stream] == [2, 3, 4, 5]
