"""On the card, at each cell's own size: the control (the reference in
float8 products put in the program's place) fails the cell's limits on
three seeds, while the program meets them on the same seeds. Skips without
a card; run on the H100 with

    python -m pytest portbench/tests/test_pb_card.py -m cuda -p no:cacheprovider -s
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (3_100_000_001, 3_100_000_002, 3_100_000_003)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's kernels at full size")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", ["act.fastvla-0.5b.b128-256px", "serve.fastvlm-7b.slots256-img1024",
                                  "train.fastvla-0.5b.full-b64-512px"])
def test_control_fails_and_program_passes_at_cell_size(card, cell):
    from portbench.bench import load_spec
    from portbench.control import readings

    spec = load_spec(ROOT)
    limits = json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())
    for seed in SEEDS:
        r = readings(ROOT, spec, cell, seed, 2.0, card)
        print(json.dumps(dict(r, cell=cell)), flush=True)
        assert r["failed"] == 0
        assert all(r["program"][k] <= limit for k, limit in limits.items()), r
        assert any(r["control"].get(k, -1) > limit for k, limit in limits.items()), r
