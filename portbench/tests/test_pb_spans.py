"""The readers of the port's own spans and counters (``portbench/spans.py``)
in a traced run of each tiny cell on the CPU: every such metric of the
cell reads a value."""

from __future__ import annotations

import pytest

from portbench.bench import run_cell
from portbench.tests.tiny import ACT, SERVE, TRAIN, tiny_root

NEW = {ACT: {"prep_frames_ms.act", "prep_upload_ms.act"},
       SERVE: {"prefill_use.serve", "admit_upload_ms.serve", "admit_wait_ms.serve"},
       TRAIN: {"feed_ms.train"}}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    return tiny_root(root), root


@pytest.mark.parametrize("name", (ACT, SERVE, TRAIN))
def test_traced_run_reads_the_program_span_metrics(bench, name):
    from vla_fastvlm_tpu_torch.utils import tracing

    spec, root = bench
    tracing.reset()
    result = run_cell(spec, root, name, 2 ** 31 + 99, 0.3, True, "cpu")
    assert result["correct"]
    sources = {m["name"]: m["source"] for m in spec["per_layer"] if name in m["workloads"]}
    assert {k for k, v in sources.items() if v.startswith("program_")} == NEW[name]
    for metric in NEW[name]:
        assert result["metrics"][metric]["value"] > 0, metric
    if name == SERVE:
        assert result["metrics"]["prefill_use.serve"]["value"] <= 100
