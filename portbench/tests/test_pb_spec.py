"""BENCHMARK.json against the benchmark's contract, and discovery by name:
every cell finds its configuration, mix, kind module, limits and readers, and a
cell, mix or metric added as files and entries is found without an edit."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest

from portbench.bench import end_to_end_names, load_spec, per_layer_names, reader, run_cell
from portbench.reference.config import load_config
from portbench.tests.tiny import ACT, tiny_root

ROOT = Path(__file__).resolve().parents[2]
SPEC = load_spec(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"] and SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in SPEC["configs"]] + [w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]] + [c["source"] for c in SPEC["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"actions_per_s", "control_tick_p95_ms", "tokens_per_s", "samples_per_s", "setup_s"}
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert w["chips"] == 1 and set(w) == {"name", "config", "traffic", "chips", "why"}
    entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("portbench/") and entry["reduced"] == []
    cfg = load_config(ROOT / entry["file"])
    assert cfg.name == w["config"]
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    assert hasattr(importlib.import_module(f"portbench.kinds.{traffic['kind']}"), "Cell")
    limits = json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())
    e2e = [m["name"] for m in end_to_end_names(SPEC, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = per_layer_names(SPEC, cell)
    assert layers
    for m in layers:
        assert m["moves"] in e2e and callable(reader(m["name"]))


def test_per_layer_metrics():
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"} and m["workloads"]
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        if m["name"].split(".")[0].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert "kernels" in layers and "whole step" in layers


def test_configs_at_published_widths():
    a = load_config(ROOT / "portbench" / "configs" / "fastvla-0.5b.json")
    b = load_config(ROOT / "portbench" / "configs" / "fastvlm-7b.json")
    assert (a.text.hidden_size, a.text.num_hidden_layers, a.text.num_attention_heads,
            a.text.num_key_value_heads, a.text.intermediate_size, a.text.vocab_size) == (896, 24, 14, 2, 4864, 151936)
    assert (b.text.hidden_size, b.text.num_hidden_layers, b.text.num_attention_heads, b.text.num_key_value_heads,
            b.text.intermediate_size, b.text.vocab_size, b.text.head_dim) == (3584, 28, 28, 4, 18944, 152064, 128)
    assert a.vision == b.vision and a.vision.depths == (2, 12, 24, 4, 2) and a.mm_hidden_size == 3072


def test_a_new_mix_and_cell_are_found_from_files_and_entries(tmp_path):
    spec = tiny_root(tmp_path)
    mix = json.loads((tmp_path / "portbench" / "traffic" / f"{ACT}.json").read_text())
    (tmp_path / "portbench" / "traffic" / "act.other.json").write_text(json.dumps(dict(mix, robots=2)))
    (tmp_path / "portbench" / "limits" / "act.tiny.other.json").write_text(json.dumps({"act_err": 1e-3}))
    spec["workloads"].append({"name": "act.tiny.other", "config": "tiny", "traffic": "act.other", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if ACT in m.get("workloads", []):
            m["workloads"].append("act.tiny.other")
    result = run_cell(spec, tmp_path, "act.tiny.other", 5, 0.2, False, "cpu")
    assert result["correct"] and result["attempted"] > 0
    assert result["metrics"]["actions_per_s"]["value"] > 0
