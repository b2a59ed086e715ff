"""One run of one cell: find its configuration, traffic mix, limits and
per-layer readers by name, set up, measure, compare, and build the result.

Everything a cell needs is found by name from ``BENCHMARK.json``:

- ``configs[].file``: the configuration (``portbench/configs/``);
- ``workloads[].traffic``: ``portbench/traffic/<traffic>.json``, whose
  ``kind`` names the module ``portbench/kinds/<kind>.py`` (one general
  generator a kind: a new mix of a kind is a data file);
- ``portbench/limits/<workload>.json``: the limit of every number the
  comparison gives;
- ``per_layer[].name``: the reader ``portbench/metrics/<name>.py``.

So a new cell, configuration, mix or per-layer metric is new files and new
entries; no file here changes.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from .reference.config import parse_config

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vla_fastvlm_tpu")


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_names(spec: dict, cell: str) -> List[dict]:
    return [m for m in spec["end_to_end"] if applies(m, cell)]


def per_layer_names(spec: dict, cell: str) -> List[dict]:
    """The cell's per-layer metrics: those whose ``workloads`` list it."""
    return [m for m in spec["per_layer"] if cell in m["workloads"]]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    module_spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(spec: dict, root: Path, name: str, seed: int, seconds: float, traced: bool, device,
             start: Optional[float] = None, limits: Optional[Dict[str, float]] = None,
             log: Optional[Callable[[str], None]] = None) -> dict:
    """Run cell ``name`` once and return its result line (a dict). ``log``
    takes a summary of the window's host times (a line a label)."""
    start = time.perf_counter() if start is None else start
    device = torch.device(device)
    wl = workload(spec, name)
    raw_cfg = json.loads((root / config_entry(spec, wl["config"])["file"]).read_text())
    cfg = parse_config(raw_cfg)
    traffic = json.loads((root / "portbench" / "traffic" / f"{wl['traffic']}.json").read_text())
    if limits is None:
        limits = json.loads((root / "portbench" / "limits" / f"{name}.json").read_text())
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    cell = kind.Cell(cfg, raw_cfg, traffic, seed, device, traced)
    cell.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - start
    window = cell.window(seconds)
    for label, values in sorted(window.host_s.items()) if log else ():
        if values:
            log(f"host {label}: n={len(values)} median={statistics.median(values) * 1e3:.3f} ms "
                f"min={min(values) * 1e3:.3f} max={max(values) * 1e3:.3f} window={window.seconds:.3f} s")
    summary = None
    if traced:
        summary = cell.profile()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if traced:
        window.flops = cell.window_flops(window)
    run = SimpleNamespace(window=window, summary=summary, ranges=cell.ranges, units=cell.profiled_units())
    cell.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = cell.compare()

    metrics = {}
    if traced:
        for m in per_layer_names(spec, name):
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in end_to_end_names(spec, name):
            value = setup_s if m["name"] == "setup_s" else window.metrics[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    compared = {k: {"value": numbers.get(k), "limit": float(v)} for k, v in limits.items()}
    correct = (window.attempted > 0 and window.failed == 0 and all(
        c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values()))
    for c in compared.values():
        if c["value"] is not None and not math.isfinite(c["value"]):
            c["value"] = None
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(window.attempted), "failed": int(window.failed),
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    readings = {k: float(v) for k, v in numbers.items() if k not in limits}
    if readings:
        result["readings"] = readings  # computed, held to no limit (PERF.md says why)
    result["compared"] = compared
    return result
