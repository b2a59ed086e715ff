"""Readings that set a cell's limits: for each seed, the program's numbers
(set-up, a short window at the cell's own load, the comparison with the
reference) and the control's (the reference in float8 products put in the
program's place, compared the same way). One JSON line a seed.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--seconds 2]

Not part of a benchmark run. ``tests/test_pb_card.py`` runs it on the card
at the cell's own size and asserts that the control fails the cell's
limits.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402


def readings(root: Path, spec: dict, name: str, seed: int, seconds: float, device) -> dict:
    """The program's and the control's numbers on one seed."""
    import torch

    from portbench.bench import config_entry, workload
    from portbench.reference.config import parse_config

    wl = workload(spec, name)
    raw = json.loads((root / config_entry(spec, wl["config"])["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{wl['traffic']}.json").read_text())
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    cell = kind.Cell(parse_config(raw), raw, traffic, seed, device, False)
    cell.setup()
    window = cell.window(seconds)
    cell.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "attempted": window.attempted, "failed": window.failed, "program": cell.compare()}
    out["worst"] = getattr(cell, "worst", None)
    out["control"] = cell.control()
    if hasattr(cell, "faults"):
        out["faults"] = cell.faults()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch

    from portbench.bench import load_spec

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA device", file=sys.stderr)
        return 2
    spec = load_spec(Path(ROOT))
    for seed in args.seeds:
        print(json.dumps(readings(Path(ROOT), spec, args.workload, seed, args.seconds, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
