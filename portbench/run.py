"""Run one cell of the benchmark once and print its result as the last line
of standard output (one JSON object).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs on the machine it is started on, from the root of a checkout: it needs
``torch.cuda`` with as many cards as the cell asks for, and exits with 2,
printing no result, without them. Kernel builds and caches stay in
``build/`` inside the checkout. The numbers compared with the reference are
printed with their limits as the last lines of standard error and under
``"compared"``, the result's last key.
"""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root, not this folder, on the path: the harness is the
# package ``portbench`` and its module names must not shadow others.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # Libraries the port may load must not bring JAX in; caches stay in the checkout.
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")

    import torch

    from portbench.bench import forbidden_modules, load_spec, run_cell, workload

    spec = load_spec(Path(ROOT))
    chips = int(workload(spec, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(spec, Path(ROOT), args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      start=START, log=lambda line: print(line, file=sys.stderr))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, value in result.get("readings", {}).items():
        print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
