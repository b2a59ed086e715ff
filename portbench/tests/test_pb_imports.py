"""What the benchmark may import: the reference nothing of the program; no
file of the harness JAX or the JAX package; and a run's process holds no
module whose top-level name, compared whole, is JAX's or the JAX
package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vla_fastvlm_tpu"}


def imported_top_levels(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(imported_top_levels(path))
    assert not names & (FORBIDDEN | {"vla_fastvlm_tpu_torch", "portbench"}), names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_harness_file_imports_jax_or_the_jax_package(path):
    assert not set(imported_top_levels(path)) & FORBIDDEN


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    from portbench.bench import forbidden_modules

    monkeypatch.setitem(sys.modules, "vla_fastvlm_tpu_torch_probe", object())
    assert "vla_fastvlm_tpu_torch_probe" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.probe", object())
    assert "flax" in forbidden_modules()


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from portbench.tests.tiny import tiny_root, SERVE
from portbench.bench import run_cell, forbidden_modules
root = Path({str(tmp_path)!r})
spec = tiny_root(root)
result = run_cell(spec, root, SERVE, 3, 0.2, False, "cpu")
print(json.dumps({{"correct": result["correct"], "found": forbidden_modules()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"correct": True, "found": []}


def test_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "act.fastvla-0.5b.b128-256px",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
