"""What the benchmark may load: never JAX or the JAX package `repro`
(top-level module names compared whole: `repro_torch` is not `repro`),
and in its reference nothing of the program; nothing reads the old JAX
benchmark's `benchmarks/`."""
from __future__ import annotations

import ast
import subprocess
import sys

from perfbench.conftest import ROOT

HERE = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def sources():
    return [p for p in HERE.rglob("*.py") if "out" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported(path) & FORBIDDEN, path


def test_the_reference_imports_torch_alone():
    assert imported(HERE / "reference.py") <= {"__future__", "warnings",
                                               "torch"}


def test_nothing_reads_the_old_benchmark():
    for path in sources():
        if path.name.startswith("test_"):
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "import benchmarks" not in text
        assert "benchmarks" not in imported(path)


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from perfbench import harness\n"
        "from perfbench.conftest import small_cell\n"
        "for w in ('ba20.query', 'ba20.update_del'):\n"
        "    harness.run_cell(small_cell(w), 5, 0.2, True,\n"
        "                     torch.device('cpu'))\n"
        "print(harness.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
