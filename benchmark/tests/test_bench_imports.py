"""Nothing in the benchmark imports JAX or the JAX package, compared by
whole top-level module names (``dino_tpu_torch`` is not ``dino_tpu``),
and the reference imports nothing of the port either: read from every
file's import statements, and from ``sys.modules`` after a run."""
import ast
import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "dino_tpu"}
FILES = sorted(p for p in (ROOT / "benchmark").rglob("*.py")
               if ".build" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        names = top_level_imports(path)
        assert not names & (FORBIDDEN | {"dino_tpu_torch"}), path
        assert names <= {"__future__", "math", "typing", "torch", "numpy",
                         "benchmark"}, (path, names)


def test_a_run_loads_none_of_them(small_root):
    """A whole small run in a fresh process (the seg stream cell on the
    CPU, its check included): ``sys.modules`` holds none of the four."""
    code = f"""
import sys, time, json
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from benchmark.harness.spec import Bench
from benchmark.harness.cell import run_cell
from benchmark.run import forbidden_modules
line = run_cell(Bench(Path({str(small_root)!r})), "seg-stream-b16", 3, 0.2,
                True, "cpu", time.time(), log=lambda s: None)
print(json.dumps({{"bad": forbidden_modules(), "correct": line["correct"],
                  "dino_tpu_torch": "dino_tpu_torch" in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "correct": True, "dino_tpu_torch": True}


def test_run_py_refuses_without_a_card():
    """``run.py`` exits non-zero with no result where CUDA is missing (this
    sandbox), before any run."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "seg-stream-b16", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    if "CUDA card" not in out.stderr:
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""
