"""The data-parallel pretrain cell over two gloo ranks on the CPU, at
conftest's small pretrain size, with the cell's own limits: rank 0 in the
test's subprocess, rank 1 spawned by the harness.  A sound run (traced)
comes out correct with every rank agreeing; each fault planted in every
rank (a step that leaves the state as it found it, half of each slab left
out, each rank stepping on its own gradient) and the control (the
reference in fp8) do not; a rank that raises ends the run non-zero
within a bounded time, with no process left behind."""
import json
import os
import shutil
import subprocess
import sys
import time
import uuid
from pathlib import Path

import pytest

from benchmark.tests.conftest import ROOT, edit

CELL = "pretrain-dp4"
RUN_TIMEOUT = 300
ABORT_WITHIN = 120.0

SCRIPT = """
import contextlib, json, sys, time
sys.path.insert(0, {repo!r})
from pathlib import Path
import torch
torch.set_num_threads(1)
from benchmark.harness.cell import Run, run_cell
from benchmark.harness.spec import Bench
bench = Bench(Path({root!r}))
cell = bench.cell({cell!r})
driver = bench.driver(cell)
if {fault!r} == "control":
    run = Run(cell=cell, seed={seed}, seconds=0.3, device=torch.device("cpu"),
              trace=False)
    numbers = driver.control(run)
    print(json.dumps({{"compared": {{k: {{"value": v, "limit": cell.limits[k]}}
                                    for k, v in numbers.items()}}}}))
else:
    with driver.FAULTS[{fault!r}]() if {fault!r} else contextlib.nullcontext():
        line = run_cell(bench, {cell!r}, {seed}, 0.3, {trace}, "cpu",
                        time.time())
    print(json.dumps(line))
"""

RAISE = """

_planted_{phase} = Driver.{phase}


def _raising_{phase}(self, *args):
    if self.rank == 1:
        raise RuntimeError("a failure planted on rank 1")
    return _planted_{phase}(self, *args)


Driver.{phase} = _raising_{phase}
"""


@pytest.fixture(scope="module")
def dp_root(small_root, tmp_path_factory) -> Path:
    """The small benchmark with the cell over two ranks."""
    root = tmp_path_factory.mktemp("dp") / "root"
    shutil.copytree(small_root, root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        if w["name"] == CELL:
            w["chips"] = 2
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    edit(root / "benchmark" / "workloads" / f"{CELL}.json", pool_batches=4,
         check_microbatch=2)
    return root


def _alive_with(marker: str) -> list:
    """Processes whose environment holds ``marker``."""
    found = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if marker.encode() in f.read():
                    found.append(int(pid))
        except (OSError, ValueError):
            continue
    return found


def launch(root: Path, seed: int, fault=None, trace=False):
    """The cell in a fresh process; (its result, the time it took, the
    processes of the run still alive after it)."""
    code = SCRIPT.format(repo=str(ROOT), root=str(root), cell=CELL,
                         fault=fault, seed=seed, trace=trace)
    token = uuid.uuid4().hex
    env = dict(os.environ, BENCH_DP_TEST=token)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=RUN_TIMEOUT, cwd=ROOT, env=env)
    took = time.monotonic() - t0
    return out, took, _alive_with(f"BENCH_DP_TEST={token}")


def result(out) -> dict:
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_sound_run_is_correct(dp_root):
    out, _, left = launch(dp_root, 2 ** 31 + 21, trace=True)
    line = result(out)
    assert line["correct"], line["compared"]
    assert line["compared"]["rank_gap"]["value"] == 0.0
    assert line["device"]["count"] == 2 and line["failed"] == 0
    assert not left


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "no_allreduce", "control"])
def test_a_fault_or_the_control_is_not_correct(dp_root, fault):
    out, _, left = launch(dp_root, 2 ** 31 + 22, fault=fault)
    line = result(out)
    assert not line.get("correct", False), line["compared"]
    assert any(c["value"] > c["limit"] for c in line["compared"].values())
    assert not left


@pytest.mark.parametrize("phase", ["setup", "window"])
def test_a_rank_that_raises_ends_the_run(dp_root, tmp_path, phase):
    """Rank 1 raises before the group forms (rank 0 waits in the
    rendezvous) or at the window (rank 0 waits in a collective, or gloo
    raises there that its peer is gone): the watchdog or rank 0's guard
    ends the run."""
    root = tmp_path / "root"
    shutil.copytree(dp_root, root)
    driver = root / "benchmark" / "drivers" / "dino_pretrain_dp.py"
    driver.write_text(driver.read_text() + RAISE.format(phase=phase))
    out, took, left = launch(root, 2 ** 31 + 23)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "a failure planted on rank 1" in out.stderr
    assert "ending the run" in out.stderr, out.stderr[-3000:]
    assert took < ABORT_WITHIN
    assert not left
