"""The check catches what it must, on the CPU at a small size, with the
cells' own limits: a sound run comes out correct; a run with a fault
planted in the port underneath comes out not correct, once for each fault
the cell can have (a label map altered where it is made; a training step
that leaves the state as it found it, or that leaves out half the batch
and takes the mean over the rest; the cells run on one card, so no
exchange between cards can be left out); and the control fails the check
too: for the seg cells the port's int8 path (on the card), for the
pretrain cell the reference computed in fp8 in the program's place."""
import contextlib
import time

import pytest
import torch

from benchmark.harness.cell import Run, run_cell
from benchmark.harness.spec import Bench

CELLS = ["seg-stream-b16", "seg-frame-b1", "seg-stream-960-b4",
         "pretrain-b64"]
FAULTS = [("seg-stream-b16", "altered_answer"),
          ("seg-frame-b1", "altered_answer"),
          ("seg-stream-960-b4", "altered_answer"),
          ("pretrain-b64", "unchanged_state"),
          ("pretrain-b64", "half_batch")]


def run(root, cell, seed, fault=None):
    bench = Bench(root)
    driver = bench.driver(bench.cell(cell))
    with driver.FAULTS[fault]() if fault else contextlib.nullcontext():
        return run_cell(bench, cell, seed, 0.3, False, "cpu", time.time(),
                        log=lambda s: None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(small_root, cell):
    line = run(small_root, cell, 2 ** 31 + 7)
    assert line["correct"], line["compared"]
    assert list(line)[-1] == "compared"


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(small_root, cell, fault):
    line = run(small_root, cell, 2 ** 31 + 8, fault)
    assert not line["correct"], line["compared"]


def control_numbers(root, cell, seed):
    bench = Bench(root)
    c = bench.cell(cell)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    numbers = bench.driver(c).control(Run(cell=c, seed=seed, seconds=2.0,
                                          device=device, trace=False))
    return numbers, c.limits


def test_the_pretrain_control_is_not_correct(small_root):
    """The reference with fp8 products in the program's place (the port
    has no lower-precision training path), at a small size."""
    numbers, limits = control_numbers(small_root, "pretrain-b64", 2 ** 31 + 9)
    assert any(v > limits[k] for k, v in numbers.items()), (numbers, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS[:3])
def test_the_seg_control_is_not_correct(cell):
    """The port's own int8 path switched on, at the cell's own size on the
    card (at a size the CPU holds, int8 and bf16 part too little to tell)."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the seg control runs at the cell's size")
    from benchmark.tests.conftest import ROOT
    numbers, limits = control_numbers(ROOT, cell, 2 ** 31 + 10)
    assert any(v > limits[k] for k, v in numbers.items()), (numbers, limits)
