"""Running one cell: set-up, the measured window, the traced iterations,
the correctness check, and the result's line.

A driver (``drivers/<name>.py``) has a class ``Driver(run)`` with:

  * ``setup()``: build the program and its inputs from the seed and warm
    up every shape the window uses;
  * ``window() -> Window``: the measured window, ended by a synchronize;
  * ``traced() -> dict``: a fixed, small number of further iterations,
    which the harness runs under ``torch.profiler``; returns what they
    did (``iterations``, and ``frames`` or ``images``);
  * ``launches() -> dict``: per traced iteration, each kernel's launch
    shapes, ``{kernel: [(count, {shape args}), ...]}``;
  * ``release()``: free the program's state;
  * ``check() -> {number: value}``: the comparison with the plain
    reference, run after ``release``.

A driver of a cell over several cards (rank 0 in the harness's process,
``harness/ranks.py``) also has:

  * ``memory_peak(mine) -> int``: the peak of the fullest card, given
    this process's;
  * ``ranks_trace(summary) -> summary``: rank 0's trace summary with its
    device numbers averaged over the cards.

The harness holds each compared number to its limit in
``limits/<cell>.json`` (a number whose limit is null is printed but not
compared).  With ``--trace 0`` the line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from the window
and the trace by ``metrics/<name>.py``.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Callable, Dict, Optional

import torch

from benchmark.harness.spec import Bench, Cell
from benchmark.harness.trace import WINDOW, TraceSummary, reduce_profile


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell, the seed, the window's length,
    the device and whether this run is traced."""
    cell: Cell
    seed: int
    seconds: float
    device: torch.device
    trace: bool


@dataclasses.dataclass
class Window:
    t_start: float          # time.time() at the window's start
    seconds: float          # the window's length on the host clock
    attempted: int
    failed: int
    work: Dict[str, float]  # e.g. {"frames": n} or {"images": n, "steps": k}
    metrics: Dict[str, float]  # end-to-end metrics the driver measured


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader reads."""
    bench: Bench
    cell: Cell
    window: Window
    device_kind: Optional[str]
    trace: Optional[TraceSummary]
    traced: dict
    launches: dict


def port_counters() -> Dict[str, int]:
    """The port's kernel launch counters (eager launches; a CUDA-graph
    replay is not counted), logged beside the traced iterations: the
    roofline readers count launches in the trace, which sees replays.
    fc1's bias-GELU pass counts its forward launches and backward calls."""
    from dino_tpu_torch.ops import attention, bias_gelu, fused_mlp
    return {
        "flash_fwd_bf16": (attention.flash_attention.launches
                           - attention.flash_attention.launches_f32),
        "flash_bwd_bf16": (attention.flash_attention_bwd.launches
                           - attention.flash_attention_bwd.launches_f32),
        "fused_ln_mlp": fused_mlp.fused_ln_mlp_residual.launches,
        "fc1_bias_gelu": bias_gelu.fc1_bias_gelu.launches,
        "fc1_bias_gelu_bwd": bias_gelu.fc1_bias_gelu.launches_bwd,
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(drv, device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = port_counters()
    with torch.profiler.profile(activities=acts) as prof:
        _sync(device)
        with torch.profiler.record_function(WINDOW):
            info = drv.traced()
            _sync(device)
    after = port_counters()
    counters = {k: after[k] - before[k] for k in after}
    return reduce_profile(prof), info, counters


def _finite(x: float) -> float:
    return x if math.isfinite(x) else float("inf")


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, device, t0: float,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)
             ) -> dict:
    """Run ``workload`` once; returns the result's line as a dict (the
    ``compared`` key last).  ``t0`` is the process's start on
    ``time.time()``'s clock."""
    device = torch.device(device)
    cell = bench.cell(workload)
    run = Run(cell=cell, seed=seed, seconds=seconds, device=device,
              trace=trace)
    drv = bench.driver(cell).Driver(run)
    drv.setup()
    win: Window = drv.window()
    setup_s = win.t_start - t0
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if hasattr(drv, "memory_peak"):  # a cell over several cards
        peak = drv.memory_peak(peak)
    log(f"[bench] {workload} seed {seed}: setup {setup_s:.3f} s, window "
        f"{win.seconds:.3f} s, {win.work}, peak memory {peak} bytes "
        f"({kind})")
    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    extra = {}
    if trace:
        summary, info, counters = _profile(drv, device)
        if hasattr(drv, "ranks_trace"):  # a cell over several cards
            summary = drv.ranks_trace(summary)
        readings = Readings(bench=bench, cell=cell, window=win,
                            device_kind=kind, trace=summary, traced=info,
                            launches=drv.launches())
        for m in cell.per_layer:
            value = bench.reader(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if summary is not None:
            device_info["busy_s"] = summary.busy_s
            device_info["window_s"] = summary.window_s
            extra["breakdown"] = {
                "device_ops": [[n, s] for n, s in summary.device_ops()],
                "idle_gaps": [[n, s] for n, s in summary.idle_by_host[:10]]}
        log(f"[bench] traced {info}, launches counted {counters}")
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] in win.metrics:
                value = win.metrics[m["name"]]
            else:
                raise KeyError(f"driver {cell.traffic['driver']} measured no "
                               f"{m['name']!r} in {workload}")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    drv.release()
    t_check = time.perf_counter()
    numbers = drv.check()
    log(f"[bench] check {time.perf_counter() - t_check:.3f} s: {numbers}")
    compared = {}
    correct = win.failed == 0
    for name, value in numbers.items():
        limit = cell.limits.get(name)
        compared[name] = {"value": float(value), "limit": limit}
        if limit is not None:
            correct = correct and _finite(float(value)) <= limit
    if set(cell.limits) - set(numbers):
        raise KeyError(f"limits without a number: "
                       f"{sorted(set(cell.limits) - set(numbers))}")
    line = {"correct": bool(correct), "attempted": int(win.attempted),
            "failed": int(win.failed), "metrics": metrics,
            "device": device_info, **extra, "compared": compared}
    return line
