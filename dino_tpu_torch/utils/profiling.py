"""Profiling: a device trace, named regions and a step timer.

The counterpart of ``dino_tpu/utils/profiling.py`` on ``torch.profiler``:
``device_trace`` records the CPU's and, with a card, the card's activity
and writes a Chrome trace (Perfetto and ``chrome://tracing`` open it);
``annotate`` names a region on that timeline and, on the card, as an NVTX
range; ``StepTimer`` waits for the card before it reads the clock.
``hbm_stats`` is ``utils/logging.py``'s.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from dino_tpu_torch.utils.logging import hbm_stats  # noqa: F401 (re-export)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None,
                 create_perfetto_link: bool = False) -> Iterator[str]:
    """Record the body's host and device activity into a Chrome trace,
    ``<logdir>/trace_<pid>_<ns>.json`` (default ``logdir``: a folder in the
    temporary directory); yields ``logdir``.

        with device_trace("runs/trace"):
            model.predict(frame)

    ``create_perfetto_link`` is ``dino_tpu``'s: ``torch.profiler`` serves
    no link, so it raises; open the file in Perfetto instead."""
    if create_perfetto_link:
        raise ValueError("torch.profiler serves no Perfetto link: open the "
                         "trace file in Perfetto")
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "dino_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        try:
            yield logdir
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region on the trace's timeline (``record_function``) and, on
    the card, an NVTX range of the same name."""
    cuda = torch.cuda.is_available()
    with record_function(name):
        if cuda:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.nvtx.range_pop()


def _cuda_devices(result) -> set:
    """The CUDA devices of the tensors in ``result`` (nested lists, tuples
    and dicts)."""
    if torch.is_tensor(result):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*map(_cuda_devices, result)) if result else set()
    return set()


class StepTimer:
    """Wall-clock step timer that waits for the card at mark points.

        timer = StepTimer()
        for batch in loader:
            out = step(batch)
            timer.mark(out)     # waits on out's cards, records the interval
        print(timer.summary())
    """

    def __init__(self):
        self.times: List[float] = []
        self._last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def mark(self, result=None) -> float:
        """Wait for every card that holds a tensor of ``result``, then
        record the seconds since the last mark (or ``start``)."""
        for device in _cuda_devices(result):
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        dt = 0.0 if self._last is None else now - self._last
        if self._last is not None:
            self.times.append(dt)
        self._last = now
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {"steps": len(arr), "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "p95_s": float(np.percentile(arr, 95)),
                "total_s": float(arr.sum())}
