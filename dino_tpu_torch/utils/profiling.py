"""Profiling: a device trace, named spans and a step timer.

The counterpart of ``dino_tpu/utils/profiling.py`` on ``torch.profiler``:
``device_trace`` records the CPU's and, with a card, the card's activity
and writes a Chrome trace (Perfetto and ``chrome://tracing`` open it);
``StepTimer`` waits for the card before it reads the clock.  ``hbm_stats``
is ``utils/logging.py``'s.

``annotate(name)`` is the port's span.  The serving program
(``serve.*``), ``predict_stream`` (``stream.*``), the pretrain step
(``pretrain.*``) and a DINOv3 block (``vit.rope``, ``vit.mlp``) open
spans where their work happens.  A span is on exactly while a
``torch.profiler`` records on the calling thread (the profiler's flag is
the thread's), so an operator turns them on by running the code under
``device_trace`` (or any profiler):

    reset_spans()
    with device_trace("runs/trace"):
        for frame in frames:
            program(frame[None])
    span_totals()["serve.call"]  # {"count", "host_s", "device_s": None}

On, a span is a record function of its name (an event on the trace's
timeline, the profiler's clock, beside the card's kernels and copies)
and, on the card, an NVTX range; its host seconds and a count are added
to a process-wide registry, which ``span_totals()`` reads and
``reset_spans()`` clears.  ``annotate(name, device=True)`` also records a
CUDA event on the current stream at entry and at exit, resolved into
device seconds when the totals are read.  Off, a span checks the
profiler's flag once and returns a shared no-op context: no clock read,
no allocation.  No span stays open across a ``yield``.

A device span opened while its stream is captured into a CUDA graph
records no events (its device seconds are left out).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

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


class _Total:
    """One name's totals: closed spans, host seconds, device seconds and
    the (start, end) CUDA events not yet resolved into them."""
    __slots__ = ("count", "host_s", "device_s", "pending")

    def __init__(self):
        self.count, self.host_s = 0, 0.0
        self.device_s: Optional[float] = None
        self.pending: list = []


_LOCK = threading.Lock()
_TOTALS: Dict[str, _Total] = {}
_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled
# record_function's C++ core: the same named event on the trace (as a
# ``cpu_op``, not a ``user_annotation``) at a tenth of record_function's
# host time under a profiler
_record_function = torch._C._profiler._RecordFunctionFast


class _Span:
    """An open span while a profiler records (see :func:`annotate`)."""
    __slots__ = ("name", "device", "nvtx", "region", "events", "t0")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.nvtx = torch.cuda.is_initialized()
        self.device = (device and self.nvtx
                       and not torch.cuda.is_current_stream_capturing())

    def __enter__(self):
        self.region = _record_function(self.name)
        self.region.__enter__()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        if self.device:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        if self.device:
            self.events[1].record()
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        self.region.__exit__(*exc)
        with _LOCK:
            total = _TOTALS.get(self.name)
            if total is None:
                total = _TOTALS[self.name] = _Total()
            total.count += 1
            total.host_s += host_s
            if self.device:
                total.pending.append(self.events)
        return False


def annotate(name: str, device: bool = False):
    """A span named ``name``: ``with annotate("serve.stage"): ...``.

    While a ``torch.profiler`` records, a record function of ``name`` (an
    event on the trace's timeline) and, once CUDA is in use, an NVTX range
    of the same name; its host seconds and a count go to :func:`span_totals`.
    ``device=True`` (CUDA in use) also times the span on the current
    stream with two CUDA events.  While none records, a shared no-op
    context."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, device)


def span_totals() -> Dict[str, dict]:
    """``{name: {"count", "host_s", "device_s"}}`` of the spans closed since
    :func:`reset_spans` (or the process's start); ``device_s`` is None for
    a name never timed on the card.  Waits for the card's pending events."""
    with _LOCK:
        pending = [(total, total.pending) for total in _TOTALS.values()
                   if total.pending]
        for total, _ in pending:
            total.pending = []
    for total, events in pending:
        device_s = 0.0
        for start, end in events:
            end.synchronize()
            device_s += start.elapsed_time(end) * 1e-3
        with _LOCK:
            total.device_s = (total.device_s or 0.0) + device_s
    with _LOCK:
        return {name: {"count": t.count, "host_s": t.host_s,
                       "device_s": t.device_s}
                for name, t in _TOTALS.items()}


def reset_spans() -> None:
    """Clear :func:`span_totals`."""
    with _LOCK:
        _TOTALS.clear()


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
