"""Training progress meters: the port of ``dino_tpu``'s
``utils/meters.py`` (the reference's SmoothedValue and MetricLogger).

A numpy ring buffer holds the smoothing window; ``log_every`` meters the
data and step time and prints rate, ETA, the meters and the card's peak
memory.  Across processes the (count, total) pairs are summed with
``torch.distributed`` when a process group is initialized.
"""
from __future__ import annotations

import datetime
import time
from collections import defaultdict
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from dino_tpu_torch.parallel import dist as pdist


class SmoothedValue:
    """Scalar series: windowed median/avg/max and a global average."""

    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        self._ring = np.zeros(max(int(window_size), 1), np.float64)
        self._writes = 0
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.6f} ({global_avg:.6f})"

    def update(self, value, n: int = 1) -> None:
        self._ring[self._writes % self._ring.size] = float(value)
        self._writes += 1
        self.count += n
        self.total += float(value) * n

    def _window(self) -> np.ndarray:
        return self._ring[:min(self._writes, self._ring.size)]

    def synchronize_between_processes(self) -> None:
        """Sum count and total over the process group (a no-op without
        one)."""
        if pdist.get_world_size() == 1:
            return
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        pair = torch.tensor([self.count, self.total], dtype=torch.float64,
                            device=device)
        pdist.all_reduce_sum_([pair])
        self.count, self.total = int(pair[0]), float(pair[1])

    @property
    def median(self) -> float:
        w = self._window()
        return float(np.median(w)) if w.size else 0.0

    @property
    def avg(self) -> float:
        w = self._window()
        return float(w.mean()) if w.size else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        w = self._window()
        return float(w.max()) if w.size else 0.0

    @property
    def value(self) -> float:
        if not self._writes:
            return 0.0
        return float(self._ring[(self._writes - 1) % self._ring.size])

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


def _peak_device_mem_mb() -> Optional[float]:
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.max_memory_allocated() / 2.0 ** 20


class MetricLogger:
    """Named SmoothedValues and a timed progress generator."""

    def __init__(self, delimiter: str = "\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for name, v in kwargs.items():
            v = float(v) if hasattr(v, "item") else v
            assert isinstance(v, (float, int)), (name, type(v))
            self.meters[name].update(v)

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def __getattr__(self, attr):
        meters = self.__dict__.get("meters")
        if meters is not None and attr in meters:
            return meters[attr]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{attr}'")

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def _progress_line(self, i: int, n: int, step: SmoothedValue,
                       data: SmoothedValue) -> str:
        remaining = step.global_avg * (n - i)
        parts = [
            f"[{i:{len(str(n))}d}/{n}]",
            f"eta: {datetime.timedelta(seconds=int(remaining))}",
            str(self),
            f"time: {step.avg:.6f}",
            f"data: {data.avg:.6f}",
        ]
        mem = _peak_device_mem_mb()
        if mem is not None:
            parts.append(f"max mem: {mem:.0f}")
        return self.delimiter.join(parts)

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = ""):
        """Yield the items of a sized iterable, printing a progress line
        every ``print_freq`` items and the total time at the end."""
        n = len(iterable)
        step_time = SmoothedValue(fmt="{avg:.6f}")
        data_time = SmoothedValue(fmt="{avg:.6f}")
        started = prev = time.perf_counter()
        for i, item in enumerate(iterable):
            data_time.update(time.perf_counter() - prev)
            yield item
            now = time.perf_counter()
            step_time.update(now - prev)
            prev = now
            if i % print_freq == 0 or i == n - 1:
                print(f"{header}{self.delimiter}"
                      f"{self._progress_line(i, n, step_time, data_time)}")
        elapsed = time.perf_counter() - started
        print(f"{header} Total time: "
              f"{datetime.timedelta(seconds=int(elapsed))} "
              f"({elapsed / max(n, 1):.6f} s / it)")
