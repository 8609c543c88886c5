"""One client sending one frame at a time through the serving program
(``serving.predict_program``: a CUDA graph of the predict path, the
frame copied in through pinned memory, the map copied out).

Each frame is sent when the previous map is back.  A frame's latency is
the host time from handing it to the program to holding its map;
``frame_p95_ms`` is the 95th percentile over every frame of the window
and ``frames_per_s`` the frames over the window's seconds.  The check
compares a seeded sample of the window's maps with the reference.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import seg
from benchmark.harness.cell import Window


class Driver:
    def __init__(self, run):
        self.run = run
        self.tr = run.cell.traffic
        self.sent = 0

    def _call(self) -> np.ndarray:
        frame = self.pool[self.order[self.sent % len(self.order)]]
        self.sent += 1
        return self.program(frame[None])[0]

    def setup(self) -> None:
        from dino_tpu_torch import serving
        self.model = seg.build_model(self.run)
        self.pool = seg.frame_pool(self.run)
        self.order = seg.frame_order(self.run)
        self.program = serving.predict_program(
            self.model, self.tr["batch_size"], tuple(self.tr["frame_hw"]),
            self.run.cell.config["precision"])
        for _ in range(self.tr["warmup_calls"]):
            self._call()

    def window(self) -> Window:
        sample = seg.Reservoir(self.tr["check_frames"], self.run.seed)
        lat = []
        wall = time.time()
        t0 = time.perf_counter()
        deadline = t0 + self.run.seconds
        now = t0
        while now < deadline:
            index = self.sent
            sent = time.perf_counter()
            m = self._call()
            now = time.perf_counter()
            lat.append(now - sent)
            sample.offer(index, m)
        seconds = now - t0
        self.sample = sample.items
        n = len(lat)
        return Window(t_start=wall, seconds=seconds, attempted=n, failed=0,
                      work={"frames": n},
                      metrics={"frames_per_s": n / seconds,
                               "frame_p95_ms":
                                   float(np.percentile(lat, 95)) * 1e3})

    def traced(self) -> dict:
        n = self.tr["trace_calls"]
        for _ in range(n):
            self._call()
        return {"iterations": n, "frames": n}

    def launches(self) -> dict:
        return seg.launches(self.run, self.tr["batch_size"])

    def release(self) -> None:
        del self.program, self.model
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
            torch.cuda.empty_cache()

    def check(self) -> dict:
        return seg.check_maps(self.run, self.pool, self.order, self.sample)


def control(run) -> dict:
    return seg.control(run, Driver)


FAULTS = {"altered_answer":
          lambda: seg.altered_answers("dino_tpu_torch.serving")}
