"""Reducing a ``torch.profiler`` trace to the numbers the per-layer
metrics read.

The profiled span is the ``bench.traced`` region (``record_function``)
that the harness wraps around a driver's traced iterations, ended by a
synchronize.  From the Chrome trace the profiler exports:

  * device busy seconds: the union of the intervals of the device's
    kernels, copies and memsets inside the span (not their sum), averaged
    over the devices;
  * seconds and launches of each kernel by name, and of the copies;
  * the idle gaps (the span less the union), each labelled with the host
    op that was running at its middle: the shortest host event of any
    thread that contains that instant;
  * the collectives' seconds (the union of the kernels whose name holds
    ``nccl``), and of those the seconds in which no other kernel, copy or
    memset runs (exposed), averaged over the devices.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_LEN = 100
COMM = "nccl"  # in the name of every NCCL collective's kernel


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]      # seconds by kernel name
    kernel_n: Dict[str, int]        # launches by kernel name
    copy_s: Dict[str, float]        # seconds by copy or memset name
    idle_by_host: List[Tuple[str, float]]
    comm_s: float = 0.0             # collectives' union, a device's mean
    comm_exposed_s: float = 0.0     # the part no other device op covers

    def kernels_like(self, part: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds ``part``."""
        keys = [k for k in self.kernel_s if part in k]
        return (sum(self.kernel_s[k] for k in keys),
                sum(self.kernel_n[k] for k in keys))

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        ops = dict(self.kernel_s)
        for k, v in self.copy_s.items():
            ops[k] = ops.get(k, 0.0) + v
        return sorted(ops.items(), key=lambda kv: -kv[1])[:top]


def _overlap(a: List[Tuple[float, float]],
             b: List[Tuple[float, float]]) -> float:
    """The length of the intersection of two unions (each sorted and
    disjoint)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class _HostIndex:
    """Innermost host event at an instant, per thread: events of one
    thread nest, so the containing event that started last is the
    innermost; each event keeps its parent to walk outwards."""

    def __init__(self, events: List[dict]):
        by_tid = defaultdict(list)
        for e in events:
            by_tid[e.get("tid")].append((float(e["ts"]),
                                         float(e["ts"]) + float(e["dur"]),
                                         e["name"]))
        self.threads = []
        for evs in by_tid.values():
            evs.sort(key=lambda t: (t[0], -t[1]))
            parents, stack = [], []
            for i, (s, e, _) in enumerate(evs):
                while stack and evs[stack[-1]][1] < s:
                    stack.pop()
                parents.append(stack[-1] if stack else -1)
                stack.append(i)
            self.threads.append(([t[0] for t in evs], evs, parents))

    def at(self, t: float) -> Optional[str]:
        best = None
        for starts, evs, parents in self.threads:
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0 and evs[i][1] < t:
                i = parents[i]
            if i >= 0:
                dur = evs[i][1] - evs[i][0]
                if best is None or dur < best[0]:
                    best = (dur, evs[i][2])
        return None if best is None else best[1]


def reduce_events(events: List[dict]) -> Optional[TraceSummary]:
    """The summary of a trace's events, or None when it has no
    ``bench.traced`` region."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW
           and str(e.get("cat", "")).lower() == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in xs if str(e.get("cat", "")).lower() in DEVICE_CATS
           and w0 <= float(e["ts"]) <= w1]
    host = [e for e in xs if str(e.get("cat", "")).lower() in HOST_CATS
            and e is not win[0]]
    kernel_s: Dict[str, float] = defaultdict(float)
    kernel_n: Dict[str, int] = defaultdict(int)
    copy_s: Dict[str, float] = defaultdict(float)
    per_dev = defaultdict(list)
    comm_dev = defaultdict(list)   # a device's collectives
    other_dev = defaultdict(list)  # its other kernels, copies and memsets
    for e in dev:
        s = float(e["ts"])
        d = float(e["dur"])
        per_dev[e.get("pid")].append((s, min(s + d, w1)))
        is_comm = (str(e["cat"]).lower() == "kernel"
                   and COMM in str(e["name"]).lower())
        (comm_dev if is_comm else other_dev)[e.get("pid")].append(
            (s, min(s + d, w1)))
        name = str(e["name"])[:NAME_LEN]
        if str(e["cat"]).lower() == "kernel":
            kernel_s[name] += d * 1e-6
            kernel_n[name] += 1
        else:
            copy_s[name] += d * 1e-6
    unions = [_union(iv) for iv in per_dev.values()]
    busy = (sum(sum(e - s for s, e in u) for u in unions) / len(unions)
            if unions else 0.0)
    comm = exposed = 0.0
    for pid in per_dev:
        c = _union(comm_dev[pid])
        c_s = sum(e - s for s, e in c)
        comm += c_s
        exposed += c_s - _overlap(c, _union(other_dev[pid]))
    if per_dev:
        comm, exposed = comm / len(per_dev), exposed / len(per_dev)
    gaps: List[Tuple[float, float]] = []
    for u in unions or [[]]:
        t = w0
        for s, e in u:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
    index = _HostIndex(host)
    idle: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        label = index.at(0.5 * (s + e)) or "(host outside any traced op)"
        idle[str(label)[:NAME_LEN]] += (e - s) * 1e-6
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
        kernel_s=dict(kernel_s),
        kernel_n=dict(kernel_n), copy_s=dict(copy_s),
        idle_by_host=sorted(idle.items(), key=lambda kv: -kv[1]),
        comm_s=comm * 1e-6, comm_exposed_s=exposed * 1e-6)


def reduce_profile(prof) -> Optional[TraceSummary]:
    """Export ``prof`` (a finished ``torch.profiler.profile``) to a Chrome
    trace in the temporary directory, reduce it, and delete the file."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return reduce_events(events)
