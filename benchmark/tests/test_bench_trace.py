"""The trace reduction: busy time is the union of the device's intervals,
idle gaps are labelled with the innermost host op at their middle."""
from benchmark.harness.trace import reduce_events


def ev(name, cat, ts, dur, pid=1, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid}


def test_union_kernels_copies_and_gaps():
    events = [
        ev("bench.traced", "user_annotation", 0, 100),
        ev("step", "user_annotation", 0, 60),
        ev("aten::copy_", "cpu_op", 10, 30),
        ev("aten::mm", "cpu_op", 70, 20, tid=2),
        ev("k1", "kernel", 0, 10, pid=0, tid=7),
        ev("k2", "kernel", 5, 10, pid=0, tid=8),     # overlaps k1
        ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 50, 20, pid=0),
        ev("k1", "kernel", 95, 10, pid=0, tid=7),    # runs past the span
        ev("gpu annotation", "gpu_user_annotation", 0, 100, pid=0),
    ]
    t = reduce_events(events)
    assert abs(t.window_s - 100e-6) < 1e-12
    # [0, 15] + [50, 70] + [95, 100]
    assert abs(t.busy_s - 40e-6) < 1e-12
    assert t.kernel_n == {"k1": 2, "k2": 1}
    assert abs(t.kernel_s["k1"] - 20e-6) < 1e-12
    assert t.kernels_like("k")[1] == 3
    assert abs(t.copy_s["Memcpy HtoD (Pinned -> Device)"] - 20e-6) < 1e-12
    idle = dict(t.idle_by_host)
    # [15, 50]: middle 32.5 inside aten::copy_; [70, 95]: middle 82.5
    # inside aten::mm on another thread
    assert abs(idle["aten::copy_"] - 35e-6) < 1e-12
    assert abs(idle["aten::mm"] - 25e-6) < 1e-12
    assert t.device_ops(2)[0][0] in ("k1", "Memcpy HtoD (Pinned -> Device)")


def test_no_span_no_summary():
    assert reduce_events([ev("k1", "kernel", 0, 10, pid=0)]) is None


def test_collectives_and_their_exposed_part():
    """A collective's seconds are the union of the ``nccl`` kernels; its
    exposed part is what no other kernel, copy or memset of the same
    device covers; both a device's mean."""
    events = [
        ev("bench.traced", "user_annotation", 0, 100),
        ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "kernel", 10, 40,
           pid=0, tid=9),
        ev("gemm", "kernel", 0, 20, pid=0, tid=7),       # hides [10, 20]
        ev("Memcpy DtoD", "gpu_memcpy", 40, 5, pid=0),   # hides [40, 45]
        ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "kernel", 60, 10,
           pid=1, tid=9),                                # all exposed
    ]
    t = reduce_events(events)
    assert abs(t.comm_s - (40e-6 + 10e-6) / 2) < 1e-12
    assert abs(t.comm_exposed_s - (25e-6 + 10e-6) / 2) < 1e-12
    assert t.kernels_like("nccl")[1] == 2


def test_no_collective_reads_zero():
    t = reduce_events([ev("bench.traced", "user_annotation", 0, 100),
                       ev("k1", "kernel", 0, 10, pid=0)])
    assert t.comm_s == 0.0 and t.comm_exposed_s == 0.0
