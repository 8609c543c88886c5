"""The port's spans (utils/profiling.py:annotate) on the CPU: off, a shared
no-op; under a profiler, on the trace's timeline and in ``span_totals``;
where the serving program, ``predict_stream`` and the pretrain step open
them, with the same outputs traced or not; and the benchmark's readers of
them (``benchmark/metrics/*``)."""
import glob
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness.spec import Bench
from dino_tpu_torch import DINOSeg, serving
from dino_tpu_torch.models.vit import ViTConfig
from dino_tpu_torch.train import dino_pretrain as tdp
from dino_tpu_torch.utils import profiling
from dino_tpu_torch.utils.profiling import (annotate, device_trace,
                                            reset_spans, span_totals)

ROOT = Path(__file__).resolve().parents[1]
RES = 32
SERVE = {"serve.call", "serve.check", "serve.key", "serve.launch",
         "serve.labels"}
PRETRAIN = {"pretrain.step", "pretrain.student", "pretrain.teacher",
            "pretrain.loss", "pretrain.backward", "pretrain.update",
            "pretrain.clip", "pretrain.adamw", "pretrain.ema",
            "pretrain.center"}


@pytest.fixture(autouse=True)
def clean_spans():
    reset_spans()
    yield
    reset_spans()


def _trace_events(logdir, names):
    """The trace's host events whose name starts with one of ``names``."""
    (path,) = glob.glob(os.path.join(logdir, "*.json"))
    with open(path) as fh:
        return [e for e in json.load(fh)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                and e["name"].startswith(names)]


def _counts():
    return {name: t["count"] for name, t in span_totals().items()}


@pytest.fixture(scope="module")
def model():
    m = DINOSeg(head="linear", n_blocks=1, n_classes=4, random_init=True,
                seed=0, precision="fp32", device="cpu")
    m.set_resolution(RES)
    return m


def _frames(n, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (n, 40, 48, 3),
                                               np.uint8)


# ---------------------------------------------------------------------------
# the span
# ---------------------------------------------------------------------------

def test_off_a_span_is_the_shared_noop(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(profiling, "_record_function", refuse)
    off = annotate("a")
    assert off is annotate("b") is annotate("c", device=True)
    with off:
        with annotate("d"):
            torch.ones(2) + 1
    assert span_totals() == {}


def test_under_a_profiler_spans_land_in_the_trace_and_the_totals(tmp_path):
    with device_trace(str(tmp_path)) as logdir:
        with annotate("outer"):
            for _ in range(2):
                with annotate("inner"):
                    torch.ones(8, 8) @ torch.ones(8, 8)
    names = [e["name"] for e in _trace_events(logdir, ("outer", "inner"))]
    assert names.count("outer") == 1 and names.count("inner") == 2
    totals = span_totals()
    assert {n: t["count"] for n, t in totals.items()} == {"outer": 1,
                                                          "inner": 2}
    assert 0 < totals["inner"]["host_s"] <= totals["outer"]["host_s"]
    assert totals["outer"]["device_s"] is None


def test_reset_spans_clears_the_totals(tmp_path):
    with device_trace(str(tmp_path)):
        with annotate("x", device=True):
            pass
    assert _counts() == {"x": 1}
    reset_spans()
    assert span_totals() == {}


# ---------------------------------------------------------------------------
# the program's spans: the same outputs traced or not
# ---------------------------------------------------------------------------

def test_predict_program_spans_and_same_maps(model, tmp_path):
    program = serving.predict_program(model, 2, (40, 48))
    frames = _frames(2)
    off = program(frames)
    assert span_totals() == {}
    with device_trace(str(tmp_path)):
        on = program(frames)
        with torch.no_grad():  # an in-place write: the next call rebuilds
            next(model.model.parameters()).add_(0)
        again = program(frames)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(again, off)
    counts = _counts()
    assert counts == {**{n: 2 for n in SERVE}, "serve.build": 1}
    assert program.builds == 2


def test_predict_stream_spans_and_same_maps(model, tmp_path):
    frames = _frames(5, seed=1)
    off = list(model.predict_stream(iter(frames), batch_size=2))
    with device_trace(str(tmp_path)):
        on = list(model.predict_stream(iter(frames), batch_size=2))
    assert len(on) == len(off) == 5
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    # 5 frames, 3 batches (the last padded)
    assert _counts() == {"stream.stage": 5, "stream.submit": 3,
                         "stream.wait": 3, "stream.labels": 3}


def test_no_stream_span_stays_open_across_a_yield(model, tmp_path):
    """The consumer takes one map at a time inside its own span: a stream
    span left open across a yield would overlap two of them."""
    with device_trace(str(tmp_path)) as logdir:
        stream = model.predict_stream(iter(_frames(5, seed=2)),
                                      batch_size=2)
        for _ in range(5):
            with annotate("consumer.take"):
                next(stream)
            with annotate("consumer.between"):
                pass
        stream.close()
    events = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
              for e in _trace_events(logdir, ("stream.", "consumer."))]
    assert sum(n.startswith("stream.") for _, _, n in events) == 14
    eps = 0.5  # us: the trace's rounding
    for s0, e0, n0 in events:
        for s1, e1, n1 in events:
            disjoint = e0 <= s1 + eps or e1 <= s0 + eps
            nested = ((s0 <= s1 + eps and e1 <= e0 + eps)
                      or (s1 <= s0 + eps and e0 <= e1 + eps))
            assert disjoint or nested, (n0, n1)
    for s, e, n in events:
        if n.startswith("stream."):
            assert any(s0 <= s + eps and e <= e0 + eps
                       for s0, e0, n0 in events if n0 == "consumer.take"), n


def _pretrain_state():
    cfg = ViTConfig(patch_size=8, embed_dim=32, num_heads=2)
    dcfg = tdp.DinoConfig(out_dim=16, n_local_crops=2, global_size=16,
                          local_size=8, hidden_dim=32, bottleneck_dim=8)
    student, teacher = tdp.init_dino_params(torch.Generator().manual_seed(0),
                                            cfg, dcfg, depth=1,
                                            device="cpu")
    opt = tdp.make_dino_optimizer(student)
    center = torch.zeros(1, dcfg.out_dim)
    return cfg, dcfg, student, teacher, opt, center


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_pretrain_step_spans_and_same_state(accum_steps, tmp_path):
    rs = np.random.RandomState(0)
    g = torch.from_numpy(rs.randint(0, 255, (2, 4, 16, 16, 3), np.uint8))
    loc = torch.from_numpy(rs.randint(0, 255, (2, 4, 8, 8, 3), np.uint8))
    results = []
    for traced in (False, True):
        cfg, dcfg, student, teacher, opt, center = _pretrain_state()
        step = tdp.make_dino_train_step(cfg, dcfg, accum_steps=accum_steps)
        if traced:
            with device_trace(str(tmp_path)):
                loss = step(student, teacher, center, opt, g, loc, 0.04,
                            0.99, 0.0)
        else:
            loss = step(student, teacher, center, opt, g, loc, 0.04, 0.99,
                        0.0)
            assert span_totals() == {}
        results.append((loss, student.state_dict(), teacher.state_dict(),
                        center))
    (l0, s0, t0, c0), (l1, s1, t1, c1) = results
    assert torch.equal(l0, l1) and torch.equal(c0, c1)
    for a, b in ((s0, s1), (t0, t1)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    per_mb = {"pretrain.student", "pretrain.teacher", "pretrain.loss",
              "pretrain.backward"}
    assert _counts() == {n: accum_steps if n in per_mb else 1
                         for n in PRETRAIN}
    totals = span_totals()
    assert all(t["device_s"] is None for t in totals.values())
    phases = sum(totals[n]["host_s"] for n in per_mb | {"pretrain.update"})
    assert phases <= totals["pretrain.step"]["host_s"]


# ---------------------------------------------------------------------------
# the benchmark's readers of the spans
# ---------------------------------------------------------------------------

def _t(count, host_s, device_s=None):
    return {"count": count, "host_s": host_s, "device_s": device_s}


READERS = {
    "host_ms.frame": ({"serve.call": _t(100, 0.2), "serve.wait": _t(100, 0.05),
                       "serve.stage": _t(100, 0.01)}, 1.5),
    "stage_ms.stream": ({"stream.stage": _t(128, 0.064),
                         "stream.submit": _t(8, 0.016)}, 0.5),
    "host_ms.stream": ({"stream.stage": _t(128, 0.064),
                        "stream.submit": _t(8, 0.016),
                        "stream.wait": _t(8, 1.0),
                        "stream.labels": _t(8, 0.048)}, 1.0),
    "enqueue_ms.pretrain": ({"pretrain.step": _t(3, 0.3, 0.99)}, 100.0),
    "update_ms.pretrain": ({"pretrain.step": _t(3, 0.3, 0.99),
                            "pretrain.update": _t(3, 0.01, 0.06)}, 20.0),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers(name, monkeypatch):
    read = Bench(ROOT).reader(name).read
    totals, want = READERS[name]
    monkeypatch.setattr(profiling, "span_totals", lambda: {})
    assert read(None) is None
    monkeypatch.setattr(profiling, "span_totals", lambda: totals)
    assert read(None) == pytest.approx(want, rel=1e-12)
    # a port without spans (the parent of this change): nothing to read
    monkeypatch.delattr(profiling, "span_totals")
    assert read(None) is None


def test_update_reader_needs_device_time(monkeypatch):
    read = Bench(ROOT).reader("update_ms.pretrain").read
    monkeypatch.setattr(profiling, "span_totals", lambda: {
        "pretrain.step": _t(3, 0.3), "pretrain.update": _t(3, 0.01)})
    assert read(None) is None
