"""The DINOv3 configuration's cell on the CPU at a small size: it finds
its parts from files alone, a sound run comes out correct, and each
planted fault comes out not correct (a label map altered where it is
made; q and k left unrotated), as does the fp8 control.  The widths are
cut for the CPU (D 128, 2 heads of 64, 2 blocks, SwiGLU 256, 128px) in
the copy's configuration and in the port's factory alike, qkv's init std
raised by sqrt(1280 / 128) to keep the attention scores' scale of the
published width (at D 128 the configuration's 0.05 leaves attention near
uniform, and the rotation hardly moves a map)."""
import contextlib
import functools
import json
import time

import pytest

from benchmark.harness.cell import run_cell
from benchmark.harness.spec import Bench
from benchmark.tests.conftest import SEG_TRAFFIC, edit, make_small_root

V3 = dict(embed_dim=128, num_heads=2, depth=2, ffn_hidden=256,
          head_dims=[128, 200, 100, 7])
V3_CELL = "seg-stream-vith16p-960-b4"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    dst = make_small_root(tmp_path_factory.mktemp("bench_v3"))
    b = dst / "benchmark"
    cfg = json.loads((b / "configs" / "dinov3-vith16plus-seg.json")
                     .read_text())
    assert cfg["init"][0][:2] == ["*.attn.qkv.weight", "trunc_normal"]
    cfg["init"][0][2] *= (1280 / 128) ** 0.5
    edit(b / "configs" / "dinov3-vith16plus-seg.json", init=cfg["init"],
         **V3)
    edit(b / "workloads" / "vith16p-stream-960-b4.json", resolution=128,
         batch_size=2, **{**SEG_TRAFFIC, "frame_hw": [96, 128]})
    return dst


@pytest.fixture
def small_v3(monkeypatch):
    from dino_tpu_torch.models import vit
    monkeypatch.setitem(vit.VIT_BACKBONES, "dinov3_vith16plus",
                        functools.partial(vit.dinov3_vith16plus,
                                          embed_dim=128, num_heads=2,
                                          ffn_hidden=256))


def run(root, seed, fault=None):
    bench = Bench(root)
    driver = bench.driver(bench.cell(V3_CELL))
    with driver.FAULTS[fault]() if fault else contextlib.nullcontext():
        return run_cell(bench, V3_CELL, seed, 0.3, False, "cpu", time.time(),
                        log=lambda s: None)


def test_the_cell_finds_its_parts_from_files(root):
    bench = Bench(root)
    c = bench.cell(V3_CELL)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    mine = [m["name"] for m in spec["per_layer"]
            if V3_CELL in m.get("workloads", [])]
    assert [m["name"] for m in c.per_layer] == mine and mine
    assert {m["name"] for m in c.end_to_end} == {"setup_s",
                                                 "frames_per_s_960"}
    assert bench.driver(c).FAULTS and c.limits == {"label_far": c.limits[
        "label_far"]}


def test_a_sound_run_is_correct(root, small_v3):
    line = run(root, 2 ** 31 + 21)
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("fault", ["altered_answer", "no_rope"])
def test_a_planted_fault_is_not_correct(root, small_v3, fault):
    line = run(root, 2 ** 31 + 22, fault)
    assert not line["correct"], line["compared"]


def test_the_v3_control_is_not_correct(root):
    """The reference with fp8 products in the program's place, against the
    float32 reference, at the small size."""
    import torch
    from benchmark.harness.cell import Run
    bench = Bench(root)
    c = bench.cell(V3_CELL)
    numbers = bench.driver(c).control(Run(cell=c, seed=2 ** 31 + 23,
                                          seconds=0.0,
                                          device=torch.device("cpu"),
                                          trace=False))
    assert numbers["label_far"] > c.limits["label_far"], numbers
