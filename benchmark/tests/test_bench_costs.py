"""The kernels' and models' operation and byte counts reproduce the
bounds PERF.md's kernel table gives (bf16 at 989 TFLOP/s, 3.35 TB/s), and
the roofline reader's sum over a launch mix."""
import json
import types

import pytest

from benchmark.harness.roofline import roofline_share
from benchmark.harness.spec import Bench
from benchmark.harness.trace import TraceSummary
from benchmark.tests.conftest import ROOT

H100 = "NVIDIA H100 80GB HBM3"
BENCH = Bench(ROOT)


def bound_ms(kernel, **shape):
    c = BENCH.costs(kernel)
    return 1e3 * max(c.flops(**shape) / 989e12,
                     c.bytes_moved(**shape) / 3.35e12)


@pytest.mark.parametrize("kernel,shape,want", [
    # row 1: the 480px batch-3 predict, B*nh 18, N 3,601
    ("flash_fwd_bf16", dict(bh=18, n=3601, hd=64), 0.0604),
    # row 2: the fused MLP over its 3 x 3,601 rows
    ("fused_ln_mlp", dict(m=3 * 3601, d=384, h=1536), 0.0258),
    # row 3: the train microbatch's backward, B*nh 12
    ("flash_bwd_bf16", dict(bh=12, n=3601, hd=64), 0.1007),
])
def test_bounds_match_the_kernel_table(kernel, shape, want):
    assert bound_ms(kernel, **shape) == pytest.approx(want, abs=5e-5)


def test_small_crops_are_bound_by_bytes():
    """At the local crops' N 145 the backward moves more than it computes
    at the card's ratio: its bound is the bytes'."""
    c = BENCH.costs("flash_bwd_bf16")
    shape = dict(bh=3072, n=145, hd=64)
    assert c.bytes_moved(**shape) / 3.35e12 > c.flops(**shape) / 989e12


def test_model_flops():
    seg = json.loads((ROOT / "benchmark/configs/dinoseg-vits8-3blk.json")
                     .read_text())
    pre = json.loads((ROOT / "benchmark/configs/dino-vits8-pretrain.json")
                     .read_text())
    vf = BENCH.costs("vit_forward")
    # 3 blocks at N 3,601: 3 x (24 N D^2 + 4 N^2 D), with the patch
    # embedding and the head (~1.3% more)
    n, d = 3601, 384
    blocks = 3 * (24 * n * d * d + 4 * n * n * d)
    assert vf.seg_frame_flops(seg, 480) == pytest.approx(blocks, rel=0.02)
    # ~517 GFLOP an image of the pretrain step
    assert BENCH.costs("dino_pretrain").image_flops(pre) == pytest.approx(
        517e9, rel=0.01)


def test_roofline_share_over_a_mix():
    summary = TraceSummary(window_s=1.0, busy_s=0.5,
                           kernel_s={"(ns)::flash_fwd_bf16(x)": 3 * 1e-3},
                           kernel_n={"(ns)::flash_fwd_bf16(x)": 6},
                           copy_s={}, idle_by_host=[])
    mix = [(1, dict(bh=18, n=3601, hd=64)), (1, dict(bh=18, n=3601, hd=64))]
    r = types.SimpleNamespace(trace=summary, device_kind=H100, bench=BENCH,
                              launches={"flash_fwd_bf16": mix})
    share = roofline_share(r, "flash_fwd_bf16")
    # six launches of 0.0604 ms bound in 3 ms
    assert share == pytest.approx(100 * 6 * 0.060417 / 3.0, rel=1e-3)
    r.device_kind = "another card"
    assert roofline_share(r, "flash_fwd_bf16") is None
