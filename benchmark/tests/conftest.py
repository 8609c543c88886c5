"""A small copy of the benchmark for runs on the CPU: the same files,
with the configurations and traffic cut to sizes a test run holds (the
segmentation model keeps the port's fixed ViT-S widths)."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEG_TRAFFIC = dict(frame_hw=[32, 48], pool_frames=8, check_frames=4,
                   check_block=2, trace_batches=2, trace_calls=3,
                   warmup_calls=2, warmup_batches=1)
PRETRAIN_CONFIG = dict(embed_dim=64, num_heads=2, depth=1, out_dim=256,
                       hidden_dim=64, bottleneck_dim=32, global_crops_size=32,
                       local_crops_size=16, local_crops_number=2,
                       batch_size_per_gpu=4)


def edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def make_small_root(dst: Path) -> Path:
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns(".build", "__pycache__",
                                                  "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    b = dst / "benchmark"
    edit(b / "configs" / "dinoseg-vits8-3blk.json", depth=1)
    edit(b / "configs" / "dino-vits8-pretrain.json", **PRETRAIN_CONFIG)
    for name, res, batch in (("stream-480-b16", 32, 2),
                             ("stream-960-b4", 64, 2),
                             ("frame-480-b1", 32, 1)):
        edit(b / "workloads" / f"{name}.json", resolution=res,
             batch_size=batch, **SEG_TRAFFIC)
    edit(b / "workloads" / "pretrain-b64.json", pool_batches=4,
         check_microbatch=2)
    return dst


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    return make_small_root(tmp_path_factory.mktemp("bench"))
