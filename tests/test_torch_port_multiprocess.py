"""DINOSeg.fit and evaluate under a torch.distributed world: a world of two
trains one replica (each rank its slab of every batch, rank 0 alone writing
the checkpoint) and evaluates each sample once, with the world of one's
results; a world of one still fits.

The ranks are real gloo processes (``subprocess``, a FileStore under the
test's temporary directory) that import neither jax nor dino_tpu.
:func:`spawn_ranks` is shared with tests/test_torch_port_moe.py.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch.distributed as dist

from dino_tpu_torch import DINOSeg
from dino_tpu_torch.data.dataset import DuckieSegDataset
from dino_tpu_torch.parallel import dist as pd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 300  # seconds per rank process: a hang fails, not stalls


class MemorySplit(DuckieSegDataset):
    """2 frames of 64x64 (3 classes) held in memory."""
    from_jpeg_files = False

    def __init__(self, augmented, resolution, backend="auto"):
        super().__init__("in-memory", augmented=augmented,
                         resolution=resolution, backend=backend)
        rs = np.random.RandomState(0)
        self.frames = rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
        self.masks = rs.randint(0, 3, (2, 64, 64)).astype(np.int32)

    def __len__(self):
        return 2

    def _load_mask(self, idx):
        return self.masks[idx]

    def _load_raw(self, idx):
        return self.frames[idx], self.masks[idx]


class MemoryDINOSeg(DINOSeg):
    """DINOSeg whose every split is :class:`MemorySplit`."""

    def _make_dataset(self, path, augmented, resolution, backend="auto"):
        return MemorySplit(augmented, resolution, backend)


def tiny_model(write_path):
    return MemoryDINOSeg(
        data_path="in-memory", write_path=write_path, head="linear",
        n_blocks=1, n_classes=3, batch_size=2, max_epochs=1,
        augmented=False, train_resolution=64, random_init=True,
        precision="fp32", device="cpu")


_RANK = textwrap.dedent("""
    import json, sys
    cfg = json.loads(sys.argv[1])
    from dino_tpu_torch.parallel import dist as pd
    from tests.test_torch_port_multiprocess import tiny_model
    assert not any(m in ("jax", "dino_tpu")
                   or m.startswith(("jax.", "dino_tpu."))
                   for m in sys.modules)
    pd.init_distributed_mode("gloo", cfg["init"], cfg["world"], cfg["rank"])
    model = tiny_model(cfg["tmp"] + "/shared")
    out = {"fit": model.fit(samples_per_epoch=2),
           "evaluate": model.evaluate("in-memory")}
    with open(cfg["out"], "w") as fh:
        json.dump(out, fh)
""")


def spawn_ranks(tmp, world, script, cfg, tag="world"):
    """Run ``world`` processes of ``script`` (python -c; its argv[1] is
    ``cfg`` as JSON plus ``init``, ``world``, ``rank``, ``tmp`` and ``out``,
    the path the rank writes its results to); returns the ``out`` paths in
    rank order.  A rank that fails or outlives CHILD_TIMEOUT fails the
    test and takes its peers down."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs, outs = [], []
    for r in range(world):
        args = dict(cfg, init=f"file://{tmp}/store_{tag}{world}",
                    world=world, rank=r, tmp=str(tmp),
                    out=f"{tmp}/{tag}{world}_rank{r}.out")
        outs.append(args["out"])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, json.dumps(args)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return outs


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    outs = spawn_ranks(tmp, 2, _RANK, {})
    return tmp, [json.load(open(o)) for o in outs]


@pytest.mark.parametrize("call", ["fit", "evaluate"])
def test_world_of_two_trains_one_replica(world2, tmp_path, call):
    """Both ranks return the world of one's metrics (the confusion matrices
    summed over the ranks); fit's checkpoint is in the shared folder."""
    tmp, results = world2
    single = tiny_model(str(tmp_path))
    want = single.fit(samples_per_epoch=2)
    if call == "evaluate":
        want = single.evaluate("in-memory")
    for rank, res in enumerate(results):
        assert set(res[call]) == set(want), rank
        for k, v in want.items():
            np.testing.assert_allclose(res[call][k], v, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{rank} {k}")
    assert os.path.exists(os.path.join(tmp, "shared",
                                       "1_linear_frozen.ckpt.npz"))


def test_world_of_one_still_fits(tmp_path):
    assert not pd.is_dist_avail_and_initialized()
    model = tiny_model(str(tmp_path / "w"))
    pd.init_distributed_mode("gloo", f"file://{tmp_path}/store1", 1, 0)
    try:
        assert pd.get_world_size() == 1
        metrics = model.fit(samples_per_epoch=2)
        evaluated = model.evaluate("in-memory")
    finally:
        dist.destroy_process_group()
    assert np.isfinite(metrics["test_acc"])
    assert evaluated["test_support"] == metrics["test_support"]
    assert os.path.exists(tmp_path / "w" / "1_linear_frozen.ckpt.npz")


def test_no_world_fits_as_before(tmp_path):
    metrics = tiny_model(str(tmp_path)).fit(samples_per_epoch=2)
    assert np.isfinite(metrics["test_acc"])
    assert isinstance(DINOSeg.load_from_checkpoint(
        str(tmp_path / "1_linear_frozen.ckpt.npz"), device="cpu"), DINOSeg)
