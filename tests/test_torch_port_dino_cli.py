"""``python -m dino_tpu_torch.cli.pretrain_dino`` end to end on the CPU.

A few synthetic JPEGs under ``tmp_path``; ViT-S/8 at depth 1, out_dim 16,
2 local crops, global 32 px and local 16 px, batch 2.  The saved teacher
backbone loads into the port's DINOSeg, which predicts; a stopped and
resumed run (at an epoch's end and mid-epoch) ends with the uninterrupted
run's teacher, bit for bit; --nan_guard rolls back over injected NaN
crops; --fsdp in a world of one is the plain run.
"""
import os

import numpy as np
import pytest
from PIL import Image

from dino_tpu_torch.api import DINOSeg
from dino_tpu_torch.cli.pretrain_dino import main as pretrain_main

COMMON = ["--arch", "vit_small", "--depth", "1", "--out_dim", "16",
          "--warmup_epochs", "0", "--batch_size", "2", "--n_local_crops",
          "2", "--global_size", "32", "--local_size", "16", "--device",
          "cpu"]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    data = tmp_path_factory.mktemp("imgs")
    rs = np.random.RandomState(0)
    for i in range(6):
        Image.fromarray(rs.randint(0, 255, (64, 80, 3), np.uint8)).save(
            data / f"{i}.jpg")
    return str(data)


def _run(images, write, *extra):
    return pretrain_main(["--data_path", images, "--write_path", write]
                         + COMMON + list(extra))


def _backbone(write):
    with np.load(os.path.join(write, "dino_pretrained_backbone.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def full_run(images, tmp_path_factory):
    """The uninterrupted 2-epoch run (3 steps an epoch)."""
    write = str(tmp_path_factory.mktemp("full"))
    out = _run(images, write, "--epochs", "2")
    assert out == os.path.join(write, "dino_pretrained_backbone.npz")
    return _backbone(write)


def test_cli_backbone_loads_into_dinoseg(full_run, images, tmp_path):
    write = str(tmp_path / "out")
    _run(images, write, "--epochs", "1")
    model = DINOSeg(head="linear", n_blocks=1, n_classes=3, seed=0,
                    device="cpu", pretrained_path=os.path.join(
                        write, "dino_pretrained_backbone.npz"))
    got = model.model.dino.state_dict()
    assert got["blocks.0.attn.qkv.weight"].shape == (1152, 384)
    model.set_resolution(64)
    out = model.predict(np.random.RandomState(1).randint(
        0, 255, (64, 64, 3), np.uint8))
    assert out.shape == (480, 480)
    # one epoch is not two: the teacher moved on in the second
    assert not np.array_equal(_backbone(write)["cls_token"],
                              full_run["cls_token"])


@pytest.mark.parametrize("stop", ["epoch", "mid_epoch"])
def test_cli_stop_and_resume_give_the_full_runs_teacher(full_run, images,
                                                        tmp_path, stop):
    write = str(tmp_path / "resume")
    if stop == "epoch":  # saves epoch 0's teacher backbone too
        _run(images, write, "--epochs", "2", "--stop_after", "0")
    else:  # a graceful stop after 4 steps (step 1 of epoch 1) saves none
        assert _run(images, write, "--epochs", "2", "--stop_after_steps",
                    "4") is None
        assert not os.path.exists(os.path.join(
            write, "dino_pretrained_backbone.npz"))
    assert os.path.exists(os.path.join(write, "pretrain_resume.npz"))
    _run(images, write, "--epochs", "2", "--resume")
    got = _backbone(write)
    assert set(got) == set(full_run)
    for k in full_run:
        np.testing.assert_array_equal(got[k], full_run[k], err_msg=k)


def test_cli_nan_guard_rolls_back(images, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DINO_TPU_FAULT_NAN_STEP", "1")
    write = str(tmp_path / "nan")
    _run(images, write, "--epochs", "1", "--nan_guard",
         "--save_every_steps", "1")
    assert "nan_guard: non-finite loss at epoch 0 step 1" in (
        capsys.readouterr().out)
    for v in _backbone(write).values():
        assert np.isfinite(v).all()


def test_cli_fsdp_in_a_world_of_one_is_the_plain_run(images, tmp_path):
    """--fsdp shards over the ranks: with no process group it is a no-op
    (over ranks: tests/test_torch_port_dp_pretrain.py)."""
    _run(images, str(tmp_path / "a"), "--epochs", "1", "--fsdp")
    _run(images, str(tmp_path / "b"), "--epochs", "1")
    got, want = _backbone(str(tmp_path / "a")), _backbone(str(tmp_path / "b"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
