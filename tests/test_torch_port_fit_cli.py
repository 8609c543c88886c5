"""The port's fit and eval CLIs against dino_tpu's on the same synthetic
split (CPU, fp32): run_experiment logs the same per-epoch metrics, and eval
prints the same metrics JSON for the same checkpoint."""
import json
import os

import jax
import numpy as np
import pytest

from dino_tpu import DINOSeg as JaxDINOSeg
from dino_tpu.cli import eval as jeval
from dino_tpu.cli import run_experiment as jrun
from dino_tpu_torch.checkpointing.convert import from_jax_params
from dino_tpu_torch.cli import eval as teval
from dino_tpu_torch.cli import run_experiment as trun
from tests.test_train_smoke import _make_split

ARGS = ["-e", "2", "-lr", "1e-4", "--random_init", "--train_resolution",
        "64", "--n_blocks", "1", "--random_state", "7", "-b", "4",
        "--precision", "fp32"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    _make_split(str(root), "train", 8, 0)
    _make_split(str(root), "val", 3, 1)
    _make_split(str(root), "test", 3, 2)
    (root / "labels.txt").write_text(
        "__ignore__\n_background_\nred\ngreen\n")
    return root


class CarriedInit(trun.DINOSeg):
    """The port's DINOSeg holding dino_tpu's random init for the same
    arguments, so the two CLIs train the same weights."""

    def __init__(self, **kw):
        super().__init__(**kw)
        jkw = {k: v for k, v in kw.items() if k not in ("device", "logger")}
        jm = JaxDINOSeg(**jkw)
        self.load_state_dict(from_jax_params(
            jax.tree.map(np.asarray, jm.vit_params),
            jax.tree.map(np.asarray, jm.head_params)))


def _epochs(path):
    with open(path) as fh:
        return [r for r in map(json.loads, fh) if r["event"] == "metrics"]


def test_run_experiment_and_eval_match_dino_tpu(data, tmp_path,
                                               monkeypatch, capsys):
    jw, tw = tmp_path / "jax", tmp_path / "port"
    jrun.run_experiment(**vars(jrun.build_parser().parse_args(
        ["-d", str(data), "-w", str(jw)] + ARGS)))
    monkeypatch.setattr(trun, "DINOSeg", CarriedInit)
    trun.main(["-d", str(data), "-w", str(tw), "--cpu"] + ARGS)
    want, got = _epochs(jw / "metrics.jsonl"), _epochs(tw / "metrics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1,
                                                                     -1]
    for g, w in zip(got, want):
        for k, v in w.items():
            if k.startswith(("val_", "test_")) or k in ("train_acc",
                                                        "train_F1"):
                assert g[k] == v, k
        if "train_loss" in w:
            # 250 steps an epoch drive the loss toward 0, where it is the
            # mean of -log p ~ 1 - p: each term is the difference of two
            # O(1) float32 numbers, so its error is absolute, ~1e-7
            np.testing.assert_allclose(g["train_loss"], w["train_loss"],
                                       rtol=1e-5, atol=1e-6)
    j_ck = str(jw / "1_vit_mlp_7.ckpt.npz")
    t_ck = str(tw / "1_vit_mlp_7.ckpt.npz")
    test_dir = str(data / "dt_real_voc_test")
    capsys.readouterr()
    for ck in (j_ck, t_ck):
        jeval.main([ck, test_dir, "--per-class", "--batch-size", "2"])
        want_line = capsys.readouterr().out.strip().splitlines()[-1]
        out = tmp_path / "m.json"
        teval.main([ck, test_dir, "--per-class", "--batch-size", "2",
                    "--cpu", "--json", str(out)])
        got_line = capsys.readouterr().out.strip().splitlines()[-1]
        assert got_line == want_line
        assert out.read_text().strip() == want_line
        assert json.loads(got_line)["test_support"] == 3 * 64


def test_run_experiment_finetune_phase(data, tmp_path):
    """--finetune refits the best checkpoint with the backbone unfrozen
    under a second name."""
    model = trun.run_experiment(
        **vars(trun.build_parser().parse_args(
            ["-d", str(data), "-w", str(tmp_path), "--cpu", "--finetune",
             "-e", "1", "--random_init", "--train_resolution", "64",
             "-b", "4", "--precision", "fp32"])))
    assert not model.freeze_backbone
    names = sorted(os.listdir(tmp_path))
    assert "1_vit_mlp_42.ckpt.npz" in names
    assert "1_vit_mlp_42_finetuned.ckpt.npz" in names
    assert model.best_ck.endswith("_finetuned.ckpt.npz")
