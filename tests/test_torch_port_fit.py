"""DINOSeg.fit / evaluate / the dataloaders of the port vs dino_tpu's, on the
CPU in fp32: the synthetic VOC split of tests/test_train_smoke.py at 64px
(3 classes; 12 train, 4 val, 4 test frames, and a sim train split), one
block of ViT-S/8 with the MLP head, the JAX model's random init carried to
the port with from_jax_params.

Tolerances (PERF.md, "train parity"): per-epoch confusion matrices and the
metrics derived from them exact, train_loss within rtol 1e-5, final
parameters within atol 1e-5 / rtol 1e-4 (float32 sums in another order).
Adam turns those last-bit differences into steps of up to lr wherever a
gradient is within a few eps of 0, so the parity fits train the head at lr
1e-4 and the backbone at the bench's 1e-5: at 1e-3 the pretrain_on_sim
fit's train_loss drifts to 1.1e-5 relative after 9 steps and its
parameters by 1.8e-3 after 12, with equal confusion matrices throughout.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from dino_tpu import DINOSeg as JaxDINOSeg
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.checkpointing.convert import from_jax_params, to_jax_params
from dino_tpu_torch.checkpointing.io import load_checkpoint
from tests.test_train_smoke import _make_split

RES = 64
N_CLASSES = 3
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
SAMPLES = 10  # batch 4: every epoch ends in a padded, masked batch
CM_KEYS = ("acc", "F1", "iou", "support")


class ListLogger:
    """Collects what fit logs: per-epoch metrics and val confusion
    matrices."""

    def __init__(self):
        self.metrics, self.cms = [], []

    def log_metrics(self, metrics, step):
        self.metrics.append((step, dict(metrics)))

    def log_confusion_matrix(self, cm, title, step, labels=None,
                             file_name=None):
        self.cms.append((step, np.asarray(cm).astype(np.int64)))


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    _make_split(root, "train", 12, 0)
    _make_split(root, "val", 4, 1)
    _make_split(root, "test", 4, 2)
    shutil.copytree(os.path.join(root, "dt_real_voc_train"),
                    os.path.join(root, "dt_sim_voc_train"))
    return root


def _kwargs(voc_root, **over):
    kw = dict(data_path=voc_root, head="mlp", n_blocks=1,
              n_classes=N_CLASSES, batch_size=4, lr=1e-4, optimizer="adam",
              freeze_backbone=True, max_epochs=2, random_init=True,
              augmented=False, train_resolution=RES, seed=0,
              precision="fp32")
    kw.update(over)
    return kw


def _pair(voc_root, tmp_path, **over):
    """(JAX model, port model) with the JAX init, each logging to a list
    and writing checkpoints to its own folder."""
    jm = JaxDINOSeg(write_path=str(tmp_path / "jax"), logger=ListLogger(),
                    **_kwargs(voc_root, **over))
    pm = DINOSeg(write_path=str(tmp_path / "port"), logger=ListLogger(),
                 device="cpu", **_kwargs(voc_root, **over))
    pm.load_state_dict(from_jax_params(*_jax_params(jm)))
    return jm, pm


def _jax_params(jm):
    return (jax.tree.map(np.asarray, jm.vit_params),
            jax.tree.map(np.asarray, jm.head_params))


def _assert_params_close(pm, jm, **tol):
    got = to_jax_params(pm.model.state_dict())
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(_jax_params(jm)),
                    strict=True):
        np.testing.assert_allclose(g, w, **tol)


def _assert_fits_agree(jm, pm, j_out, p_out):
    jl, pl = jm.logger, pm.logger
    assert [s for s, _ in pl.metrics] == [s for s, _ in jl.metrics]
    for (_, pmx), (_, jmx) in zip(pl.metrics, jl.metrics):
        for split in ("val", "train", "test"):
            for k in CM_KEYS:
                key = f"{split}_{k}"
                assert (key in pmx) == (key in jmx), key
                if key in jmx:
                    assert pmx[key] == jmx[key], (key, pmx, jmx)
        if "train_loss" in jmx:
            np.testing.assert_allclose(pmx["train_loss"], jmx["train_loss"],
                                       rtol=LOSS_RTOL)
    assert len(pl.cms) == len(jl.cms) > 0
    for (ps, pcm), (js, jcm) in zip(pl.cms, jl.cms):
        assert ps == js
        np.testing.assert_array_equal(pcm, jcm)
    assert p_out == j_out
    _assert_params_close(pm, jm, **PARAM_TOL)


@pytest.mark.parametrize("case", ["frozen", "frozen_cached", "unfrozen_accum",
                                  "pretrain_on_sim"])
def test_fit_matches_dino_tpu(voc_root, tmp_path, case):
    over, fit_kw = {}, dict(samples_per_epoch=SAMPLES, seed=3)
    if case == "frozen":
        fit_kw["cache_features"] = False
    elif case == "unfrozen_accum":
        # at 1e-4 the backbone's parameters drift apart by 2.4e-5
        over = dict(freeze_backbone=False, augmented=True, lr=1e-5)
        fit_kw["accum_steps"] = 2
    elif case == "pretrain_on_sim":
        over = dict(pretrain_on_sim=True)
    jm, pm = _pair(voc_root, tmp_path, **over)
    j_out = jm.fit(**fit_kw)
    p_out = pm.fit(**fit_kw)
    _assert_fits_agree(jm, pm, j_out, p_out)
    assert pm.best_ck.endswith(".ckpt.npz") and os.path.exists(pm.best_ck)
    cached = case in ("frozen_cached", "pretrain_on_sim")
    assert all(("feature_cache_bytes" in m) == cached
               for s, m in pm.logger.metrics if s >= 0)


@pytest.mark.parametrize("patience", [0, 2])
def test_early_stopping_stops_at_dino_tpus_epoch(voc_root, tmp_path,
                                                 patience):
    """lr 0 keeps val_acc flat, so the run stops max(patience, 1) epochs
    after the first."""
    jm, pm = _pair(voc_root, tmp_path, lr=0.0, max_epochs=6,
                   patience=patience)
    jm.fit(samples_per_epoch=4, early_stopping=True)
    pm.fit(samples_per_epoch=4, early_stopping=True)
    steps = [s for s, _ in pm.logger.metrics]
    assert steps == [s for s, _ in jm.logger.metrics]
    assert steps == list(range(max(patience, 1) + 1)) + [-1]


def test_resumed_fit_has_the_same_bits(voc_root, tmp_path):
    """Two epochs in one run, against one epoch and a resume=True run up to
    two: the same parameters, optimizer state and metrics, bit for bit."""
    def model(max_epochs, path):
        m = DINOSeg(write_path=str(tmp_path / path), device="cpu",
                    logger=ListLogger(),
                    **_kwargs(voc_root, freeze_backbone=False,
                              augmented=True, lr=1e-4,
                              max_epochs=max_epochs))
        m.load_state_dict(start)
        return m

    start = DINOSeg(device="cpu", **_kwargs(voc_root)).model.state_dict()
    fit_kw = dict(samples_per_epoch=6, resume=True)  # a ragged second step
    whole = model(2, "whole")
    out_whole = whole.fit(**fit_kw)
    part = model(1, "part")
    part.fit(**fit_kw)
    resumed = model(2, "part")
    out_resumed = resumed.fit(**fit_kw)
    assert out_resumed == out_whole
    assert [s for s, _ in resumed.logger.metrics] == [1, -1]
    a = np.load(whole.best_ck + ".resume.npz")
    b = np.load(resumed.best_ck + ".resume.npz")
    assert sorted(a.files) == sorted(b.files)
    assert any(k.startswith("state/opt_state/") for k in a.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for (_, x), (_, y) in zip(whole.logger.metrics[1:],
                              resumed.logger.metrics, strict=True):
        for k in ("train_loss", "val_acc", "test_acc"):
            assert x.get(k) == y.get(k), k
    for p, q in zip(whole.model.parameters(), resumed.model.parameters()):
        assert torch.equal(p, q)


def test_checkpoints_cross_both_ways(voc_root, tmp_path):
    jm, pm = _pair(voc_root, tmp_path)
    jm.fit(samples_per_epoch=4, cache_features=False)
    pm.fit(samples_per_epoch=4, cache_features=False)
    # the port's best checkpoint in dino_tpu, dino_tpu's in the port
    j_from_p = JaxDINOSeg.load_from_checkpoint(pm.best_ck)
    p_from_j = DINOSeg.load_from_checkpoint(jm.best_ck, device="cpu")
    for g, w in zip(jax.tree.leaves(_jax_params(j_from_p)),
                    jax.tree.leaves(to_jax_params(pm.model.state_dict()))):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(jax.tree.leaves(to_jax_params(
            p_from_j.model.state_dict())), jax.tree.leaves(_jax_params(jm))):
        np.testing.assert_array_equal(g, w)
    _, hp = load_checkpoint(pm.best_ck)
    assert hp["epoch"] in (0, 1) and "best_val_acc" in hp
    for key in ("batch_size", "lr", "train_resolution", "n_classes",
                "max_epochs", "augmented", "optimizer"):
        assert getattr(j_from_p, key) == getattr(pm, key), key
        assert getattr(p_from_j, key) == getattr(jm, key), key
    # a reference Lightning .ckpt from the port, read by dino_tpu
    ckpt = str(tmp_path / "export.ckpt")
    pm.save_torch_checkpoint(ckpt, epoch=3, global_step=9)
    j_pl = JaxDINOSeg.load_from_checkpoint(ckpt)
    for g, w in zip(jax.tree.leaves(_jax_params(j_pl)),
                    jax.tree.leaves(to_jax_params(pm.model.state_dict()))):
        np.testing.assert_array_equal(g, w)
    blob = torch.load(ckpt, map_location="cpu", weights_only=False)
    want = str(tmp_path / "export_jax.ckpt")
    jm.save_torch_checkpoint(want, epoch=3, global_step=9)
    ref = torch.load(want, map_location="cpu", weights_only=False)
    assert blob.keys() == ref.keys()
    assert sorted(blob["state_dict"]) == sorted(ref["state_dict"])
    assert blob["hyper_parameters"].keys() == ref["hyper_parameters"].keys()
    assert blob["hyper_parameters"]["optimizer"] is torch.optim.Adam


def test_evaluate_and_dataloaders_equal_dino_tpu(voc_root, tmp_path):
    jm, pm = _pair(voc_root, tmp_path, augmented=True)
    test_dir = os.path.join(voc_root, "dt_real_voc_test")
    want = jm.evaluate(test_dir, per_class=True, batch_size=3)
    got = pm.evaluate(test_dir, per_class=True, batch_size=3)
    assert got == want
    assert pm.evaluate(test_dir, resolution=48, prefix="p48") == jm.evaluate(
        test_dir, resolution=48, prefix="p48")
    with pytest.raises(ValueError, match="multiple of 8"):
        pm.evaluate(test_dir, resolution=60)
    with pytest.raises(FileNotFoundError):
        pm.evaluate(str(tmp_path / "empty"))
    loaders = [(pm.train_dataloader(seed=5, samples_per_epoch=7),
                jm.train_dataloader(seed=5, samples_per_epoch=7)),
               (pm.train_dataloader(sim=True, samples_per_epoch=3),
                jm.train_dataloader(sim=True, samples_per_epoch=3)),
               (pm.val_dataloader(), jm.val_dataloader()),
               (pm.test_dataloader(), jm.test_dataloader())]
    for got_it, want_it in loaders:
        for (gx, gy), (wx, wy) in zip(got_it, want_it, strict=True):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_unported_fit_options_raise(voc_root, tmp_path):
    pm = DINOSeg(write_path=str(tmp_path), device="cpu",
                 **_kwargs(voc_root))
    # pipeline parallelism finetunes the backbone too (dino_tpu's error)
    with pytest.raises(ValueError, match="UNFROZEN"):
        pm.fit(parallelism="pp")
    # sequence parallelism finetunes the backbone (this model's is frozen)
    with pytest.raises(ValueError, match="unfrozen-finetune"):
        pm.fit(parallelism="sp", zero=True)
    for kw, match in ((dict(zero=True, fsdp=True), "drop zero=True"),
                      (dict(fsdp=True, parallelism="sp"), "use zero=True")):
        with pytest.raises(ValueError, match=match):
            pm.fit(**kw)
    with pytest.raises(ValueError, match="parallelism"):
        pm.fit(parallelism="dp")
    with pytest.raises(ValueError, match="accum_steps"):
        pm.fit(accum_steps=3)
    assert not os.listdir(tmp_path)
