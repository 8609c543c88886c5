"""Predict and export over several cards of one process, on the CPU.

The port's N-device artifacts (dino_tpu_torch/serving.py: export_predict
with n_devices and parallelism='sp'), its in-process ring and the batch
split of predict_batch and predict_stream (api.py) against dino_tpu's
artifacts on its virtual 8-device CPU mesh (tests/conftest.py), as
tests/test_serving_export.py:110-171 holds dino_tpu's.  On the CPU the
port's N devices are ['cpu'] * N: the shards and chunks run in series.
One model: the mlp head, 1 block, 5 classes, fp32 at 64px, 100x120 frames,
carried from a dino_tpu .npz.
"""
import json
import os

import numpy as np
import pytest
import torch

import dino_tpu_torch.api as tapi
from dino_tpu import export_predict as jax_export_predict
from dino_tpu import load_exported_predict as jax_load_exported_predict
from dino_tpu.api import DINOSeg as JaxDINOSeg
from dino_tpu_torch import DINOSeg, export_predict, load_exported_predict
from dino_tpu_torch.api import collect_labels, seg_log_probs_sp
from dino_tpu_torch.cli.serve import _build_backend
from dino_tpu_torch.parallel import ring_attention as tring
from dino_tpu_torch.serving import artifact_devices, predict_program
from tests.test_torch_port_ring import SP_FWD_TOL
from tests.test_torch_port_serve import (RES, assert_labels_agree,
                                         jax_log_probs)

HW = (100, 120)


def _frames(n, seed):
    return np.random.RandomState(seed).randint(0, 255, (n,) + HW + (3,),
                                               np.uint8)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """dino_tpu's model and the port's, loaded from the same .npz."""
    jm = JaxDINOSeg(head="mlp", n_blocks=1, n_classes=5, random_init=True,
                    seed=1, precision="fp32")
    jm.set_resolution(RES)
    path = str(tmp_path_factory.mktemp("pair") / "j.ckpt.npz")
    jm.save(path)
    pm = DINOSeg.load_from_checkpoint(path, device="cpu")
    pm.set_resolution(RES)
    return jm, pm


@pytest.mark.parametrize("n", [2, 4])
def test_dp_artifact_matches_dino_tpu_and_the_one_device_program(pair, n,
                                                                 tmp_path):
    """export_predict(n_devices=N): N programs, one a device, whose fp32
    labels are dino_tpu's N-device artifact's and, chunk by chunk, the
    port's one-device program's at batch B/N, bit for bit."""
    jm, pm = pair
    batch = 4
    jpath, ppath = str(tmp_path / "dp.shlo"), str(tmp_path / "dp.dtts")
    jax_export_predict(jm, jpath, batch_size=batch, in_shape=HW, n_devices=n)
    export_predict(pm, ppath, batch_size=batch, in_shape=HW, n_devices=n)
    served = load_exported_predict(ppath, device="cpu")
    assert served.contract["nr_devices"] == n
    assert served.contract["parallelism"] is None
    assert len(served.programs) == n
    assert all(p.input_shape == (batch // n,) + HW + (3,)
               for p in served.programs)
    frames = _frames(batch, 1)
    got = served(frames)
    np.testing.assert_array_equal(got, jax_load_exported_predict(jpath)(
        frames))
    one = predict_program(pm, batch // n, HW)
    np.testing.assert_array_equal(got, np.concatenate(
        [one(c) for c in np.split(frames, n)]))
    with pytest.raises(ValueError, match="shape-bound"):
        served(frames[:batch // n])


@pytest.mark.parametrize("n", [2, 4])
def test_sp_artifact_matches_dino_tpu(pair, n, tmp_path):
    """export_predict(n_devices=N, parallelism='sp'): the tokens shard over
    N devices, the frames do not; labels dino_tpu's SP artifact's except
    near ties, log-probs its forward's within SP_FWD_TOL; with its .json
    deleted the artifact still loads as SP (its contract is inside)."""
    jm, pm = pair
    jpath, ppath = str(tmp_path / "sp.shlo"), str(tmp_path / "sp.dtts")
    jax_export_predict(jm, jpath, batch_size=2, in_shape=HW, n_devices=n,
                       parallelism="sp")
    export_predict(pm, ppath, batch_size=2, in_shape=HW, n_devices=n,
                   parallelism="sp")
    frames = _frames(2, 7)
    served = load_exported_predict(ppath, device="cpu")
    assert served.contract["parallelism"] == "sp"
    assert served.contract["nr_devices"] == n and not served.programs
    got = served(frames)
    want_logp = jax_log_probs(jm, frames)
    assert_labels_agree(got, jax_load_exported_predict(jpath)(frames),
                        want_logp)
    logp = seg_log_probs_sp(served.replicas, served.cfg, "mlp",
                            torch.from_numpy(frames), RES, None)
    np.testing.assert_allclose(logp.numpy(), want_logp, **SP_FWD_TOL)
    os.remove(ppath + ".json")
    again = load_exported_predict(ppath, device="cpu")
    assert again.sp and again.contract["nr_devices"] == n
    np.testing.assert_array_equal(again(frames), got)


def test_in_process_ring_world_of_one_is_the_process_ring():
    """At one shard the in-process ring and the process ring (no group: a
    world of one) give the same bits, attention and the whole forward."""
    m = DINOSeg(head="linear", n_blocks=2, n_classes=3, random_init=True,
                seed=2, precision="fp32", device="cpu")
    vit, cfg = m.model.dino, m.cfg
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, 48, 48, 3).astype(np.float32))
    q, k, v = (torch.from_numpy(np.random.RandomState(s).randn(
        1, 6, 37, 64).astype(np.float32)) for s in (4, 5, 6))
    with torch.no_grad():
        np.testing.assert_array_equal(
            tring.ring_attention_local([q], [k], [v], cfg.scale, 37)[0],
            tring.ring_attention(q, k, v, cfg.scale, 37))
        np.testing.assert_array_equal(
            tring.vit_forward_seq_parallel_local([vit], x, cfg),
            tring.vit_forward_seq_parallel(vit, x, cfg))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_batch_split_gives_one_devices_labels(pair, n, precision):
    """The split of predict_batch over N devices (chunk i through device
    i's serving model, all launched before any is read) gives the one-device
    predict_batch's bits; in fp32 dino_tpu's labels except near ties."""
    jm, pm = pair
    frames = _frames(4, 11)
    got = collect_labels(pm._launch_split(torch.from_numpy(frames),
                                          ["cpu"] * n, precision))
    np.testing.assert_array_equal(got, pm.predict_batch(frames, precision))
    if precision == "fp32":
        assert_labels_agree(got, jm.predict_batch(frames),
                            jax_log_probs(jm, frames))
    with pytest.raises(ValueError, match="does not split"):
        pm._launch_split(torch.from_numpy(frames[:3]), ["cpu"] * 2)


def test_stream_splits_its_batches(pair, monkeypatch):
    """predict_stream over the split route (two devices a batch, a ragged
    tail) yields predict_batch's maps in order."""
    _, pm = pair
    frames = _frames(6, 13)
    monkeypatch.setattr(pm, "_split_devices",
                        lambda batch, parallelism: ["cpu"] * 2)
    got = np.stack(list(pm.predict_stream(iter(frames), batch_size=4)))
    np.testing.assert_array_equal(got, pm.predict_batch(frames))


def test_split_engages_only_for_one_process_over_its_cards(pair,
                                                           monkeypatch):
    """The split needs the model on a card, several cards, a batch that
    divides by their count, no parallel mode, and no process group of more
    than one rank (whose ranks take a card each: DP, TP and PP)."""
    _, pm = pair
    assert pm._split_devices(4, None) is None  # the model is on the CPU
    monkeypatch.setattr(pm, "device", torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pm._split_devices(4, None) == [torch.device("cuda", 0),
                                          torch.device("cuda", 1)]
    assert pm._split_devices(3, None) is None
    assert pm._split_devices(4, "sp") is None
    monkeypatch.setattr(tapi, "get_world_size", lambda group=None: 2)
    assert pm._split_devices(4, None) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(tapi, "get_world_size", lambda group=None: 1)
    assert pm._split_devices(4, None) is None


def test_split_models_follow_the_weights(pair):
    """One serving model a device (the model's own on its device), rebuilt
    when the weights change; int8 splits its quantized copy."""
    _, pm = pair
    first = pm._split_models(["cpu"] * 2, "fp32")
    assert first[0] is first[1] is pm.model
    assert pm._split_models(["cpu"] * 2, "fp32")[0] is first[0]
    int8 = pm._split_models(["cpu"], "int8")[0]
    assert int8 is not pm.model and int8 is pm._serving_model("int8")
    key = pm._split_cache[0]
    pm.load_state_dict(pm.model.state_dict())
    pm._split_models(["cpu"], "int8")
    assert pm._split_cache[0] != key


def test_too_few_cards_raise(monkeypatch):
    """An artifact for more cards than the process has is refused with
    dino_tpu's words, not run on fewer."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="exported for 2 devices; runtime "
                                         "has 1"):
        artifact_devices(torch.device("cuda"), 2)
    assert artifact_devices(torch.device("cpu"), 3) == [torch.device("cpu")
                                                        ] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert artifact_devices(torch.device("cuda"), 2) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]


def test_serve_backend_over_a_two_device_artifact(pair, tmp_path):
    """dt-serve's artifact backend over a batch-4 artifact split over two
    devices: one frame is tiled to fill the batch and answered with
    predict_batch's map; the info names both devices."""
    _, pm = pair
    path = str(tmp_path / "dp.dtts")
    export_predict(pm, path, batch_size=4, in_shape=HW, n_devices=2)
    predict, predict_many, info = _build_backend(path, RES, None,
                                                 device="cpu")
    assert info["devices"] == ["cpu", "cpu"]
    assert info["contract"]["nr_devices"] == 2
    frames = _frames(5, 17)
    np.testing.assert_array_equal(predict(frames[0]),
                                  pm.predict_batch(frames[:1])[0])
    np.testing.assert_array_equal(np.stack(predict_many(list(frames))),
                                  pm.predict_batch(frames))
    with open(path + ".json") as fh:
        assert json.load(fh)["input"]["shape"] == [4, 100, 120, 3]
