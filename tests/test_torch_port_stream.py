"""DINOSeg.predict_stream of dino_tpu_torch: order, ragged tail and one
batch shape against predict_batch on the same padded batches (the same
maps, bit for bit), batch k+1 enqueued before batch k's labels are read,
the options checked before the first frame, and the same maps as
dino_tpu's predict_stream on carried weights (CPU, fp32), except at patches
whose top-2 log-prob margin is below MARGIN."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tpu.api import DINOSeg as JaxDINOSeg
from dino_tpu.ops.preprocess import preprocess as jax_preprocess
from dino_tpu.train.loop import seg_forward as jax_seg_forward
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.checkpointing.convert import from_jax_params

RES = 64
MARGIN = 1e-4  # top-2 log-prob gap below which fp32 argmax may flip
N_CLASSES = 5


@pytest.fixture(scope="module")
def pair():
    """dino_tpu's DINOSeg (1 block, MLP head, 5 classes, seed 0) and the
    port's holding its weights, fp32, at 64px on the CPU (the model of
    tests/test_predict_batch.py)."""
    jm = JaxDINOSeg(head="mlp", n_blocks=1, n_classes=N_CLASSES,
                    random_init=True, seed=0, precision="fp32")
    pm = DINOSeg(head="mlp", n_blocks=1, n_classes=N_CLASSES,
                 precision="fp32", random_init=True, device="cpu")
    pm.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, jm.vit_params),
        jax.tree.map(np.asarray, jm.head_params)))
    for m in (jm, pm):
        m.set_resolution(RES)
    return jm, pm


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(0).randint(0, 255, (11, 100, 120, 3),
                                            np.uint8)


def _padded_batches(frames, b):
    """(batch padded to b by repeating its last frame, real count)."""
    for i in range(0, len(frames), b):
        part = frames[i:i + b]
        pad = np.repeat(part[-1:], b - len(part), axis=0)
        yield np.concatenate([part, pad]), len(part)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_stream_equals_predict_batch_on_padded_batches(pair, frames,
                                                       precision):
    _, pm = pair
    outs = list(pm.predict_stream(iter(frames), batch_size=4,
                                  precision=precision))
    assert len(outs) == 11  # 2 full batches + a ragged tail of 3
    want = np.concatenate([pm.predict_batch(batch, precision=precision)[:n]
                           for batch, n in _padded_batches(frames, 4)])
    for out, ref in zip(outs, want):
        assert out.shape == (480, 480) and out.dtype == np.int32
        np.testing.assert_array_equal(out, ref)


def test_stream_runs_one_batch_shape(pair, frames, monkeypatch):
    _, pm = pair
    shapes = []
    real = pm.predict_device

    def spy(imgs, precision=None, parallelism=None):
        shapes.append((tuple(imgs.shape), precision))
        return real(imgs, precision, parallelism)

    monkeypatch.setattr(pm, "predict_device", spy)
    outs = list(pm.predict_stream(list(frames[:6]), batch_size=4,
                                  precision="fp32"))
    assert len(outs) == 6
    assert shapes == [((4, 100, 120, 3), "fp32")] * 2


def test_stream_enqueues_the_next_batch_before_reading(pair, frames,
                                                       monkeypatch):
    _, pm = pair
    log = []
    real = pm.predict_device

    def spy(imgs, precision=None, parallelism=None):
        log.append("submit")
        return real(imgs, precision, parallelism)

    monkeypatch.setattr(pm, "predict_device", spy)
    for _ in pm.predict_stream(iter(frames), batch_size=4):
        log.append("frame")
    # batch 0's maps come out after batch 1 went in, batch 1's after the
    # tail; the tail's last
    assert log == (["submit", "submit"] + ["frame"] * 4 + ["submit"]
                   + ["frame"] * 7)


def test_stream_matches_jax_stream(pair, frames):
    jm, pm = pair
    outs = list(pm.predict_stream(iter(frames), batch_size=4))
    refs = list(jm.predict_stream(iter(frames), batch_size=4))
    assert len(outs) == len(refs) == 11
    x = jax_preprocess(jnp.asarray(frames), RES)
    logp = np.asarray(jax_seg_forward(jm.vit_params, jm.head_params, jm.cfg,
                                      "mlp", pre_normalized=x))
    top2 = np.sort(logp, axis=-1)[:, -2:]
    near = ((top2[:, 1] - top2[:, 0]) < MARGIN).reshape(11, 8, 8)
    f = 480 // (RES // 8)
    for i, (out, ref) in enumerate(zip(outs, refs)):
        np.testing.assert_array_equal(out[::f, ::f][~near[i]],
                                      ref[::f, ::f][~near[i]])
        np.testing.assert_array_equal(out, np.kron(out[::f, ::f],
                                                   np.ones((f, f), np.int32)))


def test_stream_edge_cases(pair, frames):
    _, pm = pair
    assert list(pm.predict_stream(iter([]), batch_size=4)) == []
    one = list(pm.predict_stream(frames[:1], batch_size=4))
    np.testing.assert_array_equal(one[0], pm.predict_batch(
        np.repeat(frames[:1], 4, axis=0))[0])
    mixed = [frames[0], frames[1][:, :100]]
    with pytest.raises(ValueError, match="shape"):
        list(pm.predict_stream(mixed, batch_size=4))


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(parallelism="tp"), NotImplementedError, "item 11"),
    (dict(parallelism="sp"), RuntimeError, "process group"),
    (dict(parallelism="dp"), ValueError, "parallelism"),
    (dict(precision="fp16"), ValueError, "precision"),
    (dict(batch_size=0), ValueError, "batch_size"),
])
def test_stream_options_are_checked_before_the_first_frame(pair, kwargs, exc,
                                                           match):
    _, pm = pair

    def never():
        raise AssertionError("a frame was read")
        yield

    with pytest.raises(exc, match=match):
        pm.predict_stream(never(), **kwargs)
