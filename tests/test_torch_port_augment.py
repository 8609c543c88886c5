"""The port's host augmentation recipe (dino_tpu_torch/data/augment.py) vs
dino_tpu's, byte for byte, on the CPU.

dino_tpu computes its pixels on two backends: cv2 with numpy recipes (its
native library switched off here, so its warp and blur take the numpy
definitions) and the native C++ batch pipeline.  The port's numpy rung
(its native library switched off), its numpy path with the native warp and
blur, and its own build of the native pipeline must give the same bytes as
both, for parameters that reach every branch: crop, affine, flip, each
jitter op in several orders, and every blur size k = 3..41.
"""
import cv2
import numpy as np
import pytest

from dino_tpu.data import augment as jaug
from dino_tpu.data import native_loader as jnative
from dino_tpu_torch.data import augment as taug
from dino_tpu_torch.data import native_loader as tnative

SIZE = 96  # the output canvas of the pixel cases (the bench's 480 below)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """A 120x160 JPEG on disk (the native pipelines read files), its
    decoded pixels and a 7-class mask."""
    from PIL import Image
    rs = np.random.RandomState(0)
    img = rs.randint(0, 255, (120, 160, 3)).astype(np.uint8)
    img[:, :80] //= 3  # some structure for the crop and the blur
    path = str(tmp_path_factory.mktemp("aug") / "img.jpg")
    Image.fromarray(img).save(path, quality=95)
    raw = tnative.decode(path)
    assert raw is not None, tnative.build_error
    np.testing.assert_array_equal(raw, jnative.decode(path))
    mask = rs.randint(0, 7, (120, 160)).astype(np.int32)
    return path, raw, mask


_BASE = {"crop": None, "affine": None, "flip": False, "jitter": None,
         "blur": None}
_AFFINE = np.array([[0.95, 0.26, 12.0], [-0.26, 0.95, -30.0]])


def _cases():
    """Parameter dicts covering every branch, plus draws from seeds."""
    cases = [dict(_BASE), {**_BASE, "flip": True},
             {**_BASE, "crop": (5, 9, 60, 81)},
             {**_BASE, "crop": (0, 0, SIZE, SIZE), "flip": True},
             {**_BASE, "affine": _AFFINE},
             {**_BASE, "crop": (3, 7, 50, 44), "affine": _AFFINE,
              "flip": True}]
    factors = (1.3, 0.85, 1.15, 0.12)
    for order in ([0, 1, 2, 3], [3, 2, 1, 0], [1, 3, 0, 2], [2, 0, 3, 1]):
        cases.append({**_BASE, "jitter": (np.array(order), factors)})
    cases += [{**_BASE, "blur": k} for k in range(3, 42, 2)]
    for seed in range(12):
        cases.append(jaug.draw_params(np.random.default_rng(seed), SIZE))
    return cases


CASES = _cases()


def _no_native(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)


@pytest.mark.parametrize("seed", range(200))
def test_draw_and_pack_params_equal(seed):
    want = jaug.draw_params(np.random.default_rng(seed), 480)
    got = taug.draw_params(np.random.default_rng(seed), 480)
    np.testing.assert_array_equal(taug.pack_params(got),
                                  jaug.pack_params(want))
    assert got["flip"] == want["flip"] and got["blur"] == want["blur"]
    assert got["crop"] == want["crop"]
    for key in ("affine", "jitter"):
        assert (got[key] is None) == (want[key] is None)
    if want["jitter"] is not None:
        np.testing.assert_array_equal(got["jitter"][0], want["jitter"][0])
        assert got["jitter"][1] == want["jitter"][1]


def test_cases_reach_every_branch():
    seen = {k: 0 for k in _BASE}
    for p in CASES:
        for k in _BASE:
            seen[k] += bool(p[k] is not None and p[k] is not False)
    assert all(seen.values()), seen
    assert {p["blur"] for p in CASES} >= set(range(3, 42, 2))


@pytest.mark.parametrize("i", range(len(CASES)))
def test_apply_params_equals_dino_tpu_on_both_backends(sample, i,
                                                       monkeypatch):
    path, raw, mask = sample
    p = CASES[i]
    # dino_tpu's native backend and the port's own build of it
    want_native = jnative.augment_batch([path], [mask], SIZE,
                                        jaug.pack_params(p)[None])
    got_native = tnative.augment_batch([path], [mask], SIZE,
                                       taug.pack_params(p)[None])
    # the port's numpy path with the native warp and blur
    got_mixed = taug.apply_params(p, raw.copy(), mask.copy(), SIZE)
    _no_native(monkeypatch)
    want_cv2 = jaug.apply_params(p, raw.copy(), mask.copy(), SIZE)
    got_numpy = taug.apply_params(p, raw.copy(), mask.copy(), SIZE)
    want_native = (want_native[0][0], want_native[1][0])
    got_native = (got_native[0][0], got_native[1][0])
    # each rung gives dino_tpu's bytes on the same rung
    for got, want in ((got_numpy, want_cv2), (got_mixed, want_cv2),
                      (got_native, want_native)):
        np.testing.assert_array_equal(got[0], want[0], err_msg=str(p))
        np.testing.assert_array_equal(got[1], want[1], err_msg=str(p))
    # images agree across the rungs; masks may not (see below)
    np.testing.assert_array_equal(got_numpy[0], got_native[0], err_msg=str(p))


def test_crop_masks_differ_between_dino_tpu_rungs(sample):
    """A fault of dino_tpu that the port reproduces rung by rung: after a
    crop, the native pipeline resizes the mask with floor(x * n_in / n_out)
    (native/dtloader.cpp:resize_nearest_i32), cv2 with
    floor(x * (1 / (n_out / n_in))); where x * n_in / n_out is an integer
    the second can fall one below (x = 72 for 68 -> 96 rows: 50, not 51),
    so the two rungs train on labels that differ in that row."""
    path, raw, mask = sample
    p = {**_BASE, "crop": (2, 0, 62, 68)}
    native = jnative.augment_batch([path], [mask], SIZE,
                                   jaug.pack_params(p)[None])[1][0]
    numpy_rung = taug.apply_params(p, raw.copy(), mask.copy(), SIZE)[1]
    differ = np.nonzero((native != numpy_rung).any(axis=1))[0]
    assert list(differ) == [72]


def test_apply_params_at_480(sample, monkeypatch):
    """The bench's canvas, a draw with every op but the blur and one with
    the largest blur."""
    path, raw, mask = sample
    for p in ({**_BASE, "crop": (40, 30, 300, 310), "affine": _AFFINE,
               "flip": True, "jitter": (np.array([3, 1, 0, 2]),
                                        (0.7, 1.1, 0.9, -0.15))},
              {**_BASE, "blur": 41}):
        want = tnative.augment_batch([path], [mask], 480,
                                     taug.pack_params(p)[None])
        with monkeypatch.context() as m:
            _no_native(m)
            ref = jaug.apply_params(p, raw.copy(), mask.copy(), 480)
            got = taug.apply_params(p, raw.copy(), mask.copy(), 480)
        for a, b, c in zip(got, ref, (want[0][0], want[1][0])):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("shape, size", [((480, 640), 480), ((480, 640), 64),
                                         ((120, 160), 480), ((81, 50), 96),
                                         ((480, 480), 480)])
def test_resize_pair_equals_cv2(shape, size):
    """cv2.resize INTER_LINEAR (images) and INTER_NEAREST (int32 masks),
    down and up."""
    rs = np.random.RandomState(size)
    img = rs.randint(0, 256, shape + (3,)).astype(np.uint8)
    mask = rs.randint(0, 7, shape).astype(np.int32)
    got_img, got_mask = taug.resize_pair(img, mask, size)
    np.testing.assert_array_equal(
        got_img, cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR))
    np.testing.assert_array_equal(
        got_mask, cv2.resize(mask, (size, size),
                             interpolation=cv2.INTER_NEAREST))
    assert got_mask.dtype == np.int32


def test_resize_pair_is_not_the_predict_resize():
    """The float resize of the predict path rounds differently from cv2's
    fixed point; the augmentation must not use it."""
    from dino_tpu_torch.ops.resize import resize_bilinear
    import torch
    img = np.random.RandomState(1).randint(0, 256, (480, 640, 3)).astype(
        np.uint8)
    ours = taug.resize_pair(img, None, 480)[0]
    pred = resize_bilinear(torch.from_numpy(img)[None].float(), 480, 480)
    pred = pred[0].round().clamp(0, 255).to(torch.uint8).numpy()
    assert (ours != pred).any()


def test_gaussian_taps_equal():
    from dino_tpu.ops.device_augment import _gaussian_taps as jtaps
    for k in range(3, 42, 2):
        np.testing.assert_array_equal(taug._gaussian_taps(k), jtaps(k))
