"""The port's dataset, loader and native-library wrapper vs dino_tpu's, on
the CPU: the same indices and rng give the same bytes, on the native rung
and on the numpy rung (the native library switched off in both packages).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dino_tpu.data import dataset as jds
from dino_tpu.data import native_loader as jnative
from dino_tpu_torch.data import dataset as tds
from dino_tpu_torch.data import native_loader as tnative
from tests.test_train_smoke import _make_split

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 64
INDICES = np.array([3, 1, 4, 1, 5, 9, 2])  # batch 3: a partial last batch


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    _make_split(root, "train", 12, 0)
    return os.path.join(root, "dt_real_voc_train")


@pytest.fixture(params=["native", "numpy"])
def rung(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    else:
        assert tnative.get_lib() is not None, tnative.build_error
    return request.param


def _batches(mod, path, augmented, res, seed):
    ds = mod.DuckieSegDataset(path, augmented=augmented, resolution=res)
    rng = None if seed is None else np.random.default_rng(seed)
    return list(mod.batched_loader(ds, INDICES, 3, rng=rng))


@pytest.mark.parametrize("augmented, res", [(False, RES), (False, 48),
                                            (True, RES), (True, 96)])
def test_batched_loader_bytes_equal_dino_tpu(split, rung, augmented, res):
    seed = 7 if augmented else None
    want = _batches(jds, split, augmented, res, seed)
    got = _batches(tds, split, augmented, res, seed)
    ds = tds.DuckieSegDataset(split, augmented=augmented, resolution=res)
    assert tds.loader_route(ds) == (
        "numpy" if rung == "numpy" else
        "native augment" if augmented else "native batch")
    assert [x.shape[0] for x, _ in got] == [3, 3, 1]
    for (gx, gy), (wx, wy) in zip(got, want, strict=True):
        assert gx.dtype == np.uint8 and gx.shape[1:] == (res, res, 3)
        assert gy.shape[1:] == ((res // 8) ** 2,)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_eval_rungs_resize_differently(split, monkeypatch):
    """As in dino_tpu, the native eval batch resizes with the predict
    path's bilinear convention and the numpy rung with cv2's fixed point,
    so the two rungs' eval pixels differ (by one level)."""
    native = _batches(tds, split, False, 48, None)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    numpy_rung = _batches(tds, split, False, 48, None)
    diff = np.abs(native[0][0].astype(int) - numpy_rung[0][0].astype(int))
    assert 0 < diff.max() <= 1
    np.testing.assert_array_equal(native[0][1], numpy_rung[0][1])


def test_cv2_backend_is_the_numpy_rung(split):
    ds = tds.DuckieSegDataset(split, augmented=True, resolution=RES,
                              backend="cv2")
    assert tds.loader_route(ds) == "numpy"
    got = list(tds.batched_loader(ds, INDICES, 3,
                                  rng=np.random.default_rng(7)))
    jd = jds.DuckieSegDataset(split, augmented=True, resolution=RES,
                              backend="cv2")
    want = list(jds.batched_loader(jd, INDICES, 3,
                                   rng=np.random.default_rng(7)))
    for (gx, gy), (wx, wy) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("seed", range(5))
def test_epoch_indices_equal(seed):
    for n, k in ((12, 1000), (3, 7), (1, 5)):
        np.testing.assert_array_equal(
            tds.epoch_indices(np.random.default_rng([seed, 1]), n, k),
            jds.epoch_indices(np.random.default_rng([seed, 1]), n, k))


def test_native_decode_equals_dino_tpu(split):
    ds = tds.DuckieSegDataset(split)
    for f in ds.files[:3]:
        got = tnative.decode(f)
        assert got is not None
        np.testing.assert_array_equal(got, jnative.decode(f))
        with open(f, "rb") as fh:
            data = fh.read()
        np.testing.assert_array_equal(tnative.decode_bytes(data),
                                      jnative.decode_bytes(data))
        np.testing.assert_array_equal(
            tnative.decode_resize_bytes(data, 40, 48),
            jnative.decode_resize_bytes(data, 40, 48))
        np.testing.assert_array_equal(tnative.decode_resize(f, 40, 48),
                                      jnative.decode_resize(f, 40, 48))
    np.testing.assert_array_equal(tnative.load_batch(ds.files[:4], 32, 32),
                                  jnative.load_batch(ds.files[:4], 32, 32))
    assert tnative.decode_bytes(b"\x89PNG....") is None
    assert tnative.load_batch(ds.files[:1] + ["/nonexistent.jpg"], 8,
                              8) is None


def test_pillow_rung_decodes(split, monkeypatch):
    from PIL import Image
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    ds = tds.DuckieSegDataset(split)
    img, mask = ds._load_raw(0)
    with open(ds.files[0], "rb") as fh:
        np.testing.assert_array_equal(img,
                                      np.array(Image.open(fh).convert("RGB")))
    assert mask.dtype == np.int32 and mask.shape == img.shape[:2]


def test_no_decoder_raises_naming_both(split, monkeypatch):
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    ds = tds.DuckieSegDataset(split)
    with pytest.raises(RuntimeError, match="native loader.*Pillow"):
        ds._load_img(0)


def test_device_backend_raises_item_7(split, monkeypatch):
    """The device backend builds and routes its batches to the device
    augmentation; without a card it raises unless the CPU is asked for."""
    ds = tds.DuckieSegDataset(split, augmented=True, resolution=RES,
                              backend="device")
    assert tds.loader_route(ds) == "device augment"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tds.batched_loader(ds, np.arange(2), 2,
                                rng=np.random.default_rng(0)))
    x, y = next(tds.batched_loader(ds, np.arange(2), 2,
                                   rng=np.random.default_rng(0),
                                   device="cpu"))
    assert torch.is_tensor(x) and x.dtype == torch.uint8
    assert isinstance(y, np.ndarray) and y.shape == (2, (RES // 8) ** 2)
    with pytest.raises(ValueError, match="unknown augmentation backend"):
        tds.DuckieSegDataset(split, backend="opencl")


def test_native_backend_without_library_raises(split, monkeypatch):
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    ds = tds.DuckieSegDataset(split, augmented=True, backend="native")
    with pytest.raises(RuntimeError, match="backend='native'"):
        next(tds.batched_loader(ds, INDICES, 3, rng=np.random.default_rng(0)))


def test_library_builds_into_the_port_build_dir(tmp_path):
    """A fresh process builds native/dtloader.cpp into
    $DINO_TPU_TORCH_BUILD_DIR, named by the CPU tag, and writes nothing
    under native/."""
    native_dir = os.path.join(REPO, "native")

    def listing():
        return {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns
                for f in os.listdir(native_dir)}

    before = listing()
    code = ("import sys\n"
            "from dino_tpu_torch.data import native_loader as nl\n"
            "assert nl.get_lib() is not None, nl.build_error\n"
            "print(nl.library_path())\n")
    env = dict(os.environ, DINO_TPU_TORCH_BUILD_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         timeout=300, cwd=REPO, env=env, capture_output=True,
                         text=True).stdout.strip()
    from dino_tpu_torch.utils.hostcpu import cpu_tag
    assert out == str(tmp_path / f"libdtloader.{cpu_tag()}.so")
    assert os.listdir(tmp_path) == [f"libdtloader.{cpu_tag()}.so"]
    assert listing() == before


def test_port_imports_without_cv2_pil_pandas_matplotlib():
    blocked = ("cv2", "PIL", "pandas", "matplotlib")
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in blocked)
            + "import dino_tpu_torch.api\n"
            "import dino_tpu_torch.data.dataset\n"
            "import dino_tpu_torch.cli.run_experiment\n"
            "import dino_tpu_torch.cli.eval\n"
            "import chip_smoke\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{blocked!r} + ('jax', 'dino_tpu') and sys.modules[m] is not "
            f"None)\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-I", "-c", code], check=True,
                   timeout=300, cwd=REPO)
