"""The port's device augmentation (dino_tpu_torch/ops/device_augment.py and
the 'device augment' route of the loader and fit) against dino_tpu's
(dino_tpu/ops/device_augment.py) and against the host recipe, on the CPU.
Case by case as tests/test_device_augment.py holds dino_tpu.

Tolerances (the module's docstring states the rules): identity, flip,
jitter, blur, the grid labels and the host staging bit-equal to dino_tpu;
crop-resize at most one level from dino_tpu, and only where the exact
bilinear value lies within CROP_TIE_EPS of k + 0.5; against the host recipe
the gates of tests/test_device_augment.py (crop: MAD < 1.0 and grid
agreement >= 0.95; the full pipeline over 16 seeds: MAD < 2.5 and
agreement > 0.97).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tpu.data import augment as jaug
from dino_tpu.ops import device_augment as jdev
from dino_tpu_torch.data import augment as taug
from dino_tpu_torch.data import dataset as tds
from dino_tpu_torch.ops import device_augment as tdev
from dino_tpu_torch.ops.resize import resize_nearest

S = 64      # augmented canvas
GRID = 8    # token grid (S / patch 8)
CPU = torch.device("cpu")


def _rand_img(seed, h=S, w=S):
    """Smooth content plus noise, from a numpy seed."""
    rs = np.random.RandomState(seed)
    base = rs.randint(0, 255, (h // 8 + 2, w // 8 + 2, 3)).astype(np.uint8)
    img = taug.resize_linear_u8(base, h, w).astype(np.float32)
    return np.clip(img + rs.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)


def _rand_mask(seed, h=S, w=S):
    return np.random.RandomState(seed + 99).randint(0, 4, (h, w)).astype(
        np.int64)


def _null():
    return {"crop": None, "affine": None, "flip": False, "jitter": None,
            "blur": None}


def _grid(mask):
    return resize_nearest(np.asarray(mask), GRID, GRID).reshape(-1)


def _port(staged, packed):
    return tdev.device_augment_batch(staged, packed, device=CPU).numpy()


def _dino(staged, packed):
    return np.asarray(jdev.device_augment_batch(staged, packed))


def _run_all(params, imgs, masks):
    """(oracle images, oracle grid labels, port images, port grid labels,
    dino_tpu images) for one batch through the loader's host staging."""
    oracle = [taug.apply_params(p, im, m, S)
              for p, im, m in zip(params, imgs, masks)]
    staged, packed = taug.prepare_device_batch(np.stack(imgs).copy(),
                                               params, S)
    grids = np.stack([tdev.augment_grid_mask(
        resize_nearest(m.astype(np.int32), S, S), p, S, GRID)
        for p, m in zip(params, masks)])
    return (np.stack([o[0] for o in oracle]),
            np.stack([_grid(o[1]) for o in oracle]), _port(staged, packed),
            grids, _dino(staged, packed))


def _finish(x_u8, packed):
    """The port's chain after the crop (flip, jitter, blur) on float
    pixels."""
    x = torch.from_numpy(np.ascontiguousarray(x_u8)).to(torch.float32)
    for op in (tdev.flip, tdev.jitter, tdev.blur):
        x = op(x, packed)
    return x.to(torch.uint8).numpy()


def _dino_crop(staged, packed):
    """dino_tpu's crop stage, jitted as its device_augment_batch runs it
    (eagerly, XLA keeps the division by the size)."""
    fn = jax.jit(jax.vmap(jdev._crop_resize))
    return np.asarray(fn(jnp.asarray(staged, jnp.float32),
                         jnp.asarray(packed)))


def _exact_crop(staged, packed):
    """The crop's bilinear value in float64 from the port's taps."""
    size = staged.shape[1]
    ly, hy, w0y, w1y, lx, hx, w0x, w1x = (
        a.astype(np.float64) if a.dtype == np.float32 else a
        for a in tdev.crop_taps(packed, size))
    b = np.arange(len(staged))[:, None]
    x = staged.astype(np.float64)
    r = (x[b, ly] * w0y[..., None, None] + x[b, hy] * w1y[..., None, None])
    r = r.transpose(0, 2, 1, 3)
    v = r[b, lx] * w0x[..., None, None] + r[b, hx] * w1x[..., None, None]
    return v.transpose(0, 2, 1, 3)


def _assert_crop_rule(staged, packed, got, want):
    """got (port) vs want (dino_tpu) crop outputs: at most one level apart,
    and only where the exact value is within CROP_TIE_EPS of k + 0.5."""
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, d.max()
    if d.any():
        v = _exact_crop(staged, packed)[d > 0]
        dist = np.abs(v - (np.floor(v) + 0.5))
        assert dist.max() < tdev.CROP_TIE_EPS, dist.max()
    return int((d > 0).sum())


def _assert_port_vs_dino(staged, packed, port, dino):
    """Samples without a crop: the same bits.  With a crop: the port's
    crop under the tie rule, and the port's later ops on dino_tpu's crop
    output give dino_tpu's bits."""
    crop = packed[:, 0] > 0.5
    np.testing.assert_array_equal(port[~crop], dino[~crop])
    if crop.any():
        d_crop = _dino_crop(staged[crop], packed[crop])
        p_crop = tdev.crop_resize(torch.from_numpy(staged[crop]).to(
            torch.float32), packed[crop]).numpy()
        _assert_crop_rule(staged[crop], packed[crop], p_crop, d_crop)
        np.testing.assert_array_equal(
            _finish(d_crop.astype(np.uint8), packed[crop]), dino[crop])


def test_identity_bit_exact():
    o_img, o_grid, p_img, p_grid, d_img = _run_all(
        [_null()], [_rand_img(0)], [_rand_mask(0)])
    np.testing.assert_array_equal(p_img, o_img)
    np.testing.assert_array_equal(p_img, d_img)
    np.testing.assert_array_equal(p_grid, o_grid)


def test_flip_bit_exact():
    params = [dict(_null(), flip=True), _null(), dict(_null(), flip=True)]
    o_img, o_grid, p_img, p_grid, d_img = _run_all(
        params, [_rand_img(i) for i in (1, 2, 3)],
        [_rand_mask(i) for i in (1, 2, 3)])
    np.testing.assert_array_equal(p_img, o_img)
    np.testing.assert_array_equal(p_img, d_img)
    np.testing.assert_array_equal(p_grid, o_grid)


def test_jitter_bit_exact():
    rng = np.random.default_rng(13)
    for _ in range(6):
        p = dict(_null(), jitter=jaug._draw_jitter(rng))
        o_img, _, p_img, _, d_img = _run_all([p], [_rand_img(4)],
                                             [_rand_mask(4)])
        np.testing.assert_array_equal(p_img, o_img, err_msg=str(p["jitter"]))
        np.testing.assert_array_equal(p_img, d_img)


def test_jitter_mixed_orders_and_flags_bit_exact():
    """One batch whose samples run the four ops in different orders, with
    two samples not jittered: every sample as the host recipe and as
    dino_tpu's batch (which evaluates every branch and selects)."""
    rng = np.random.default_rng(21)
    factors = [(1.4, 0.83, 1.17, 0.11), (0.6, 1.19, 0.81, -0.17),
               (1.05, 0.9, 1.2, 0.02), (0.75, 1.1, 0.9, -0.2)]
    orders = [[0, 1, 2, 3], [3, 2, 1, 0], [1, 3, 0, 2], [2, 0, 3, 1],
              [0, 3, 1, 2], [3, 0, 2, 1]]
    params = []
    for i, order in enumerate(orders):
        params.append(dict(_null(), jitter=(np.array(order),
                                            factors[i % 4])))
        if i in (1, 4):
            params.append(_null())
    params.append(dict(_null(), jitter=jaug._draw_jitter(rng)))
    imgs = [_rand_img(30 + i) for i in range(len(params))]
    masks = [_rand_mask(30 + i) for i in range(len(params))]
    o_img, _, p_img, _, d_img = _run_all(params, imgs, masks)
    np.testing.assert_array_equal(p_img, o_img)
    np.testing.assert_array_equal(p_img, d_img)


def test_hsv_round_trip_bit_equal_host_exhaustive():
    """RGB2HSV and HSV2RGB equal the host recipes over every (h, s) at a v
    sweep, and over 200k random RGB triples."""
    H, Su = np.meshgrid(np.arange(180), np.arange(256), indexing="ij")
    for v_val in (0, 1, 37, 128, 254, 255):
        h = H.reshape(-1).astype(np.int64)
        s = Su.reshape(-1).astype(np.int64)
        v = np.full_like(h, v_val)
        want = taug.hsv_to_rgb_u8(h, s, v)
        got = tdev.hsv_to_rgb(*(torch.from_numpy(a).to(torch.int32)
                                for a in (h, s, v))).numpy()
        np.testing.assert_array_equal(got.astype(np.uint8), want,
                                      err_msg=f"v={v_val}")
    rgb = np.random.RandomState(3).randint(0, 256, (200000, 3)).astype(
        np.uint8)
    want = taug.rgb_to_hsv_u8(rgb)
    got = tdev.rgb_to_hsv(torch.from_numpy(rgb).to(torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("k", [3, 5, 7, 9, 13, 21, 41])
def test_blur_bit_exact(k):
    params = [dict(_null(), blur=k), _null(), dict(_null(), blur=3)]
    o_img, _, p_img, _, d_img = _run_all(
        params, [_rand_img(5 + i) for i in range(3)],
        [_rand_mask(5) for _ in range(3)])
    np.testing.assert_array_equal(p_img, o_img, err_msg=str(k))
    np.testing.assert_array_equal(p_img, d_img, err_msg=str(k))


def test_crop_is_the_stated_two_tap_rule():
    """The port's crop is fl(fl(w0 x0) + fl(w1 x1)) per axis, rows first,
    then floor(v + .5), bit for bit (a numpy float32 emulation)."""
    rng = np.random.default_rng(7)
    params = [dict(_null(), crop=jaug._draw_crop(rng, S)) for _ in range(6)]
    params.append(_null())
    staged = np.stack([_rand_img(60 + i) for i in range(len(params))])
    packed = np.stack([taug.pack_params(p) for p in params])
    got = tdev.crop_resize(torch.from_numpy(staged).to(torch.float32),
                           packed).numpy()
    ly, hy, w0y, w1y, lx, hx, w0x, w1x = tdev.crop_taps(packed, S)
    b = np.arange(len(staged))[:, None]
    x = staged.astype(np.float32)
    r = (x[b, ly] * w0y[..., None, None]) + (x[b, hy] * w1y[..., None, None])
    r = r.transpose(0, 2, 1, 3)
    v = (r[b, lx] * w0x[..., None, None]) + (r[b, hx] * w1x[..., None, None])
    want = np.clip(np.floor(v.transpose(0, 2, 1, 3) + np.float32(0.5)),
                   0, 255)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[-1], staged[-1])  # crop off


@pytest.mark.parametrize("size, n", [(S, 24), (480, 24)])
def test_crop_tie_rule_against_dino_tpu(size, n):
    rng = np.random.default_rng(size)
    packed = np.stack([taug.pack_params(dict(
        _null(), crop=jaug._draw_crop(rng, size))) for _ in range(n)])
    staged = np.random.RandomState(size).randint(
        0, 256, (n, size, size, 3)).astype(np.uint8)
    got = tdev.crop_resize(torch.from_numpy(staged).to(torch.float32),
                           packed).numpy()
    _assert_crop_rule(staged, packed, got, _dino_crop(staged, packed))


def test_crop_against_the_host_recipe():
    rng = np.random.default_rng(7)
    for _ in range(6):
        p = dict(_null(), crop=jaug._draw_crop(rng, S))
        o_img, o_grid, p_img, p_grid, _ = _run_all([p], [_rand_img(2)],
                                                   [_rand_mask(2)])
        mad = np.abs(p_img.astype(np.int32) - o_img.astype(np.int32)).mean()
        assert mad < 1.0, (p["crop"], mad)
        assert (p_grid == o_grid).mean() >= 0.95, p["crop"]


def test_affine_exact_on_both_streams():
    rng = np.random.default_rng(11)
    for _ in range(6):
        p = dict(_null(), affine=jaug._draw_affine(rng, S))
        o_img, o_grid, p_img, p_grid, d_img = _run_all(
            [p], [_rand_img(3)], [_rand_mask(3)])
        np.testing.assert_array_equal(p_img, o_img)
        np.testing.assert_array_equal(p_img, d_img)
        np.testing.assert_array_equal(p_grid, o_grid)


def test_full_pipeline_distribution():
    """16 seeds in one batch, every op combination: the host recipe's
    gates, and dino_tpu's bits up to the crop rule."""
    params = [jaug.draw_params(np.random.default_rng(s), S)
              for s in range(16)]
    imgs = [_rand_img(s + 40) for s in range(16)]
    masks = [_rand_mask(s + 40) for s in range(16)]
    o_img, o_grid, p_img, p_grid, d_img = _run_all(params, imgs, masks)
    mads = np.abs(p_img.astype(np.int32) - o_img.astype(np.int32)).mean(
        axis=(1, 2, 3))
    assert mads.mean() < 2.5, mads
    assert (p_grid == o_grid).mean(axis=1).mean() > 0.97
    staged, packed = taug.prepare_device_batch(np.stack(imgs).copy(),
                                               params, S)
    _assert_port_vs_dino(staged, packed, p_img, d_img)


def test_grid_mask_and_staging_bit_equal_dino_tpu():
    params = [jaug.draw_params(np.random.default_rng(100 + s), S)
              for s in range(40)]
    assert sum(p["affine"] is not None for p in params) >= 5
    imgs = np.stack([_rand_img(s) for s in range(40)])
    t_st, t_pk = taug.prepare_device_batch(imgs.copy(), params, S)
    j_st, j_pk = jaug.prepare_device_batch(imgs.copy(), params, S)
    np.testing.assert_array_equal(t_st, j_st)
    np.testing.assert_array_equal(t_pk, j_pk)
    assert not (t_pk[:, 5] > 0.5).any()
    for s, p in enumerate(params):
        m = resize_nearest(_rand_mask(s, 80, 100).astype(np.int32), S, S)
        np.testing.assert_array_equal(
            tdev.augment_grid_mask(m, p, S, GRID),
            jdev.augment_grid_mask(m, p, S, GRID))


def test_value_errors():
    img = _rand_img(9)[None]
    with pytest.raises(ValueError, match=r"\(B, 24\)"):
        tdev.device_augment_batch(img, np.zeros((1, 23), np.float32),
                                  device=CPU)
    p = dict(_null(), affine=jaug._draw_affine(np.random.default_rng(3), S))
    with pytest.raises(ValueError, match="affine flag"):
        tdev.device_augment_batch(img, taug.pack_params(p)[None],
                                  device=CPU)
    with pytest.raises(TypeError, match="host array"):
        tdev.device_augment_batch(img, torch.zeros((1, 24)), device=CPU)


class _FakeDS(tds.DuckieSegDataset):
    """Six 80x100 frames held in memory (the port's side)."""
    from_jpeg_files = False

    def __init__(self, backend):
        super().__init__("unused", augmented=True, resolution=S,
                         backend=backend)
        self.files = [f"im{i}" for i in range(6)]

    def _load_raw(self, idx):
        return _rand_img(idx, 80, 100), _rand_mask(idx, 80, 100)

    def _load_mask(self, idx):
        return _rand_mask(idx, 80, 100).astype(np.int32)


def test_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, packed = _rand_img(9)[None], np.zeros((1, 24), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.device_augment_batch(img, packed)
    ds = _FakeDS("device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tds.batched_loader(ds, np.arange(3), 3,
                                rng=np.random.default_rng(0)))
    out = tdev.device_augment_batch(img, packed, device="cpu")
    assert out.device == CPU and out.dtype == torch.uint8


def test_loader_device_route_against_dino_tpu():
    """The same rng through both packages' device routes: the grid labels
    the same bits, the frames dino_tpu's up to the crop rule; the frames
    are a uint8 tensor on the asked device, the labels a host array."""
    from dino_tpu.data.dataset import DuckieSegDataset as JaxDS
    from dino_tpu.data.dataset import batched_loader as jax_loader

    class JaxFake(JaxDS):
        def __init__(self):
            self.files = [f"im{i}" for i in range(6)]
            self.path, self.augmented, self.resolution = "unused", True, S
            self.patch_size, self.backend = 8, "device"

        def _load_raw(self, idx):
            return _rand_img(idx, 80, 100), _rand_mask(idx, 80, 100)

        def _load_mask(self, idx):
            return _rand_mask(idx, 80, 100).astype(np.int32)

    idx = np.arange(6)[::-1].copy()
    ds = _FakeDS("device")
    assert tds.loader_route(ds) == "device augment"
    calls = tdev.device_augment_batch.calls
    got = list(tds.batched_loader(ds, idx, 4, rng=np.random.default_rng(5),
                                  num_workers=3, device="cpu"))
    assert tdev.device_augment_batch.calls == calls + 2
    want = list(jax_loader(JaxFake(), idx, 4, rng=np.random.default_rng(5)))
    seeds = np.random.default_rng(5).integers(0, 2**63, size=len(idx))
    assert [len(x) for x, _ in got] == [4, 2]
    for k, ((gx, gy), (wx, wy)) in enumerate(zip(got, want, strict=True)):
        assert torch.is_tensor(gx) and gx.dtype == torch.uint8
        assert gx.device == CPU and tuple(gx.shape[1:]) == (S, S, 3)
        assert isinstance(gy, np.ndarray) and gy.dtype == np.int32
        np.testing.assert_array_equal(gy, np.asarray(wy))
        chunk = idx[4 * k:4 * k + 4]
        params = [tds._params_for(s, S) for s in seeds[4 * k:4 * k + 4]]
        staged, packed = taug.prepare_device_batch(np.stack([
            taug.resize_pair(_rand_img(i, 80, 100), None, S)[0]
            for i in chunk]), params, S)
        _assert_port_vs_dino(staged, packed, gx.numpy(), np.asarray(wx))


def _voc(root, seed, n_train):
    from PIL import Image
    rs = np.random.RandomState(seed)
    colors = np.array([[200, 40, 40], [40, 200, 40], [40, 40, 200]])
    for split, n in (("train", n_train), ("val", 2), ("test", 2)):
        jd = os.path.join(root, f"dt_real_voc_{split}", "JPEGImages")
        md = os.path.join(root, f"dt_real_voc_{split}", "SegmentationClass")
        os.makedirs(jd), os.makedirs(md)
        for i in range(n):
            mask = rs.randint(0, 3, (S, S)).astype(np.int64)
            img = np.clip(colors[mask] + rs.randn(S, S, 3) * 5, 0,
                          255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(jd, f"im{i}.jpg"),
                                      quality=95)
            np.save(os.path.join(md, f"im{i}.npy"), mask)


def _model(tmp_path, **kw):
    from dino_tpu_torch import DINOSeg
    _voc(str(tmp_path), 0, 8)
    base = dict(data_path=str(tmp_path), write_path=str(tmp_path / "out"),
                head="linear", n_blocks=1, n_classes=3, batch_size=4,
                lr=1e-3, optimizer="adam", max_epochs=2, random_init=True,
                augmented=True, train_resolution=S, seed=0,
                precision="fp32", device="cpu")
    base.update(kw)
    return DINOSeg(**base)


def test_fit_device_backend_smoke(tmp_path):
    """fit(augment_backend='device') on the CPU, asked for: every train
    batch goes through device_augment_batch (14 samples an epoch in
    batches of 4, the last batch of 2 padded where it lies)."""
    model = _model(tmp_path)
    calls = tdev.device_augment_batch.calls
    metrics = model.fit(samples_per_epoch=14, augment_backend="device")
    assert 0.0 <= metrics["test_acc"] <= 1.0
    assert tdev.device_augment_batch.calls == calls + 2 * 4


def test_fit_device_backend_composes_with_accum(tmp_path):
    model = _model(tmp_path, head="mlp", freeze_backbone=False,
                   max_epochs=1)
    calls = tdev.device_augment_batch.calls
    metrics = model.fit(samples_per_epoch=8, augment_backend="device",
                        accum_steps=2, cache_features=False)
    assert 0.0 <= metrics["test_acc"] <= 1.0
    assert tdev.device_augment_batch.calls == calls + 2


def test_pad_tail_pads_a_device_tensor_where_it_lies():
    from dino_tpu_torch.api import _pad_tail
    x = torch.arange(2 * 3, dtype=torch.uint8).reshape(2, 3)
    y = np.arange(2 * 4, dtype=np.int32).reshape(2, 4)
    (px, py), mask = _pad_tail([x, y], 4)
    assert torch.is_tensor(px) and isinstance(py, np.ndarray)
    np.testing.assert_array_equal(px.numpy(), [[0, 1, 2], [3, 4, 5],
                                               [3, 4, 5], [3, 4, 5]])
    np.testing.assert_array_equal(py[2:], [y[1], y[1]])
    np.testing.assert_array_equal(mask, [1, 1, 0, 0])
