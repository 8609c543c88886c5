"""VOC-style Duckietown segmentation dataset and the host loading pipeline.

The port's ``dino_tpu/data/dataset.py``: ``JPEGImages/*.jpg`` paired with
``SegmentationClass/<name>.npy`` masks; images are resized (or augmented)
to the training resolution, masks nearest-resized to the (res/8)^2 token
grid and flattened.  An epoch is ``samples_per_epoch`` uniformly resampled
images, whatever the dataset's size.

Batches are uint8 images and int32 grid labels on the host; the train and
eval steps normalize on the device.  Where the pixels are computed is a
ladder of rungs that give ``dino_tpu``'s bytes on the same rung:

  * the native C++ loader (``data/native_loader.py``), when it builds: one
    call per batch decodes and resizes (eval) or decodes and augments
    (train) on its own thread pool;
  * otherwise the numpy recipe (``data/augment.py``) per item on a thread
    pool, over frames decoded by the native library or Pillow.

On the eval path the two rungs resize differently, as in ``dino_tpu``: the
native batch uses the predict path's bilinear convention, the numpy rung
cv2's fixed-point INTER_LINEAR (``resize_pair``).  ``backend='cv2'`` names
the numpy rung (``dino_tpu``'s name for it).

``backend='device'`` moves the augmentation's pixels to the device
(``ops/device_augment.py``): the host decodes and resizes, warps the 25% of
samples whose affine fires and composes the grid labels
(``augment_grid_mask``); the batches are uint8 frames on the device and
int32 grid labels on the host.
"""
from __future__ import annotations

import concurrent.futures as cf
import glob
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from dino_tpu_torch.data import native_loader
from dino_tpu_torch.data.augment import (apply_params, draw_params,
                                         pack_params, resize_pair,
                                         stage_device_sample)
from dino_tpu_torch.data.prefetch import prefetched
from dino_tpu_torch.ops.device_augment import (augment_grid_mask,
                                               device_augment_batch)
from dino_tpu_torch.ops.resize import resize_nearest

BACKENDS = ("auto", "native", "cv2", "device")


class DuckieSegDataset:
    """Index-addressable (image uint8 (res, res, 3), mask int32 (res/8)^2)
    pairs.

    A subclass that holds its frames in memory overrides ``_load_raw``
    (full-size image and mask), ``_load_mask`` and ``__len__`` and sets
    ``from_jpeg_files = False``: the native rungs read JPEG files, so such a
    dataset always takes the numpy rung."""

    from_jpeg_files = True

    def __init__(self, path: str, augmented: bool = False,
                 resolution: int = 480, patch_size: int = 8,
                 backend: str = "auto"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown augmentation backend {backend!r}")
        self.path = path
        self.files = sorted(
            glob.glob(os.path.join(path, "JPEGImages", "*.jpg")))
        self.augmented = augmented
        self.resolution = resolution
        self.patch_size = patch_size
        self.backend = backend

    def __len__(self) -> int:
        return len(self.files)

    def _load_mask(self, idx: int) -> np.ndarray:
        name = os.path.splitext(os.path.basename(self.files[idx]))[0]
        return np.load(os.path.join(self.path, "SegmentationClass",
                                    name + ".npy")).astype(np.int32)

    def _load_img(self, idx: int) -> np.ndarray:
        return load_jpeg(self.files[idx])

    def _load_raw(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._load_img(idx), self._load_mask(idx)

    def get(self, idx: int, rng: Optional[np.random.Generator] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
        if self.augmented:
            rng = rng if rng is not None else np.random.default_rng()
            p = draw_params(rng, self.resolution)
            img, mask = apply_params(p, *self._load_raw(idx),
                                     self.resolution)
        else:
            img = (native_loader.decode_resize(
                self.files[idx], self.resolution, self.resolution)
                if self.from_jpeg_files else None)
            if img is not None:
                mask = resize_nearest(self._load_mask(idx), self.resolution,
                                      self.resolution)
            else:
                img, mask = resize_pair(*self._load_raw(idx),
                                        self.resolution)
        grid = self.resolution // self.patch_size
        return img, resize_nearest(mask, grid, grid).reshape(-1)

    def __getitem__(self, idx: int):
        return self.get(idx)


def load_jpeg(path: str) -> np.ndarray:
    """Decode a JPEG file to (H, W, 3) uint8: the native library (libjpeg),
    else Pillow; raises when neither is there."""
    img = native_loader.decode(path)
    if img is not None:
        return img
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            f"cannot decode {path}: the native loader is unavailable "
            f"({native_loader.build_error or 'the decode failed'}) and "
            f"Pillow is not installed") from exc
    with open(path, "rb") as fh:
        return np.array(Image.open(fh).convert("RGB"))


def epoch_indices(rng: np.random.Generator, n_items: int,
                  samples_per_epoch: int = 1000) -> np.ndarray:
    """Uniform resampling with replacement (WeightedRandomSampler with
    equal weights)."""
    return rng.integers(0, n_items, size=samples_per_epoch)


def _params_for(seed, size: int) -> dict:
    """A sample's augmentation parameters from its own seed: the one place
    the per-sample rng is built and consumed, shared by every rung."""
    rng = (np.random.default_rng(seed) if seed is not None
           else np.random.default_rng())
    return draw_params(rng, size)


def loader_route(dataset: DuckieSegDataset) -> str:
    """Which rung ``batched_loader`` takes for ``dataset``: 'native batch'
    (eval), 'native augment' or 'device augment' (train) or 'numpy' (per
    item).  Raises for ``backend='native'`` without the native library."""
    if dataset.augmented and dataset.backend == "device":
        return "device augment"
    native = dataset.from_jpeg_files and native_loader.get_lib() is not None
    if dataset.augmented and dataset.backend == "native" and not native:
        raise RuntimeError(
            "backend='native' requested but the C++ loader is unavailable: "
            + (native_loader.build_error or "the dataset is not JPEG files"))
    if not native:
        return "numpy"
    if not dataset.augmented:
        return "native batch"
    return "native augment" if dataset.backend != "cv2" else "numpy"


def batched_loader(dataset: DuckieSegDataset, indices: np.ndarray,
                   batch_size: int, rng: Optional[np.random.Generator] = None,
                   num_workers: int = 8, device=None
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stacked batches, (B, res, res, 3) uint8 and (B, G*G) int32, in the
    order of ``indices``; the last batch keeps whatever is left.

    ``rng`` draws one seed per sample, from which that sample's
    augmentation parameters are drawn (``_params_for``), so every rung
    gives the same parameters from the same rng.  On the 'device augment'
    route the frames are a uint8 tensor on ``device`` (the card when None;
    raises without one)."""
    route = loader_route(dataset)
    res = dataset.resolution
    grid = res // dataset.patch_size

    if route == "native batch":
        for start in range(0, len(indices), batch_size):
            chunk = [int(i) for i in indices[start:start + batch_size]]
            imgs = native_loader.load_batch(
                [dataset.files[i] for i in chunk], res, res)
            if imgs is None:  # an unreadable file: this batch per item
                xs, ys = zip(*[dataset.get(i) for i in chunk])
                yield np.stack(xs), np.stack(ys)
                continue
            yield imgs, np.stack([
                resize_nearest(resize_nearest(dataset._load_mask(i), res,
                                              res), grid, grid).reshape(-1)
                for i in chunk])
        return

    seeds = (rng.integers(0, 2**63, size=len(indices))
             if rng is not None else [None] * len(indices))

    if route == "native augment":
        for start in range(0, len(indices), batch_size):
            chunk = [int(i) for i in indices[start:start + batch_size]]
            chunk_seeds = seeds[start:start + batch_size]
            params = [_params_for(s, res) for s in chunk_seeds]
            native = native_loader.augment_batch(
                [dataset.files[i] for i in chunk],
                [dataset._load_mask(i) for i in chunk], res,
                np.stack([pack_params(p) for p in params]))
            if native is None:  # an unreadable file: the same parameters
                items = []      # through the numpy recipe, per item
                for i, p in zip(chunk, params):
                    img, mask = apply_params(p, *dataset._load_raw(i), res)
                    items.append((img, resize_nearest(mask, grid,
                                                      grid).reshape(-1)))
                xs, ys = zip(*items)
                yield np.stack(xs), np.stack(ys)
                continue
            imgs, masks = native
            yield imgs, np.stack([
                resize_nearest(m, grid, grid).reshape(-1) for m in masks])
        return

    if route == "device augment":
        yield from _device_augment_batches(dataset, indices, batch_size,
                                           seeds, num_workers, device)
        return

    def fetch(args):
        idx, seed = args
        item_rng = np.random.default_rng(seed) if seed is not None else None
        return dataset.get(int(idx), item_rng)

    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        batch = []
        for item in pool.map(fetch, zip(indices, seeds)):
            batch.append(item)
            if len(batch) == batch_size:
                xs, ys = zip(*batch)
                yield np.stack(xs), np.stack(ys)
                batch = []
        if batch:
            xs, ys = zip(*batch)
            yield np.stack(xs), np.stack(ys)


def _device_augment_batches(dataset, indices, batch_size, seeds,
                            num_workers, device):
    """The 'device augment' route: per chunk, the host draws the parameters,
    loads and resizes the frames (one native ``load_batch``, else
    ``_load_raw`` and ``resize_pair`` per sample), warps the samples whose
    affine fires (``stage_device_sample``) and composes their grid labels;
    the device runs the rest (``device_augment_batch``).  The host part of
    chunk k+1 runs on a prefetch thread, its samples on a pool of
    ``num_workers`` threads, while chunk k is augmented and trained on."""
    res = dataset.resolution
    grid = res // dataset.patch_size
    native = dataset.from_jpeg_files and native_loader.get_lib() is not None

    def stage(args):
        i, p, img = args
        if img is None:
            img, mask = dataset._load_raw(i)
            img = resize_pair(img, None, res)[0]
        else:
            mask = dataset._load_mask(i)
        img, packed = stage_device_sample(img, p, res)
        return img, packed, augment_grid_mask(resize_nearest(
            np.asarray(mask, np.int32), res, res), p, res, grid)

    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        def load_chunk(start):
            chunk = [int(i) for i in indices[start:start + batch_size]]
            params = [_params_for(s, res)
                      for s in seeds[start:start + batch_size]]
            imgs = (native_loader.load_batch(
                [dataset.files[i] for i in chunk], res, res)
                if native else None)
            frames = list(imgs) if imgs is not None else [None] * len(chunk)
            imgs, packed, masks = zip(*pool.map(stage, zip(chunk, params,
                                                           frames)))
            return np.stack(imgs), np.stack(packed), np.stack(masks)

        for _, (imgs, packed, masks) in prefetched(
                range(0, len(indices), batch_size), load_chunk):
            yield device_augment_batch(imgs, packed, device), masks
