"""Frame helpers: DINO preprocessing of one image, attention-map extraction
and the Duckietown frame-folder iterator (reference ``dt_utils``).

NHWC float tensors on the CPU; the mass threshold of ``process_attentions``
runs in numpy.  Pillow is imported by ``dt_frames`` alone, so importing
this module needs neither Pillow nor matplotlib.
"""
from __future__ import annotations

import os
from typing import Generator, Optional

import numpy as np
import torch

from dino_tpu_torch.ops.preprocess import normalize_imagenet
from dino_tpu_torch.ops.resize import resize_bilinear


def transform_img(img, patch_size: int = 8, grayscale: bool = False,
                  resolution: int = 480) -> torch.Tensor:
    """Preprocess a PIL image or array for DINO: cv2-exact bilinear resize
    to resolution², ImageNet-normalize (grayscale: /255 only, as the
    reference), crop to a patch-size multiple.  Returns (1, H, W, 3)
    float32 NHWC."""
    x = np.asarray(img)
    if x.dtype != np.uint8:
        x = np.clip(x, 0, 255).astype(np.uint8)
    if grayscale:
        g = (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])
        x = np.repeat(g[..., None], 3, axis=-1).astype(np.uint8)
    t = resize_bilinear(torch.from_numpy(x), resolution, resolution,
                        round_uint8=True)
    t = t / 255.0 if grayscale else normalize_imagenet(t)
    h = t.shape[0] - t.shape[0] % patch_size
    w = t.shape[1] - t.shape[1] % patch_size
    return t[None, :h, :w, :]


def process_attentions(attentions, threshold: Optional[float] = None,
                       patch_size: int = 8,
                       resolution: int = 480) -> np.ndarray:
    """Per-head CLS attention maps (nh, res/P, res/P), optionally binarized
    to the smallest set of patches holding ``threshold`` of the mass.

    attentions: (1, nh, N, N) probabilities, or the CLS-row form (1, nh, 1,
    N) of ``get_last_selfattention(cls_only=True)``; both index the same
    row.
    """
    attentions = np.asarray(attentions)
    nh = attentions.shape[1]
    w_featmap = resolution // patch_size
    h_featmap = resolution // patch_size

    cls = attentions[0, :, 0, 1:].reshape(nh, -1)

    if threshold is not None:
        idx = np.argsort(cls, axis=1)
        val = np.take_along_axis(cls, idx, axis=1)
        val = val / val.sum(axis=1, keepdims=True)
        cumval = np.cumsum(val, axis=1)
        th_attn = cumval > (1 - threshold)
        idx2 = np.argsort(idx, axis=1)
        th_attn = np.take_along_axis(th_attn, idx2, axis=1)
        return th_attn.reshape(nh, w_featmap, h_featmap).astype(np.float32)

    return cls.reshape(nh, w_featmap, h_featmap)


def dt_frames(path: str, subset=None, max: Optional[int] = None,
              label_path: Optional[str] = None) -> Generator:
    """Iterate the Duckietown frame folder ``path`` as PIL images, sorted
    by name: (index, image) or, with ``label_path``, (index, image, mask).
    ``path`` has no default: the frames live outside the checkout."""
    from PIL import Image

    files = [f for f in os.listdir(path)
             if f.endswith(".png") or f.endswith(".jpg")]
    files.sort()
    j = 0
    for i, f in enumerate(files):
        if subset is not None and i not in subset:
            continue
        with open(os.path.join(path, f), "rb") as file:
            img = Image.open(file).convert("RGB")
        j += 1
        if label_path is None:
            yield i, img
        else:
            with open(os.path.join(label_path, f), "rb") as file:
                mask = Image.open(file).convert("RGB")
            yield i, img, mask
        if max is not None and j == max:
            break
