"""cv2-compatible bilinear image resize, and a nearest-neighbour resize of
host arrays (label masks, attention maps).

The reference resizes uint8 camera frames with ``albumentations.Resize`` (cv2
``INTER_LINEAR``) before normalizing.  The same half-pixel bilinear semantics
run on the device:

  * src coord = (dst + 0.5) * n_in / n_out - 0.5, clamped at the low border
  * 2-tap linear weights, indices clamped to the valid range (replicate)
  * uint8 inputs are rounded half-up back to integers after resampling

``dino_tpu`` applies the dense (n_out, n_in) weight matrix as a float32 dot.
Its result at a pixel is fl(fl(w0*x0) + fl(w1*x1)): two products, each
rounded, then one rounded add (XLA's CPU dot does not fuse them).  The port
computes exactly that as two gathers, two multiplies and an add per axis:
elementwise ops round the same way on the CPU and the card, where a matmul
would not (an FMA or a TF32 product moves values that sit at k + 0.5 across
the ``floor(x + 0.5)`` rounding edge).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def bilinear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) float32 half-pixel bilinear resampling matrix."""
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1.0)
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    w = np.zeros((n_out, n_in), dtype=np.float64)
    rows = np.arange(n_out)
    np.add.at(w, (rows, np.clip(i0, 0, n_in - 1)), 1.0 - t)
    np.add.at(w, (rows, np.clip(i0 + 1, 0, n_in - 1)), t)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def bilinear_taps(n_in: int, n_out: int):
    """(i0, i1, w0, w1) per output index: the two nonzero entries of each
    row of :func:`bilinear_resize_matrix` (w1 = 0 where they merge at the
    border)."""
    w = bilinear_resize_matrix(n_in, n_out)
    rows = np.arange(n_out)
    i0 = np.argmax(w != 0, axis=1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w0 = w[rows, i0]
    w1 = np.where(i1 != i0, w[rows, i1], 0).astype(np.float32)
    return i0, i1, w0, w1


_DEVICE_TAPS: Dict[Tuple[int, int, torch.device], tuple] = {}


def _taps(n_in: int, n_out: int, device: torch.device):
    key = (n_in, n_out, device)
    if key not in _DEVICE_TAPS:
        _DEVICE_TAPS[key] = tuple(torch.from_numpy(a).to(device)
                                  for a in bilinear_taps(n_in, n_out))
    return _DEVICE_TAPS[key]


def _resample(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    i0, i1, w0, w1 = _taps(x.shape[dim], n_out, x.device)
    shape = [1] * x.dim()
    shape[dim] = n_out
    return (w0.reshape(shape) * x.index_select(dim, i0)
            + w1.reshape(shape) * x.index_select(dim, i1))


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                    round_uint8: bool = True) -> torch.Tensor:
    """Resize (..., H, W, C) image(s) to (..., out_h, out_w, C), float32.

    With ``round_uint8=True`` values are rounded half-up to integers, matching
    cv2's fixed-point INTER_LINEAR on uint8 inputs.
    """
    x = img.to(torch.float32)
    if x.shape[-3] != out_h:
        x = _resample(x, x.dim() - 3, out_h)
    if x.shape[-2] != out_w:
        x = _resample(x, x.dim() - 2, out_w)
    if round_uint8:
        x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)
    return x


@functools.lru_cache(maxsize=None)
def nearest_resize_indices(n_in: int, n_out: int) -> np.ndarray:
    """Source index per output index of torchvision's NEAREST resize:
    floor(dst * n_in / n_out), clipped to the input."""
    dst = np.arange(n_out, dtype=np.float64)
    src = np.floor(dst * (n_in / n_out)).astype(np.int64)
    return np.clip(src, 0, n_in - 1)


def resize_nearest(mask: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Nearest-neighbour resize of an (H, W) array on the host (numpy)."""
    ri = nearest_resize_indices(mask.shape[0], out_h)
    ci = nearest_resize_indices(mask.shape[1], out_w)
    return mask[np.ix_(ri, ci)]
