"""Torch-compatible bicubic interpolation as separable weight matrices.

The DINO ViT resamples its positional embeddings with
``F.interpolate(mode='bicubic', align_corners=False)`` given a scale factor.
The 1-D cubic-convolution weights are computed on the host (numpy, float64)
and applied as two small matmuls, ``out = W_rows @ grid @ W_cols.T``.

Semantics of ATen's ``upsample_bicubic2d``:
  * output size  = floor(n_in * scale)
  * src coord    = (dst + 0.5) / scale - 0.5  (align_corners=False, the scale
                   is given explicitly, so it is not recomputed from sizes)
  * 4-tap cubic convolution kernel with A = -0.75
  * border taps clamp to the valid index range (replicate padding)
"""
from __future__ import annotations

import functools
import math

import numpy as np

_A = -0.75  # cubic convolution coefficient used by torch (and OpenCV)


def _cubic_tap_weights(t: np.ndarray) -> np.ndarray:
    """4 cubic-convolution tap weights for fractional offsets ``t`` in [0, 1)."""
    a = _A
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    w2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=-1)


@functools.lru_cache(maxsize=None)
def bicubic_resize_matrix(n_in: int, scale: float) -> np.ndarray:
    """Dense (n_out, n_in) float32 matrix applying torch-bicubic along one axis.

    ``y = W @ x`` reproduces ``F.interpolate(x, scale_factor=scale,
    mode='bicubic', align_corners=False)`` along that axis, where
    ``n_out = floor(n_in * scale)``.
    """
    n_out = int(math.floor(n_in * scale))
    if n_out <= 0:
        raise ValueError(f"scale {scale} gives empty output for n_in={n_in}")
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) / scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    taps = _cubic_tap_weights(src - i0)  # (n_out, 4)
    w = np.zeros((n_out, n_in), dtype=np.float64)
    rows = np.arange(n_out)
    for k in range(4):
        np.add.at(w, (rows, np.clip(i0 - 1 + k, 0, n_in - 1)), taps[:, k])
    return w.astype(np.float32)
