"""Visualization helpers: the PASCAL-VOC colormap, label overlays on a
grayscale base, and palette-mode PNG masks.  Pillow is imported by
``save_label_png`` alone."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def voc_colormap(n: int = 256) -> np.ndarray:
    """Standard PASCAL-VOC label colormap (bit-interleave construction)."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        c, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def rgb2gray(img: np.ndarray) -> np.ndarray:
    g = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    return g.astype(np.uint8)


def label2rgb(label: np.ndarray, base_img: Optional[np.ndarray] = None,
              alpha: float = 0.5,
              class_names: Optional[Sequence[str]] = None) -> np.ndarray:
    """Colorize an int label map, optionally alpha-blended over a gray
    base."""
    cmap = voc_colormap()
    colored = cmap[np.clip(label, 0, 255)]
    if base_img is None:
        return colored
    if base_img.ndim == 2:
        base_img = np.repeat(base_img[..., None], 3, axis=-1)
    out = (alpha * colored.astype(np.float32)
           + (1 - alpha) * base_img.astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)


def save_label_png(path: str, label: np.ndarray) -> None:
    """Save an int mask as a palette-mode PNG."""
    from PIL import Image

    if label.min() < -1 or label.max() > 255:
        raise ValueError("label values out of uint8 PNG range")
    img = Image.fromarray(label.astype(np.uint8), mode="P")
    img.putpalette(voc_colormap().flatten().tolist())
    img.save(path)
