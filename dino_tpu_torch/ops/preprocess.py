"""Device-side preprocessing: resize -> ImageNet-normalize.

The uint8 frame goes to the device once; the cv2-compatible bilinear resize,
/255 and the ImageNet mean/std run there, ahead of the ViT forward.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from dino_tpu_torch.ops.resize import resize_bilinear

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# (mean, std) * 255 per device, copied there once: a copy from pageable
# host memory on every call costs host time and cannot be captured in a
# CUDA graph
_DEVICE_MEAN_STD: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _mean_std(device: torch.device):
    if device not in _DEVICE_MEAN_STD:
        _DEVICE_MEAN_STD[device] = (
            torch.from_numpy(IMAGENET_MEAN * 255.0).to(device),
            torch.from_numpy(IMAGENET_STD * 255.0).to(device))
    return _DEVICE_MEAN_STD[device]


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) float pixel values in [0, 255] -> ImageNet-normalized floats."""
    mean, std = _mean_std(x.device)
    return (x.to(torch.float32) - mean) / std


def preprocess(img: torch.Tensor, resolution: int) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> normalized float32 (..., res, res, 3).

    cv2 INTER_LINEAR resize on uint8 (rounded back to integers) followed by
    albumentations Normalize.
    """
    x = resize_bilinear(img, resolution, resolution, round_uint8=True)
    return normalize_imagenet(x)
