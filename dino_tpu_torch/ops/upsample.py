"""Label-map upsampling (the reference's ``np.kron`` with a ones block).

The reference always returns a 480x480 label map whatever the inference
resolution; the blow-up runs on the device so predict makes one small
device-to-host transfer: one broadcast view and one copy.
"""
from __future__ import annotations

import torch


def kron_upsample(low_res: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., H, W) -> (..., H*factor, W*factor) by block replication."""
    *lead, h, w = low_res.shape
    x = low_res[..., :, None, :, None].expand(*lead, h, factor, w, factor)
    return x.reshape(*lead, h * factor, w * factor)
