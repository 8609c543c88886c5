"""Label-map upsampling (the reference's ``np.kron`` with a ones block).

The reference always returns a 480x480 label map whatever the inference
resolution; the blow-up runs on the device so predict makes one small
device-to-host transfer.
"""
from __future__ import annotations

import torch


def kron_upsample(low_res: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., H, W) -> (..., H*factor, W*factor) by block replication."""
    x = torch.repeat_interleave(low_res, factor, dim=-2)
    return torch.repeat_interleave(x, factor, dim=-1)
