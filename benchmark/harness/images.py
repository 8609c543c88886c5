"""Seeded camera-like images, made on the device.

An image is a coarse random colour field (one value a 32-pixel cell,
bilinearly smoothed) plus per-pixel noise, clipped to uint8: distinct
frames with edges and texture, so attention and the head see varied
patches.  Every image of a batch is drawn from one generator in a few
calls; the same generator state gives the same bytes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def make_images(gen: torch.Generator, n: int, h: int, w: int,
                device, chunk: int = 32) -> torch.Tensor:
    """uint8 (n, h, w, 3) on ``device``."""
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        coarse = torch.rand((m, 3, h // 32 + 2, w // 32 + 2), generator=gen,
                            device=device) * 255.0
        x = F.interpolate(coarse, size=(h, w), mode="bilinear",
                          align_corners=False)
        x += torch.randn((m, 3, h, w), generator=gen, device=device) * 16.0
        out[s:s + m] = x.clamp_(0, 255).round_().to(torch.uint8).permute(
            0, 2, 3, 1)
    return out
