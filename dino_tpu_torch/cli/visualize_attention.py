#!/usr/bin/env python
"""Save per-head CLS attention maps for one image.

    python -m dino_tpu_torch.cli.visualize_attention CHECKPOINT IMAGE \
        TARGET_DIR [--resolution 480] [--cpu]

Loads a checkpoint, takes the last block's CLS attention row per head in
O(N) memory (``get_last_selfattention(cls_only=True)``, so 960px works),
reshapes it to the patch grid, nearest-upsamples it to the resolution and
saves one PNG per head and the resized input image.  ``attention_maps``
computes the written arrays; Pillow and matplotlib are needed for the file
I/O only.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from dino_tpu_torch.api import DINOSeg
from dino_tpu_torch.ops.resize import resize_nearest


def attention_maps(model: DINOSeg, img: np.ndarray,
                   patch_size: int = 8) -> np.ndarray:
    """(nh, res, res) float32: each head's CLS attention over the patches
    of ``img`` (H, W, 3) uint8 at the model's resolution, nearest-upsampled
    from the patch grid."""
    res = model.resolution
    attn = model.get_last_selfattention(img[None], cls_only=True)
    nh, grid = attn.shape[1], res // patch_size
    cls_attn = attn[0, :, 0, 1:].reshape(nh, grid, grid)
    return np.stack([resize_nearest(cls_attn[j], res, res)
                     for j in range(nh)])


def vis_mask(checkpoint_path, filename, target_dir, resolution=480,
             cpu=False):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    model = DINOSeg.load_from_checkpoint(checkpoint_path,
                                         device="cpu" if cpu else None)
    model.set_resolution(resolution)
    os.makedirs(target_dir, exist_ok=True)
    with open(filename, "rb") as f:
        img = np.array(Image.open(f).convert("RGB"))

    x = np.array(Image.fromarray(img).resize((resolution, resolution)))
    plt.imsave(os.path.join(target_dir, "img.png"), x)
    for j, up in enumerate(attention_maps(model, img)):
        fname = os.path.join(target_dir, f"attn-head-dino{j}.png")
        plt.imsave(fname=fname, arr=up, format="png")
        print(f"{fname} saved.")


def main():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("checkpoint_path", help="Trained checkpoint")
    parser.add_argument("filename", help="Image to compute attention on")
    parser.add_argument("target_dir", help="Where to save attentions")
    parser.add_argument("--resolution", default=480, type=int)
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU instead of the card.")
    args = parser.parse_args()
    vis_mask(**vars(args))


if __name__ == "__main__":
    main()
