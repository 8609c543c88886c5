#!/usr/bin/env python
"""Run inference on a folder of images and save label overlays.

    python -m dino_tpu_torch.cli.visualize CHECKPOINT IMAGE_DIR TARGET_DIR \
        [--labels_path data/labels.txt] [--resolution 480] [--cpu]

Loads a checkpoint, sets the inference resolution, predicts every jpg/png
and saves its label map blended over the grayscale frame.  ``overlay``
computes the written array; Pillow is needed for the file I/O only.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from dino_tpu_torch.api import DINOSeg
from dino_tpu_torch.utils.labels import parse_class_names
from dino_tpu_torch.utils.viz import label2rgb, rgb2gray


def overlay(model: DINOSeg, image: np.ndarray, base_rgb: np.ndarray,
            class_names=None) -> np.ndarray:
    """(480, 480, 3) uint8: the model's label map for ``image`` (H, W, 3)
    blended over the grayscale of ``base_rgb`` (480, 480, 3)."""
    pred = model.predict(image)
    return label2rgb(pred, rgb2gray(base_rgb), class_names=class_names)


def inference(checkpoint_path, image_dir, target_dir, labels_path,
              resolution=480, cpu=False):
    """Use a trained checkpoint to run inference on all images in
    image_dir; the output map is 480x480 whatever the resolution."""
    from PIL import Image

    model = DINOSeg.load_from_checkpoint(checkpoint_path,
                                         device="cpu" if cpu else None)
    model.set_resolution(resolution)
    os.makedirs(target_dir, exist_ok=True)
    class_names, _ = parse_class_names(labels_path)

    for ext in ["jpg", "png"]:
        for filename in sorted(glob.glob(os.path.join(image_dir, f"*.{ext}"))):
            with open(filename, "rb") as f:
                x = Image.open(f).convert("RGB")
            viz = overlay(model, np.asarray(x), np.array(x.resize((480, 480))),
                          class_names)
            out = os.path.join(target_dir, os.path.basename(filename))
            Image.fromarray(viz).save(out)
            print(f"{out} saved.")


def main():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("checkpoint_path", help="Trained checkpoint")
    parser.add_argument("image_dir", help="Images to run inference on")
    parser.add_argument("target_dir", help="Where to save predictions")
    parser.add_argument("--labels_path", default=os.path.join("data",
                                                              "labels.txt"))
    parser.add_argument("--resolution", default=480, type=int)
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU instead of the card.")
    args = parser.parse_args()
    inference(**vars(args))


if __name__ == "__main__":
    main()
