#!/usr/bin/env python
"""Convert Duckietown-simulator renderings to a VOC-style segmentation
dataset.

    python -m dino_tpu_torch.cli.sim2voc INPUT_DIR OUTPUT_DIR --labels FILE

The port of ``dino_tpu``'s ``cli/sim2voc.py``, with the same outputs byte
for byte and no cv2: the HSV conversion is ``data/augment.py``'s
``rgb_to_hsv_u8`` (cv2's uint8 integer path) and ``cv2.inRange`` a numpy
box test.  Class extraction combines exact RGB matches on the simulator's
object renderings with HSV ranges over the raw frame for the lanes and
the red tape, multi-colour unions for duckiebot, sign and duck, and a last
pass that zeroes the classes absent from the labels file.  Input layout:

    INPUT_DIR/images/*.png   raw frames
    INPUT_DIR/labels/*.png   simulator object renderings
"""
from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import sys

import numpy as np

from dino_tpu_torch.data.augment import rgb_to_hsv_u8
from dino_tpu_torch.utils.viz import label2rgb, rgb2gray, save_label_png

# (class name, class id, simulator rendering RGB hex)
CLASS_MAP = [
    ("_background_", 0, "000000"),
    ("yellow-lane", 1, "ffff00"),
    ("white-lane", 2, "ffffff"),
    ("duckiebot", 3, "ad0000"),
    ("sign", 4, "4a4342"),
    ("duck", 5, "cfa923"),
    ("red-tape", 6, "fe0000"),
    ("cone", 7, "ffa600"),
    ("house", 8, "279621"),
    ("bus", 9, "ebd334"),
    ("truck", 10, "961fad"),
    ("barrier", 11, "000099"),
]

# inclusive (H, S, V) boxes over the raw frame, H in [0, 180)
HSV_RANGES = {
    "yellow-lane": ((25, 60, 150), (30, 255, 255)),
    "red-tape": ((175, 120, 0), (180, 255, 255)),
    "white-lane": ((0, 0, 145), (180, 40, 255)),
}


def _rgb(hexcode: str):
    return [int(hexcode[i:i + 2], 16) for i in (0, 2, 4)]


def in_range(hsv: np.ndarray, lower, upper) -> np.ndarray:
    """cv2.inRange as a boolean mask: every channel within [lower,
    upper]."""
    return ((hsv >= np.asarray(lower)) & (hsv <= np.asarray(upper))).all(-1)


def rgb_to_c(mask_img, raw_img, current_classes) -> np.ndarray:
    """Class ids from the rendering and the raw frame's pixels."""
    mask_img = np.array(mask_img)
    raw_img = np.array(raw_img)
    raw_hsv = np.stack(rgb_to_hsv_u8(raw_img), axis=-1)

    result = np.zeros(mask_img.shape[:-1], dtype="int")
    for name, _, hexcode in CLASS_MAP[1:]:
        if name not in current_classes:
            continue
        color = _rgb(hexcode)
        if name == "duckiebot":
            # wheels and camera render in another colour; pure-black raw
            # pixels are the backplate
            mask = (mask_img == color) + (mask_img == [30, 12, 5])
            mask += raw_img == [0, 0, 0]
            mask = mask.all(axis=-1)
        elif name in HSV_RANGES:
            mask = in_range(raw_hsv, *HSV_RANGES[name])
        elif name == "sign":
            mask = ((mask_img == color) + (mask_img == [52, 53, 8])
                    + (mask_img == [76, 71, 71]))
            mask = mask.all(axis=-1)
        elif name == "duck":
            # duckie passengers render in a second colour
            mask = (mask_img == color) + (mask_img == [132, 108, 22])
            mask = mask.all(axis=-1)
        else:
            mask = (mask_img == color).all(axis=-1)
        result[mask] = current_classes.index(name)

    # classes not in the labels file map to background, after the positive
    # passes, since the HSV ranges above can cover e.g. buses
    for name, _, hexcode in CLASS_MAP[1:]:
        if name not in current_classes:
            mask = (mask_img == _rgb(hexcode)).all(axis=-1)
            result[mask] = 0
    return result


def main():
    from PIL import Image

    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("input_dir", help="input sim data")
    parser.add_argument("output_dir", help="output dataset directory")
    parser.add_argument("--labels", help="labels file", required=True)
    parser.add_argument("--noviz", help="no visualization",
                        action="store_true")
    args = parser.parse_args()

    if osp.exists(args.output_dir):
        print("Output directory already exists:", args.output_dir)
        sys.exit(1)
    for sub in ["JPEGImages", "SegmentationClass", "SegmentationClassPNG"]:
        os.makedirs(osp.join(args.output_dir, sub))
    if not args.noviz:
        os.makedirs(osp.join(args.output_dir,
                             "SegmentationClassVisualization"))
    print("Creating dataset:", args.output_dir)

    class_names = []
    with open(args.labels) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        class_id = i - 1
        class_name = line.strip()
        if class_id == -1:
            assert class_name == "__ignore__"
            continue
        elif class_id == 0:
            assert class_name == "_background_"
        class_names.append(class_name)
    class_names = tuple(class_names)
    print("class_names:", class_names)
    with open(osp.join(args.output_dir, "class_names.txt"), "w") as f:
        f.writelines("\n".join(class_names))

    for filename in sorted(glob.glob(osp.join(args.input_dir, "images",
                                              "*.png"))):
        print("Generating dataset from:", filename)
        base = osp.splitext(osp.basename(filename))[0]
        rgb_im = Image.open(filename).convert("RGB")
        rgb_im.save(osp.join(args.output_dir, "JPEGImages", base + ".jpg"))

        sim_mask = Image.open(osp.join(args.input_dir, "labels",
                                       osp.basename(filename))).convert("RGB")
        lbl = rgb_to_c(sim_mask, rgb_im, class_names)

        save_label_png(
            osp.join(args.output_dir, "SegmentationClassPNG", base + ".png"),
            lbl)
        np.save(osp.join(args.output_dir, "SegmentationClass",
                         base + ".npy"), lbl)
        if not args.noviz:
            viz = label2rgb(lbl, rgb2gray(np.array(rgb_im)),
                            class_names=class_names)
            Image.fromarray(viz).save(
                osp.join(args.output_dir, "SegmentationClassVisualization",
                         base + ".jpg"))


if __name__ == "__main__":
    main()
