#!/usr/bin/env python
"""Convert labelme-annotated real images to a VOC-style segmentation
dataset.

    python -m dino_tpu_torch.cli.labelme2voc INPUT_DIR OUTPUT_DIR --labels FILE

The port of ``dino_tpu``'s ``cli/labelme2voc.py`` (the same outputs byte
for byte), over the port's own annotation reader and rasterizer
(``data/labelme_io.py``).
"""
from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import sys

import numpy as np

from dino_tpu_torch.data.labelme_io import (LabelFile, img_data_to_arr,
                                            shapes_to_label)
from dino_tpu_torch.utils.labels import parse_class_names
from dino_tpu_torch.utils.viz import label2rgb, rgb2gray, save_label_png


def main():
    from PIL import Image

    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("input_dir", help="input annotated directory")
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

    class_names, class_name_to_id = parse_class_names(args.labels)
    print("class_names:", class_names)
    with open(osp.join(args.output_dir, "class_names.txt"), "w") as f:
        f.writelines("\n".join(class_names))

    for filename in sorted(glob.glob(osp.join(args.input_dir, "*.json"))):
        print("Generating dataset from:", filename)
        label_file = LabelFile(filename)
        base = osp.splitext(osp.basename(filename))[0]

        with open(osp.join(args.output_dir, "JPEGImages", base + ".jpg"),
                  "wb") as f:
            f.write(label_file.imageData)
        img = img_data_to_arr(label_file.imageData)

        lbl = shapes_to_label(img_shape=img.shape, shapes=label_file.shapes,
                              label_name_to_value=class_name_to_id)
        save_label_png(
            osp.join(args.output_dir, "SegmentationClassPNG", base + ".png"),
            lbl)
        np.save(osp.join(args.output_dir, "SegmentationClass",
                         base + ".npy"), lbl)
        if not args.noviz:
            viz = label2rgb(lbl, rgb2gray(img), class_names=class_names)
            Image.fromarray(viz).save(
                osp.join(args.output_dir, "SegmentationClassVisualization",
                         base + ".jpg"))


if __name__ == "__main__":
    main()
