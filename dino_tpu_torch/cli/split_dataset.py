#!/usr/bin/env python
"""Carve a VOC-style dataset directory into train/test/val datasets.

    python -m dino_tpu_torch.cli.split_dataset ROOT [--n_test 20]
        [--n_val 10] [--seed 42]

The port of ``dino_tpu``'s ``cli/split_dataset.py``: ``ROOT_train``,
``ROOT_test`` and ``ROOT_val`` beside ``ROOT``, each with the four artifact
folders and ``class_names.txt``; images are assigned by numpy's legacy
global shuffle of the JPEG listing with ``seed`` (the first ``n_test`` to
test, the next ``n_val`` to val, the rest to train), so the same listing
and seed give the same splits.  A missing per-image artifact is skipped.
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil
from typing import Dict, List

import numpy as np

# artifact subdirectory -> file extension for each image stem
_ARTIFACTS = {
    "JPEGImages": ".jpg",
    "SegmentationClass": ".npy",
    "SegmentationClassPNG": ".png",
    "SegmentationClassVisualization": ".jpg",
}
_SPLIT_SUFFIXES = ("_train", "_test", "_val")


def plan_splits(root: str, n_test: int, n_val: int,
                seed: int) -> Dict[str, List[str]]:
    """{suffix: [image stems]}: ``np.random.seed(seed)`` then
    ``np.random.shuffle`` of the raw ``glob`` listing."""
    jpgs = glob.glob(os.path.join(root, "JPEGImages", "*.jpg"))
    np.random.seed(seed)
    np.random.shuffle(jpgs)
    stems = [os.path.splitext(os.path.basename(p))[0] for p in jpgs]
    return {
        "_test": stems[:n_test],
        "_val": stems[n_test:n_test + n_val],
        "_train": stems[n_test + n_val:],
    }


def materialize(root: str, plan: Dict[str, List[str]]) -> None:
    """Create the split directories and copy the assigned artifacts."""
    labels_src = os.path.join(root, "class_names.txt")
    for suffix in _SPLIT_SUFFIXES:
        dst_root = root + suffix
        for sub in _ARTIFACTS:
            os.makedirs(os.path.join(dst_root, sub))
        shutil.copy(labels_src, os.path.join(dst_root, "class_names.txt"))
        for stem in plan[suffix]:
            for sub, ext in _ARTIFACTS.items():
                src = os.path.join(root, sub, stem + ext)
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(dst_root, sub, stem + ext))


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Carve a VOC-style dataset directory into train/test/val "
                    "datasets.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("input_dir", help="input voc style dataset")
    ap.add_argument("--n_test", type=int, default=20,
                    help="Number of images in test set")
    ap.add_argument("--n_val", type=int, default=10,
                    help="Number of images in val set")
    ap.add_argument("--seed", type=int, default=42,
                    help="shuffle seed (42 reproduces the reference splits)")
    args = ap.parse_args()

    root = args.input_dir.rstrip(os.sep)
    plan = plan_splits(root, args.n_test, args.n_val, args.seed)
    materialize(root, plan)
    for suffix in _SPLIT_SUFFIXES:
        print(f"{root}{suffix}: {len(plan[suffix])} images")


if __name__ == "__main__":
    main()
