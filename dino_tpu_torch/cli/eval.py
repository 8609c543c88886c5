"""Segmentation metrics of a checkpoint on one VOC-style split (CLI).

    python -m dino_tpu_torch.cli.eval results/3_mlp_finetuned.ckpt.npz \
        data/dt_real_voc_test --resolution 480 --per-class [--cpu]

Balanced accuracy, macro F1 and macro IoU from a confusion matrix kept on
the device, over ``JPEGImages/`` + ``SegmentationClass/*.npy``; prints one
JSON line.  Runs on the card unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint", help="native .npz or torch PL .ckpt")
    p.add_argument("data_dir", help="VOC-style split dir (JPEGImages/ + "
                                    "SegmentationClass/*.npy)")
    p.add_argument("--resolution", type=int, default=None,
                   help="eval resolution (multiple of 8; default: the "
                        "checkpoint's train_resolution)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--prefix", default="test",
                   help="metric-name prefix in the output JSON")
    p.add_argument("--per-class", action="store_true",
                   help="include per-class recall/precision/F1/IoU rows")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the metrics JSON to this path")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    from dino_tpu_torch import DINOSeg
    model = DINOSeg.load_from_checkpoint(
        args.checkpoint, device="cpu" if args.cpu else None)
    metrics = model.evaluate(args.data_dir, resolution=args.resolution,
                             batch_size=args.batch_size, prefix=args.prefix,
                             per_class=args.per_class)
    line = json.dumps(metrics, sort_keys=True)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
