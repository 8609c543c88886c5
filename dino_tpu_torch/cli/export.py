"""Export a fixed-shape predict artifact of the port from a checkpoint.

The counterpart of ``dino_tpu/cli/export.py`` (dt-export): load a
checkpoint (``.npz`` or a reference PL ``.ckpt``), bind resolution, batch and
input shape, and write the predict program's artifact (``.dtts``: the
model's configuration and serving-form weights; ``dino_tpu_torch/serving.py``)
and its ``.json`` contract.  Loading it needs this package but no
checkpoint:

    python -m dino_tpu_torch.cli.export results/3_mlp_finetuned.ckpt.npz \\
        predict.dtts --resolution 480 --batch-size 3 --in-height 480 \\
        --in-width 640

The checkpoint loads on the card; ``--cpu`` exports without one.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint", help=".npz or torch PL .ckpt")
    p.add_argument("output", help="artifact path (sidecar: <output>.json)")
    p.add_argument("--resolution", type=int, default=480,
                   help="inference resolution (multiple of 8)")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--in-height", type=int, default=480)
    p.add_argument("--in-width", type=int, default=640)
    p.add_argument("--precision", default=None,
                   choices=["bf16", "fp32", "int8"],
                   help="override the checkpoint's serving precision (int8 "
                        "is not ported, ROADMAP item 8)")
    p.add_argument("--n-devices", type=int, default=None,
                   help="more than one card is not ported (ROADMAP item 11)")
    p.add_argument("--parallelism", default=None, choices=["sp"],
                   help="'sp' is not ported (ROADMAP item 11)")
    p.add_argument("--cpu", action="store_true",
                   help="load the checkpoint on the CPU (default: the card)")
    args = p.parse_args(argv)

    from dino_tpu_torch import DINOSeg, export_predict
    model = DINOSeg.load_from_checkpoint(args.checkpoint,
                                         device="cpu" if args.cpu else None)
    model.set_resolution(args.resolution)
    path = export_predict(model, args.output, batch_size=args.batch_size,
                          in_shape=(args.in_height, args.in_width),
                          precision=args.precision,
                          n_devices=args.n_devices,
                          parallelism=args.parallelism)
    with open(path + ".json") as fh:
        contract = json.load(fh)
    print(json.dumps({"artifact": path, **contract}))


if __name__ == "__main__":
    main()
