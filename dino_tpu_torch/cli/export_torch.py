"""Export a checkpoint of the port as a reference PyTorch-Lightning .ckpt.

The counterpart of ``dino_tpu/cli/export_torch.py`` (dt-export-torch), over
``DINOSeg.save_torch_checkpoint``: the reference's
``DINOSeg.load_from_checkpoint(path)`` restores the file unchanged.

    python -m dino_tpu_torch.cli.export_torch \\
        results/3_mlp_finetuned.ckpt.npz results/3_mlp.ckpt

The checkpoint loads on the card; ``--cpu`` exports without one.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint", help="native .npz (or a torch .ckpt to "
                                      "round-trip/normalize)")
    p.add_argument("output", help="output .ckpt path")
    p.add_argument("--epoch", type=int, default=0,
                   help="epoch to record in the checkpoint header")
    p.add_argument("--global-step", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="load the checkpoint on the CPU (default: the card)")
    args = p.parse_args(argv)

    from dino_tpu_torch import DINOSeg
    model = DINOSeg.load_from_checkpoint(args.checkpoint,
                                         device="cpu" if args.cpu else None)
    model.save_torch_checkpoint(args.output, epoch=args.epoch,
                                global_step=args.global_step)
    print(json.dumps({
        "output": args.output,
        "backbone": model.backbone,
        "head": model.head,
        "n_blocks": model.n_blocks,
        "n_classes": model.n_classes,
    }))


if __name__ == "__main__":
    main()
