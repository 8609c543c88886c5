"""The port's unfrozen bf16 fit on the card with each augmentation backend
and loader pool size, in turns.

The bench config (ViT-S/8 cut to 3 blocks, MLP head, 7 classes, random
weights from a seed) fits chip_smoke.py's in-memory 480x640 split at
480px, batch 16, 8 microbatches, 64 samples an epoch, once with
``augment_backend='device'`` and once with the host rung (the numpy
recipe: the split is in memory), for each pool size of the loader's
threads, over two rounds.  One JSON line per fit: the card, then per
epoch the train frames/s, the loader wait and the host core share.

    PYTHONPATH=. python3 examples/torch_fit_augment_backends.py \
        [--workers 8 4 2] [--rounds 2] [--epochs 3]
"""
import argparse
import functools
import json
import tempfile

import chip_smoke as cs
from dino_tpu_torch import api
from dino_tpu_torch.data import dataset


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, nargs="+", default=[8, 4, 2])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args()
    splits = {name: cs.memory_split(n, seed) for seed, (name, n) in
              enumerate(cs.FIT_FRAMES.items())}
    print(json.dumps({"card": cs.bench.card_name_and_power_limit()}),
          flush=True)
    for rnd in range(args.rounds):
        for workers in args.workers:
            # fit builds its loader through api.batched_loader
            api.batched_loader = functools.partial(dataset.batched_loader,
                                                   num_workers=workers)
            for backend in ("device", "auto"):
                with tempfile.TemporaryDirectory() as tmp:
                    model = cs.fit_model(
                        splits, tmp, precision="bf16", freeze_backbone=False,
                        batch_size=cs.FIT_BATCH, lr=cs.FIT_LR,
                        augmented=True, train_resolution=cs.FIT_RES,
                        max_epochs=args.epochs)
                    model.fit(samples_per_epoch=cs.FIT_SAMPLES,
                              accum_steps=cs.FIT_ACCUM,
                              augment_backend=backend)
                stats = cs.pipeline_stats(model)
                print(json.dumps({
                    "round": rnd, "workers": workers, "backend": backend,
                    "train_frames_per_s": [e["train_frames_per_s"]
                                           for e in stats],
                    "loader_wait_s": [e["loader_wait_s"] for e in stats],
                    "host_core_share": [e["host_core_share"]
                                        for e in stats]}), flush=True)
    api.batched_loader = dataset.batched_loader


if __name__ == "__main__":
    main()
