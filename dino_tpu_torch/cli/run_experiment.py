#!/usr/bin/env python
"""Fit the DINO segmentation model on Duckietown data (CLI).

    python -m dino_tpu_torch.cli.run_experiment -d data -w results [--cpu]

The port's ``dino_tpu/cli/run_experiment.py``: frozen-head training,
optional sim pretraining, and an optional finetune phase that reloads the
best checkpoint, unfreezes the backbone and fits again under a new name.
Runs on the card unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from dino_tpu_torch.api import DINOSeg
from dino_tpu_torch.utils.labels import parse_class_names
from dino_tpu_torch.utils.logging import make_logger


def run_experiment(data_path, write_path, batch_size, epochs, learning_rate,
                   n_blocks, finetune, unfreeze=False, random_init=False,
                   augmentations=False, pretrain_on_sim=False,
                   ck_file_name=None, comet_tag=None, random_state=42,
                   patience=10, backbone="vit", optimizer="adam",
                   precision="bf16", train_resolution=480, accum_steps=1,
                   zero=False, early_stopping=False, augment_backend="auto",
                   cpu=False):
    """Fit a coarse segmentation model (one prediction per 8x8 patch); with
    ``finetune``, refit the best checkpoint with the backbone unfrozen."""
    np.random.seed(random_state)
    logger = make_logger(comet_tag, write_path, params={
        "random_state": random_state})
    class_names, _ = parse_class_names(os.path.join(data_path, "labels.txt"))
    device = "cpu" if cpu else None
    dino_seg = DINOSeg(
        head="mlp", data_path=data_path, pretrain_on_sim=pretrain_on_sim,
        write_path=write_path, n_classes=len(class_names),
        class_names=class_names, freeze_backbone=not unfreeze,
        optimizer=optimizer, lr=learning_rate, batch_size=batch_size,
        n_blocks=n_blocks, max_epochs=epochs, patience=patience,
        logger=logger, augmented=augmentations, random_init=random_init,
        backbone=backbone, seed=random_state, precision=precision,
        train_resolution=train_resolution, device=device)
    if ck_file_name is None:
        ck_file_name = f"{n_blocks}_{backbone}_mlp_{random_state}"
    dino_seg.fit(ck_file_name, accum_steps=accum_steps, zero=zero,
                 early_stopping=early_stopping,
                 augment_backend=augment_backend)
    if finetune:
        print("\n Finetuning the previous model...")
        ft = DINOSeg.load_from_checkpoint(dino_seg.best_ck, device=device)
        ft.unfreeze_bb()
        ft.optimizer = optimizer
        ft.logger = make_logger(comet_tag, write_path,
                                params={"is_finetuned": True})
        ft.data_path = data_path
        ft.write_path = write_path
        ft.fit(ck_file_name + "_finetuned", accum_steps=accum_steps,
               zero=zero, early_stopping=early_stopping,
               augment_backend=augment_backend)
        return ft
    return dino_seg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--data_path", "-d", default="data", help="Data folder")
    p.add_argument("--write_path", "-w", default="results",
                   help="Where to write results")
    p.add_argument("--batch_size", "-b", default=1, type=int,
                   help="Batch size. Number of 480p images. "
                        "1 image = 3,600 image patches.")
    p.add_argument("--epochs", "-e", default=200, type=int,
                   help="Max number of training epochs")
    p.add_argument("--learning_rate", "-lr", default=1e-3, type=float)
    p.add_argument("--optimizer", "-op", default="adam", type=str)
    p.add_argument("--patience", "-p", default=200, type=int,
                   help="Epochs without val_acc improvement before "
                        "--early_stopping stops the fit.")
    p.add_argument("--backbone", "-ba", default="vit", type=str,
                   help="Backbone architecture.")
    p.add_argument("--n_blocks", default=1, type=int,
                   help="Number of DINO blocks to use")
    p.add_argument("--pretrain_on_sim", action="store_true",
                   help="Pretrain on simulation data.")
    p.add_argument("--finetune", action="store_true",
                   help="Finetune the backbone after an initial frozen phase")
    p.add_argument("--unfreeze", action="store_true",
                   help="Unfreeze the backbone during training.")
    p.add_argument("--random_init", action="store_true",
                   help="Random init instead of pretrained DINO weights.")
    p.add_argument("--augmentations", action="store_true",
                   help="Augment data during training.")
    p.add_argument("--comet_tag", default=None, type=str,
                   help="Experiment tag for the metrics logger.")
    p.add_argument("--random_state", default=42, type=int, help="Random seed")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--accum_steps", default=1, type=int,
                   help="microbatches per step (exact gradient accumulation)")
    p.add_argument("--augment_backend", default="auto",
                   choices=["auto", "native", "cv2", "device"],
                   help="where augmentation pixels are computed: 'auto' = "
                        "the native C++ loader when it builds, else the "
                        "numpy recipe ('cv2'); 'device' = crop, flip, "
                        "jitter and blur on the model's device")
    p.add_argument("--early_stopping", action="store_true",
                   help="stop after `patience` epochs without val_acc "
                        "improvement")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1: shard the optimizer's moments over the "
                        "ranks when data parallelism engages")
    p.add_argument("--train_resolution", default=480, type=int)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    run_experiment(**vars(args))


if __name__ == "__main__":
    main()
