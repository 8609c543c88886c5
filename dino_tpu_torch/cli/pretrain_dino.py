#!/usr/bin/env python
"""Self-supervised DINO pretraining on the card: the port of
``dino_tpu/cli/pretrain_dino.py``.

Pretrains a ViT backbone on a folder of unlabeled images with the
student/teacher multi-crop recipe, then saves the teacher's backbone as a
converted ``.npz`` that ``DINOSeg(pretrained_path=...)`` loads (either
package).

    python -m dino_tpu_torch.cli.pretrain_dino --data_path images/ \\
        --write_path out/ --epochs 10 --batch_size 16

Runs on the card unless ``--device cpu`` is given, in one process: a
``torch.distributed`` world of more than one process and ``--fsdp`` raise
``NotImplementedError`` (ROADMAP item 11).  The recipe is ``dino_tpu``'s:
AdamW with weight decay on the matrices only, the lr / weight-decay /
teacher-momentum / teacher-temperature schedules set every step, crops
keyed by (seed, epoch, image index) and a shuffle keyed by (seed, epoch),
so ``--resume`` continues a stopped run step for step.
"""
from __future__ import annotations

import argparse
import glob
import os
import signal
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--data_path", required=True,
                    help="folder of .jpg/.png images (recursively)")
    ap.add_argument("--write_path", default="./dino_pretrain")
    ap.add_argument("--arch", default="vit_small",
                    choices=["vit_tiny", "vit_small", "vit_base"])
    ap.add_argument("--patch_size", type=int, default=8)
    ap.add_argument("--depth", type=int, default=None,
                    help="override the block count (small runs)")
    ap.add_argument("--out_dim", type=int, default=65536)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--warmup_epochs", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--accum_steps", type=int, default=1,
                    help="split each batch into this many microbatches "
                         "inside the step (one optimizer update on the mean "
                         "gradient): activation memory scales with "
                         "batch_size/accum_steps")
    ap.add_argument("--fsdp", action="store_true",
                    help="FSDP/ZeRO-3 of the pretrain state: not ported "
                         "(ROADMAP item 11); raises")
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--n_local_crops", type=int, default=8)
    ap.add_argument("--global_size", type=int, default=224)
    ap.add_argument("--local_size", type=int, default=96)
    ap.add_argument("--teacher_temp", type=float, default=0.04)
    ap.add_argument("--warmup_teacher_temp_epochs", type=int, default=0)
    ap.add_argument("--momentum_teacher", type=float, default=0.996)
    ap.add_argument("--freeze_last_layer", type=int, default=1,
                    help="epochs with the last layer's gradient cancelled")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="continue a stopped run from the checkpoint in "
                         "write_path (epoch- or step-granular)")
    ap.add_argument("--stop_after", type=int, default=None,
                    help="checkpoint and exit after this epoch index "
                         "(schedules still span --epochs)")
    ap.add_argument("--save_every_steps", type=int, default=0,
                    help="also checkpoint every N optimizer steps "
                         "(asynchronously), so a stopped epoch resumes "
                         "mid-epoch; 0 = epoch-end saves only")
    ap.add_argument("--stop_after_steps", type=int, default=None,
                    help="stop gracefully after this many optimizer steps "
                         "of this invocation (the path a SIGTERM takes)")
    ap.add_argument("--nan_guard", action="store_true",
                    help="on a non-finite loss, roll the train state back "
                         "to the last checkpoint and skip the batch "
                         "(schedules keep their global step); raises after "
                         "3 consecutive rollbacks")
    ap.add_argument("--device", default=None,
                    help="torch device; the card by default, 'cpu' to run "
                         "on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from dino_tpu_torch.api import _refuse_world
    from dino_tpu_torch.checkpointing.async_writer import AsyncCheckpointer
    from dino_tpu_torch.checkpointing.convert import (from_jax_dino,
                                                      to_jax_dino,
                                                      to_jax_params)
    from dino_tpu_torch.checkpointing.io import flatten_params
    from dino_tpu_torch.checkpointing.resume import (load_optimizer_arrays,
                                                     optimizer_arrays,
                                                     restart_from_checkpoint)
    from dino_tpu_torch.data.prefetch import prefetched
    from dino_tpu_torch.models import vit as vit_mod
    from dino_tpu_torch.train.dino_pretrain import (DinoConfig,
                                                    dino_multi_crop_batch,
                                                    dino_schedules,
                                                    init_dino_params,
                                                    make_dino_optimizer,
                                                    make_dino_train_step,
                                                    set_hyperparams)
    from dino_tpu_torch.train.loop import _roadmap
    from dino_tpu_torch.utils.device import resolve_device
    from dino_tpu_torch.utils.schedules import schedule_at

    if args.fsdp:
        raise NotImplementedError(_roadmap(
            "--fsdp, FSDP / ZeRO-3 of the pretrain state (item 11.3)", 11))
    _refuse_world("DINO pretraining")
    device = resolve_device(args.device)
    if args.accum_steps > 1 and args.batch_size % args.accum_steps:
        raise ValueError(f"batch_size {args.batch_size} must divide by "
                         f"accum_steps {args.accum_steps}")

    files = sorted(
        glob.glob(os.path.join(args.data_path, "**", "*.jpg"),
                  recursive=True)
        + glob.glob(os.path.join(args.data_path, "**", "*.png"),
                    recursive=True))
    if not files:
        raise FileNotFoundError(f"no images under {args.data_path}")
    os.makedirs(args.write_path, exist_ok=True)

    vit_cfg = getattr(vit_mod, args.arch)(patch_size=args.patch_size)
    dino_cfg = DinoConfig(out_dim=args.out_dim,
                          n_local_crops=args.n_local_crops,
                          global_size=args.global_size,
                          local_size=args.local_size)
    student, teacher = init_dino_params(
        torch.Generator().manual_seed(args.seed), vit_cfg, dino_cfg,
        depth=args.depth, device=device)
    opt = make_dino_optimizer(student, lr=args.lr, weight_decay=0.04)
    step = make_dino_train_step(vit_cfg, dino_cfg,
                                accum_steps=args.accum_steps)
    center = torch.zeros((1, dino_cfg.out_dim), device=device)

    niter = max(1, len(files) // args.batch_size)
    lr_s, wd_s, mom_s, tt_s = dino_schedules(
        args.lr, args.epochs, niter, warmup_epochs=args.warmup_epochs,
        momentum_base=args.momentum_teacher,
        teacher_temp=args.teacher_temp,
        warmup_teacher_temp_epochs=args.warmup_teacher_temp_epochs)

    def load_crops(rows, epoch):
        # uint8 crops: the step normalizes on the card
        g, l = dino_multi_crop_batch(
            [files[i] for i in rows],
            [np.random.default_rng([args.seed, epoch, int(i)])
             for i in rows], dino_cfg)
        return torch.from_numpy(g), torch.from_numpy(l)

    writer = AsyncCheckpointer(name="pretrain-ckpt")
    resume_path = os.path.join(args.write_path, "pretrain_resume.npz")

    def model_tree(model):
        tree = to_jax_dino(model.state_dict(), dino_cfg.norm_last_layer)
        del tree["head"]["_meta"]  # configuration, not train state
        return tree

    def save_state(epoch, s):
        writer.save_train_state(
            resume_path, {"student": model_tree(student),
                          "teacher": model_tree(teacher), "center": center,
                          "opt_state": optimizer_arrays(opt)},
            run_variables={"epoch": epoch, "step": s})

    def load_state():
        """Restore student, teacher, centre and optimizer from
        resume_path; returns its run variables."""
        run_vars = {"epoch": 0, "step": None}
        restored = restart_from_checkpoint(
            resume_path, run_vars, student=None, teacher=None, center=None,
            opt_state=None)
        for model, name in ((student, "student"), (teacher, "teacher")):
            model.load_state_dict(from_jax_dino(restored[name]))
        center.copy_(torch.from_numpy(np.asarray(restored["center"])))
        load_optimizer_arrays(opt, restored["opt_state"])
        return run_vars

    start_epoch, start_step = 0, 0
    if args.resume and os.path.exists(resume_path):
        run_vars = load_state()
        # "step" is the last completed step of "epoch" (None: all of it)
        last = (niter - 1 if run_vars["step"] is None
                else int(run_vars["step"]))
        if last >= niter - 1:
            start_epoch = int(run_vars["epoch"]) + 1
        else:
            start_epoch, start_step = int(run_vars["epoch"]), last + 1

    # SIGTERM / SIGINT ask for a graceful stop: the step in flight ends,
    # the state is checkpointed and the run exits 0, to be resumed
    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        stop_requested["flag"] = True

    old_handlers = {s: signal.signal(s, _request_stop)
                    for s in (signal.SIGTERM, signal.SIGINT)}
    # fault injection: NaN crops at this 0-based step of the invocation,
    # which exercises --nan_guard's rollback
    fault_step = int(os.environ.get("DINO_TPU_FAULT_NAN_STEP", "-1"))
    steps_done, rollbacks, stopped = 0, 0, False
    it = start_epoch * niter + start_step
    try:
        for epoch in range(start_epoch, args.epochs):
            order = np.random.default_rng([args.seed, epoch]).permutation(
                len(files))
            t0 = time.time()
            losses = []
            first = start_step if epoch == start_epoch else 0

            def load_step(s, _epoch=epoch):
                return load_crops(
                    order[s * args.batch_size:(s + 1) * args.batch_size],
                    _epoch)

            for s, (g_crops, l_crops) in prefetched(range(first, niter),
                                                    load_step, depth=2):
                if steps_done == fault_step:
                    g_crops = g_crops + float("nan")
                set_hyperparams(opt, schedule_at(lr_s, it),
                                schedule_at(wd_s, it))
                loss = step(student, teacher, center, opt,
                            g_crops.to(device), l_crops.to(device),
                            schedule_at(tt_s, it), schedule_at(mom_s, it),
                            1.0 if epoch < args.freeze_last_layer else 0.0)
                losses.append(float(loss))
                it += 1
                steps_done += 1
                if args.nan_guard and not np.isfinite(losses[-1]):
                    # the state is poisoned: roll back to the last
                    # checkpoint and skip the batch, before any save
                    losses.pop()
                    rollbacks += 1
                    if rollbacks > 3:
                        raise RuntimeError(
                            "nan_guard: 3 consecutive rollbacks: the "
                            "divergence is persistent (lr too high or "
                            "corrupt data)")
                    writer.wait()
                    if not os.path.exists(resume_path):
                        raise RuntimeError(
                            "nan_guard: non-finite loss before the first "
                            "checkpoint exists: nothing to roll back to")
                    print(f"nan_guard: non-finite loss at epoch {epoch} "
                          f"step {s}: rolled back to {resume_path} and "
                          f"skipped the batch ({rollbacks}/3)")
                    load_state()
                    continue
                rollbacks = 0
                stopped = (stop_requested["flag"]
                           or (args.stop_after_steps is not None
                               and steps_done >= args.stop_after_steps))
                if stopped or (args.save_every_steps and s != niter - 1
                               and (s + 1) % args.save_every_steps == 0):
                    save_state(epoch, s)
                if stopped:
                    break
            if stopped:
                writer.close()  # the stop's save lands before the exit
                print(f"graceful stop at epoch {epoch} step "
                      f"{it - 1 - epoch * niter} (signal or "
                      f"--stop_after_steps); resume with --resume")
                return None
            print(f"[epoch {epoch}] dino_loss={np.mean(losses):.4f} "
                  f"lr={lr_s[it - 1]:.2e} m={mom_s[it - 1]:.4f} "
                  f"({time.time() - t0:.1f}s)")
            save_state(epoch, niter - 1)
            if args.stop_after is not None and epoch >= args.stop_after:
                print(f"stopping after epoch {epoch} (--stop_after); resume "
                      "with --resume")
                break
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
        writer.close()

    # the teacher's backbone (the better model, per the paper), in the
    # converted-npz layout DINOSeg(pretrained_path=...) loads
    out = os.path.join(args.write_path, "dino_pretrained_backbone.npz")
    vit_tree, _ = to_jax_params({"dino." + k: v for k, v in
                                 teacher.vit.state_dict().items()})
    np.savez(out, **flatten_params(vit_tree))
    print(f"saved backbone -> {out}")
    return out


if __name__ == "__main__":
    main()
