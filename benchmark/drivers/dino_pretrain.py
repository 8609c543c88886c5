"""DINO pretraining steps through ``make_dino_train_step``.

Set-up builds the student (on the card, holding the seeded weights), its
teacher, the optimizer and the step, makes a pool of seeded crop batches
on the card, and runs the first steps (``first_steps``, on pool batches
0, 1, 2, ...) through the window's own call: they warm up every shape,
and the check follows them.  It reads the first step's gradient from the
optimizer's state (AdamW's first moment after one step is (1 - beta1) g)
and, after the first steps, each leaf's change in the student and the
teacher and the centre, before the window moves them again.

The window runs steps on the next pool batches in turn until its time is
up, then synchronizes; ``images_per_s`` is the images of the steps run
over the window's seconds.  The host does not wait inside the window.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark.harness.cell import Window
from benchmark.harness.images import make_images
from benchmark.harness.weights import generator, make_weights
from benchmark.reference import dino as ref_dino

BETA1 = 0.9


def leaf_gaps(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; leaves not in ``keep`` are left out."""
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def compare_steps(prog: dict, ref: dict) -> dict:
    """The numbers that judge the first steps ``prog`` (``losses``, the
    first gradient's ``grad_norms`` by leaf, the student's ``moves`` and
    the teacher's ``teacher_moves`` by leaf, the ``center``) against the
    reference's (:func:`ref_dino.run_steps`): the worst relative gap of the
    steps' losses, and of the per-leaf norms of the first gradient, of the
    student's and the teacher's change and of the centre
    (:func:`leaf_gaps`).

    Round-off moves what the reference's gradient leaves still: Adam turns
    a gradient nought to rounding (the key's third of a qkv bias under
    softmax, the detached g of the last layer) into steps of up to lr.  So
    leaves whose reference gradient norm is under a thousandth of the
    median leaf's are left out, and the changes' norms are taken over the
    elements whose reference gradient is at least a thousandth of the
    median leaf's root-mean-square element."""
    names = list(prog["grad_norms"])
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    rg = {k: ref["first_grads"][k].cpu() for k in names}
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in rg.items()}
    med = float(np.median(list(norms.values())))
    keep = [k for k in names if norms[k] >= 1e-3 * med]
    rms = float(np.median([norms[k] / rg[k].numel() ** 0.5 for k in names]))
    masks = {k: rg[k].abs() >= 1e-3 * rms for k in keep}

    def masked(deltas) -> dict:
        return {k: float(torch.linalg.vector_norm(deltas[k].cpu()[masks[k]]))
                for k in keep}
    c_ref = float(torch.linalg.vector_norm(ref["center"].cpu()))
    c_prog = float(torch.linalg.vector_norm(prog["center"].cpu()))
    return {
        "loss_gap": loss_gap,
        "grad_gap": leaf_gaps(prog["grad_norms"], norms, keep),
        "move_gap": leaf_gaps(masked(prog["moves"]), masked(ref["moves"]),
                              keep),
        "teacher_move_gap": leaf_gaps(masked(prog["teacher_moves"]),
                                      masked(ref["teacher_moves"]), keep),
        "center_gap": abs(c_prog - c_ref) / c_ref}


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic
        self.b = self.cfg["batch_size_per_gpu"]
        self.k = 0  # steps run

    def _batch(self, i: int):
        cfg, dev = self.cfg, self.run.device
        gen = generator(self.run.seed, dev, "crops", str(i))
        g, l = cfg["global_crops_size"], cfg["local_crops_size"]
        ng, nl = cfg["global_crops_number"], cfg["local_crops_number"]
        gl = make_images(gen, ng * self.b, g, g, dev).view(ng, self.b, g, g, 3)
        lo = make_images(gen, nl * self.b, l, l, dev).view(nl, self.b, l, l, 3)
        return gl, lo

    def _step(self):
        g, l = self.pool[self.k % len(self.pool)]
        self.k += 1
        c = self.cfg
        return self.step(self.student, self.teacher, self.center, self.opt,
                         g, l, c["teacher_temp"], c["momentum_teacher"],
                         float(c["freeze_last_layer"] > 0))

    def weights(self):
        return make_weights(ref_dino.param_shapes(self.cfg), self.cfg["init"],
                            self.run.seed, self.run.device)

    def setup(self) -> None:
        from dino_tpu_torch.models.vit import ViTConfig
        from dino_tpu_torch.train import dino_pretrain as dp
        c, dev = self.cfg, self.run.device
        if c["drop_path_rate"] or c["global_crops_number"] != 2:
            raise ValueError("the port's step has no drop path and two "
                             "global crops")
        vit_cfg = ViTConfig(patch_size=c["patch_size"],
                            embed_dim=c["embed_dim"], depth=c["depth"],
                            num_heads=c["num_heads"],
                            mlp_ratio=float(c["mlp_ratio"]),
                            qkv_bias=c["qkv_bias"], ln_eps=c["ln_eps"],
                            img_size=c["img_size"])
        dino_cfg = dp.DinoConfig(
            out_dim=c["out_dim"], student_temp=c["student_temp"],
            center_momentum=c["center_momentum"],
            n_local_crops=c["local_crops_number"],
            global_size=c["global_crops_size"],
            local_size=c["local_crops_size"],
            norm_last_layer=c["norm_last_layer"], hidden_dim=c["hidden_dim"],
            bottleneck_dim=c["bottleneck_dim"])
        with torch.device(dev):
            student = dp.DinoModel(vit_cfg, dino_cfg)
        student.load_state_dict(self.weights(), strict=True)
        self.student, self.teacher = dp.dino_pair(student, dev)
        self.opt = dp.make_dino_optimizer(self.student, c["lr"],
                                          c["weight_decay"])
        dp.set_hyperparams(self.opt, c["lr"], c["weight_decay"])
        dtype = torch.bfloat16 if c["precision"] == "bf16" else None
        self.step = dp.make_dino_train_step(vit_cfg, dino_cfg,
                                            compute_dtype=dtype,
                                            clip=c["clip_grad"],
                                            accum_steps=c["accum_steps"])
        self.center = torch.zeros(1, c["out_dim"], device=dev)
        self.pool = [self._batch(i) for i in range(self.tr["pool_batches"])]
        self._first_steps()

    def _first_steps(self) -> None:
        """The first steps, with the readings the check needs: the first
        gradient's norm per leaf, each leaf's change in the student and
        the teacher, the centre (on the device; to the host after the
        window)."""
        named = list(self.student.named_parameters())
        p0 = [p.detach().clone() for _, p in named]
        self.first_losses = [self._step()]
        self.grad_norms = torch.stack([
            torch.linalg.vector_norm(self.opt.state[p]["exp_avg"])
            if "exp_avg" in self.opt.state[p] else p.new_zeros(())
            for _, p in named]) / (1 - BETA1)
        for _ in range(self.tr["first_steps"] - 1):
            self.first_losses.append(self._step())
        t_named = dict(self.teacher.named_parameters())
        self.names = [k for k, _ in named]
        self.moves = [p.detach() - q for (_, p), q in zip(named, p0)]
        self.teacher_moves = [t_named[k].detach() - q
                              for k, q in zip(self.names, p0)]
        self.center_after = self.center.clone()
        del p0
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def window(self) -> Window:
        losses = []
        wall = time.time()
        t0 = time.perf_counter()
        deadline = t0 + self.run.seconds
        while time.perf_counter() < deadline:
            losses.append(self._step())
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        seconds = time.perf_counter() - t0
        n = len(losses)
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        images = n * self.b
        return Window(t_start=wall, seconds=seconds, attempted=n, failed=bad,
                      work={"steps": n, "images": images},
                      metrics={"images_per_s": images / seconds})

    def traced(self) -> dict:
        n = self.tr["trace_steps"]
        for _ in range(n):
            self._step()
        return {"iterations": n, "images": n * self.b}

    def launches(self) -> dict:
        c = self.cfg
        mb = self.b // c["accum_steps"]
        k, depth, nh = c["accum_steps"], c["depth"], c["num_heads"]
        hd = c["embed_dim"] // nh
        ng = (c["global_crops_size"] // c["patch_size"]) ** 2 + 1
        nl = (c["local_crops_size"] // c["patch_size"]) ** 2 + 1
        g_bh = c["global_crops_number"] * mb * nh
        l_bh = c["local_crops_number"] * mb * nh
        return {
            "flash_fwd_bf16": [
                (k * depth, dict(bh=g_bh, n=ng, hd=hd, lse=True)),
                (k * depth, dict(bh=l_bh, n=nl, hd=hd, lse=True)),
                (k * depth, dict(bh=g_bh, n=ng, hd=hd, lse=False))],
            "flash_bwd_bf16": [
                (k * depth, dict(bh=g_bh, n=ng, hd=hd)),
                (k * depth, dict(bh=l_bh, n=nl, hd=hd))]}

    def release(self) -> None:
        self.first_losses = [float(x) for x in self.first_losses]
        self.grad_norms = self.grad_norms.tolist()
        self.moves = [t.cpu() for t in self.moves]
        self.teacher_moves = [t.cpu() for t in self.teacher_moves]
        self.center_after = self.center_after.cpu()
        del self.student, self.teacher, self.opt, self.step, self.center
        self.pool = self.pool[:self.tr["first_steps"]]
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The first steps again in the reference, from the same weights
        and crops, compared by :func:`compare_steps`."""
        ref = ref_dino.run_steps(self.weights(), self.pool, self.cfg,
                                 self.tr["check_microbatch"])
        prog = {"losses": self.first_losses,
                "grad_norms": dict(zip(self.names, self.grad_norms)),
                "moves": dict(zip(self.names, self.moves)),
                "teacher_moves": dict(zip(self.names, self.teacher_moves)),
                "center": self.center_after}
        return compare_steps(prog, ref)


def control(run) -> dict:
    """The control: the reference's first steps with fp8 products in the
    program's place, judged by :func:`compare_steps`."""
    d = Driver(run)
    batches = [d._batch(i) for i in range(d.tr["first_steps"])]
    mb = d.tr["check_microbatch"]
    ref = ref_dino.run_steps(d.weights(), batches, d.cfg, mb)
    low = ref_dino.run_steps(d.weights(), batches, d.cfg, mb, fp8=True)
    prog = {"losses": low["losses"],
            "grad_norms": {k: float(torch.linalg.vector_norm(g))
                           for k, g in low["first_grads"].items()},
            "moves": low["moves"], "teacher_moves": low["teacher_moves"],
            "center": low["center"]}
    return compare_steps(prog, ref)


@contextlib.contextmanager
def _step_fault(wrap):
    from unittest import mock
    from dino_tpu_torch.train import dino_pretrain as dp
    orig = dp.make_dino_train_step

    def make(*args, **kwargs):
        return wrap(orig(*args, **kwargs))
    with mock.patch.object(dp, "make_dino_train_step", make):
        yield


def _unchanged(step):
    """A step that returns the state as it found it."""
    def fault(student, teacher, center, opt, g, l, *rest):
        return center.new_zeros(())
    return fault


def _half_batch(step):
    """A step that leaves out half the batch, its mean over the rest."""
    def fault(student, teacher, center, opt, g, l, *rest):
        b = g.shape[1] // 2
        return step(student, teacher, center, opt, g[:, :b], l[:, :b], *rest)
    return fault


FAULTS = {"unchanged_state": lambda: _step_fault(_unchanged),
          "half_batch": lambda: _step_fault(_half_batch)}
