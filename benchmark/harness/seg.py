"""What the segmentation cells share: the port's model over seeded
weights, the frame pool, the sample of maps the check reads, and the
check itself."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness.images import make_images
from benchmark.harness.weights import derive_seed, generator, make_weights
from benchmark.reference import seg as ref_seg


def weights(run) -> Dict[str, torch.Tensor]:
    cfg = run.cell.config
    return make_weights(ref_seg.param_shapes(cfg), cfg["init"], run.seed,
                        run.device)


def build_model(run):
    """The port's ``DINOSeg`` at the configuration, on the run's device,
    holding the seeded weights, at the traffic's resolution."""
    from dino_tpu_torch.api import DINOSeg
    cfg, tr = run.cell.config, run.cell.traffic
    model = DINOSeg(head=cfg["head"], n_blocks=cfg["depth"],
                    n_classes=cfg["n_classes"], precision=cfg["precision"],
                    random_init=True, device=run.device)
    vc = model.cfg
    got = (vc.patch_size, vc.embed_dim, vc.num_heads, vc.mlp_ratio,
           vc.img_size, vc.ln_eps)
    want = (cfg["patch_size"], cfg["embed_dim"], cfg["num_heads"],
            cfg["mlp_ratio"], cfg["img_size"], cfg["ln_eps"])
    if got != want:
        raise ValueError(f"the port's ViT {got} is not the configuration's "
                         f"{want}")
    model.model.load_state_dict(weights(run), strict=True)
    model.set_resolution(tr["resolution"])
    return model


def launches(run, batch: int) -> dict:
    """The kernels' launch shapes of one predict batch: per block, the
    flash forward over batch x heads rows of the frame's tokens and the
    fused MLP over all their rows."""
    cfg = run.cell.config
    n = (run.cell.traffic["resolution"] // cfg["patch_size"]) ** 2 + 1
    d, nh, depth = cfg["embed_dim"], cfg["num_heads"], cfg["depth"]
    return {"flash_fwd_bf16": [(depth, dict(bh=batch * nh, n=n,
                                            hd=d // nh))],
            "fused_ln_mlp": [(depth, dict(m=batch * n, d=d,
                                          h=int(d * cfg["mlp_ratio"])))]}


def frame_pool(run) -> np.ndarray:
    """The traffic's pool of distinct uint8 frames (P, H, W, 3), made on
    the device from the seed, held in host memory."""
    tr = run.cell.traffic
    h, w = tr["frame_hw"]
    gen = generator(run.seed, run.device, "frames")
    return make_images(gen, tr["pool_frames"], h, w, run.device).cpu().numpy()


def frame_order(run) -> np.ndarray:
    rng = np.random.default_rng(derive_seed(run.seed, "order"))
    return rng.permutation(run.cell.traffic["pool_frames"])


class Reservoir:
    """A uniform sample of ``k`` of the maps offered, drawn from the seed
    (reservoir sampling): (index of the map in the stream, copy of it)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(derive_seed(seed, "sample"))
        self.items: List[Tuple[int, np.ndarray]] = []
        self.seen = 0

    def offer(self, index: int, m: np.ndarray) -> None:
        if len(self.items) < self.k:
            self.items.append((index, np.array(m, copy=True)))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = (index, np.array(m, copy=True))
        self.seen += 1


def check_maps(run, pool: np.ndarray, order: np.ndarray,
               sample: List[Tuple[int, np.ndarray]]) -> Dict[str, float]:
    """``label_far`` of the sampled maps against the reference over all
    their pixels (:func:`ref_seg.label_counts`; the map of stream index i
    is of frame order[i % P]); no map sampled reads 1."""
    if not sample:
        return {"label_far": 1.0}
    cfg, tr = run.cell.config, run.cell.traffic
    p = weights(run)
    block = tr["check_block"]
    total = {"miss": 0, "far": 0}
    for s in range(0, len(sample), block):
        part = sample[s:s + block]
        idx = [int(order[i % len(order)]) for i, _ in part]
        frames = torch.from_numpy(pool[idx]).to(run.device)
        logp = ref_seg.log_probs(p, frames, cfg, tr["resolution"])
        maps = torch.from_numpy(np.stack([m for _, m in part]))
        for k, v in ref_seg.label_counts(logp, maps).items():
            total[k] += v
    return {"label_far": ref_seg.label_far(total)}


def control(run, driver_class) -> Dict[str, float]:
    """The control: the program with its own lower-precision path switched
    on (the port's ``precision='int8'``: the blocks' products over
    per-channel int8 weights and per-token int8 activations, the step
    below bf16), run by the cell's driver through a short window and
    judged as the program is."""
    cell = dataclasses.replace(run.cell, config={**run.cell.config,
                                                 "precision": "int8"})
    drv = driver_class(dataclasses.replace(run, cell=cell,
                                           seconds=max(run.seconds, 1.0)))
    drv.setup()
    drv.window()
    drv.release()
    return drv.check()


@contextlib.contextmanager
def altered_answers(module: str):
    """A fault: every label map ``module``'s ``label_maps`` makes (the
    port's predict path) comes out with each label moved to the next
    class."""
    import importlib
    from unittest import mock
    mod = importlib.import_module(module)
    orig = mod.label_maps

    def altered(log_probs, resolution, n_classes):
        return (orig(log_probs, resolution, n_classes) + 1) % n_classes
    with mock.patch.object(mod, "label_maps", altered):
        yield
