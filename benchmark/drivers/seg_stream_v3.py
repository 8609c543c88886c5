"""The closed-loop frame stream of ``drivers/seg_stream.py`` over a DINOv3
backbone (``DINOSeg(backbone=<the configuration's backbone>)``).

It keeps the stream's window and traced batches and overrides the rest:
the model (the configuration's widths checked against the port's, the
seeded weights of ``reference/dinov3.py:param_shapes``), the launch shapes
(per block the bf16 flash forward, the qkv epilogue and SwiGLU's
epilogue), the check (``reference/dinov3.py`` in float32 against a seeded
sample of the window's maps, ``label_far`` as the seg cells take it) and
the control (that reference with fp8 products in the program's place: the
port has no int8 path for this backbone).  Faults: a label map altered
where it is made, and the rotation left out (``no_rope``: the RoPE table
made the identity, cos 1 and sin 0).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple
from unittest import mock

import numpy as np
import torch

from benchmark.drivers import seg_stream
from benchmark.harness import seg
from benchmark.harness.weights import derive_seed, make_weights
from benchmark.reference import dinov3 as ref_v3
from benchmark.reference import seg as ref_seg


def weights(run) -> Dict[str, torch.Tensor]:
    cfg = run.cell.config
    return make_weights(ref_v3.param_shapes(cfg), cfg["init"], run.seed,
                        run.device)


def build_model(run):
    """The port's ``DINOSeg`` over the configuration's backbone, on the
    run's device, holding the seeded weights, at the traffic's
    resolution; a port without the backbone raises here, first."""
    from dino_tpu_torch.api import DINOSeg
    cfg, tr = run.cell.config, run.cell.traffic
    model = DINOSeg(backbone=cfg["backbone"], head=cfg["head"],
                    n_blocks=cfg["depth"], n_classes=cfg["n_classes"],
                    precision=cfg["precision"], random_init=True,
                    device=run.device)
    vc = model.cfg
    got = (vc.patch_size, vc.embed_dim, vc.num_heads, vc.mlp_hidden,
           vc.n_storage_tokens, vc.rope_base, vc.ln_eps)
    want = (cfg["patch_size"], cfg["embed_dim"], cfg["num_heads"],
            cfg["ffn_hidden"], cfg["n_storage_tokens"], cfg["rope_base"],
            cfg["ln_eps"])
    if got != want:
        raise ValueError(f"the port's ViT {got} is not the configuration's "
                         f"{want}")
    model.model.load_state_dict(weights(run), strict=True)
    model.set_resolution(tr["resolution"])
    return model


def launches(run, batch: int) -> dict:
    """Per predict batch and block: the flash forward over batch x heads
    rows of the frame's tokens, the qkv epilogue over the batch's tokens,
    SwiGLU's epilogue over all their rows."""
    cfg = run.cell.config
    prefix = 1 + cfg["n_storage_tokens"]
    n = (run.cell.traffic["resolution"] // cfg["patch_size"]) ** 2 + prefix
    nh, depth = cfg["num_heads"], cfg["depth"]
    return {"flash_fwd_bf16": [(depth, dict(bh=batch * nh, n=n,
                                            hd=cfg["embed_dim"] // nh))],
            "qkv_rope": [(depth, dict(batch=batch, n=n, heads=nh,
                                      prefix=prefix))],
            "swiglu": [(depth, dict(rows=batch * n,
                                    hidden=cfg["ffn_hidden"]))]}


def check_maps(run, pool: np.ndarray, order: np.ndarray,
               sample: List[Tuple[int, np.ndarray]],
               fp8: bool = False) -> Dict[str, float]:
    """``label_far`` of the sampled maps (stream index i is frame
    order[i % P]) against the float32 reference, in blocks of the
    traffic's ``check_block`` frames; ``fp8`` judges the reference's own
    fp8 maps of those frames instead (the control)."""
    if not sample:
        return {"label_far": 1.0}
    cfg, tr = run.cell.config, run.cell.traffic
    p = weights(run)
    block, res = tr["check_block"], tr["resolution"]
    total = {"miss": 0, "far": 0}
    for s in range(0, len(sample), block):
        part = sample[s:s + block]
        idx = [int(order[i % len(order)]) for i, _ in part]
        frames = torch.from_numpy(pool[idx]).to(run.device)
        logp = ref_v3.log_probs(p, frames, cfg, res)
        if fp8:
            maps = ref_seg.label_maps(ref_v3.log_probs(p, frames, cfg, res,
                                                       fp8=True)).cpu()
        else:
            maps = torch.from_numpy(np.stack([m for _, m in part]))
        for k, v in ref_seg.label_counts(logp, maps).items():
            total[k] += v
    return {"label_far": ref_seg.label_far(total)}


def pass_counters() -> Dict[str, int]:
    """The launch counters of the DINOv3 block's two passes; none in a port
    without them."""
    import importlib
    out = {}
    for name in ("qkv_rope", "swiglu"):
        try:
            mod = importlib.import_module(f"dino_tpu_torch.ops.{name}")
        except ImportError:
            continue
        out[name] = getattr(mod, name).launches
    return out


class Driver(seg_stream.Driver):
    def setup(self) -> None:
        self.model = build_model(self.run)
        self.pool = seg.frame_pool(self.run)
        self.order = seg.frame_order(self.run)
        self.stream = self.model.predict_stream(
            self._frames(), batch_size=self.b,
            precision=self.run.cell.config["precision"])
        self._take(self.tr["warmup_batches"] * self.b)
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def traced(self) -> dict:
        """The stream's traced batches, with the passes' launches over them
        (the harness's ``port_counters`` predates the passes)."""
        before = pass_counters()
        info = super().traced()
        after = pass_counters()
        info["launches"] = {k: after[k] - before[k] for k in after}
        return info

    def launches(self) -> dict:
        return launches(self.run, self.b)

    def check(self) -> dict:
        return check_maps(self.run, self.pool, self.order, self.sample)


def control(run) -> dict:
    """The reference with every product in fp8 e4m3 (``reference/lowp.py``)
    in the program's place, over a seeded sample of the traffic's
    ``check_frames`` stream indices of the pool's first pass, judged as
    the program is."""
    pool, order = seg.frame_pool(run), seg.frame_order(run)
    rng = np.random.default_rng(derive_seed(run.seed, "control"))
    k = run.cell.traffic["check_frames"]
    idx = sorted(rng.choice(len(order), size=min(k, len(order)),
                            replace=False).tolist())
    return check_maps(run, pool, order, [(i, None) for i in idx], fp8=True)


@contextlib.contextmanager
def no_rope():
    """A fault: every RoPE table the port makes is the identity rotation
    (cos 1, sin 0), so q and k go unrotated."""
    from dino_tpu_torch.models import vit
    orig = vit.rope_for

    def identity(cfg, x):
        t = orig(cfg, x)
        return None if t is None else (torch.ones_like(t[0]),
                                       torch.zeros_like(t[1]))
    with mock.patch.object(vit, "rope_for", identity):
        yield


FAULTS = {"altered_answer": lambda: seg.altered_answers("dino_tpu_torch.api"),
          "no_rope": no_rope}
