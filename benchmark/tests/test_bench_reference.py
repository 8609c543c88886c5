"""The plain reference agrees with the port's CPU path at a small size:
the segmentation model's float32 log-probabilities and bf16 maps, and a
float32 DINO pretraining step (loss, clipped gradients, the change of
every leaf).  The test imports both; the reference imports nothing of the
port."""
import json

import numpy as np
import pytest
import torch

from benchmark.harness.images import make_images
from benchmark.harness.weights import generator, make_weights
from benchmark.reference import dino as ref_dino
from benchmark.reference import seg as ref_seg
from benchmark.tests.conftest import PRETRAIN_CONFIG, ROOT

CPU = torch.device("cpu")


def config(name, **changes):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                     .read_text())
    cfg.update(changes)
    return cfg


def seg_model(cfg, weights, precision, res):
    from dino_tpu_torch.api import DINOSeg
    model = DINOSeg(head="mlp", n_blocks=cfg["depth"], n_classes=7,
                    precision=precision, random_init=True, device="cpu")
    model.model.load_state_dict(weights, strict=True)
    model.set_resolution(res)
    return model


@pytest.mark.parametrize("res,hw", [(32, (32, 48)), (48, (48, 48))])
def test_seg_log_probs_match_the_port_fp32(res, hw):
    cfg = config("dinoseg-vits8-3blk", depth=2)
    w = make_weights(ref_seg.param_shapes(cfg), cfg["init"], 11, CPU)
    frames = make_images(generator(11, CPU, "f"), 3, *hw, CPU)
    port = seg_model(cfg, w, "fp32", res).log_probs(frames)
    ref = ref_seg.log_probs(w, frames, cfg, res)
    np.testing.assert_allclose(port.reshape(ref.shape).numpy(), ref.numpy(),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("hw,res", [((40, 64), 48), ((480, 640), 480),
                                    ((480, 640), 960)])
def test_resize_matches_the_port(hw, res):
    """Both resize half-pixel bilinear and round half up to whole values;
    the reference's exact weights and the port's float32 ones part only
    where a value lies on k + 0.5 exactly (a tap of 1/6 or 5/6 at 640 ->
    480): one level, at about 1% of the pixels."""
    from dino_tpu_torch.ops.resize import resize_bilinear
    frames = make_images(generator(3, CPU, "f"), 2, *hw, CPU)
    port = resize_bilinear(frames, res, res, round_uint8=True)
    diff = (port - ref_seg.resize(frames, res)).abs()
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) < 0.03


def test_seg_bf16_maps_are_judged_close_and_faults_far():
    cfg = config("dinoseg-vits8-3blk", depth=2)
    w = make_weights(ref_seg.param_shapes(cfg), cfg["init"], 12, CPU)
    frames = make_images(generator(12, CPU, "f"), 2, 32, 48, CPU)
    maps = torch.from_numpy(seg_model(cfg, w, "bf16", 32)
                            .predict_batch(frames.numpy()))
    ref = ref_seg.log_probs(w, frames, cfg, 32)
    sound = ref_seg.label_counts(ref, maps)
    assert ref_seg.label_far(sound) < 0.008, sound
    assert ref_seg.label_counts(ref, ref_seg.label_maps(ref)) == {
        "miss": 0, "far": 0}
    shifted = ref_seg.label_counts(ref, (maps + 1) % 7)
    assert shifted["miss"] == maps.numel()
    assert ref_seg.label_far(shifted) > 0.5
    for broken in (maps + 7, maps[:, :-1]):
        assert ref_seg.label_far(ref_seg.label_counts(ref, broken)) == 1.0


def test_pretrain_steps_match_the_port_fp32():
    from dino_tpu_torch.models.vit import ViTConfig
    from dino_tpu_torch.train import dino_pretrain as dp
    cfg = config("dino-vits8-pretrain", **PRETRAIN_CONFIG)
    w = make_weights(ref_dino.param_shapes(cfg), cfg["init"], 13, CPU)
    gen = generator(13, CPU, "crops")
    b = cfg["batch_size_per_gpu"]
    batches = [(make_images(gen, 2 * b, 32, 32, CPU).view(2, b, 32, 32, 3),
                make_images(gen, 2 * b, 16, 16, CPU).view(2, b, 16, 16, 3))
               for _ in range(2)]
    vit_cfg = ViTConfig(patch_size=8, embed_dim=64, depth=1, num_heads=2,
                        img_size=224)
    dino_cfg = dp.DinoConfig(out_dim=256, n_local_crops=2, global_size=32,
                             local_size=16, hidden_dim=64, bottleneck_dim=32)
    student = dp.DinoModel(vit_cfg, dino_cfg)
    student.load_state_dict(w, strict=True)
    student, teacher = dp.dino_pair(student, "cpu")
    opt = dp.make_dino_optimizer(student, cfg["lr"], cfg["weight_decay"])
    step = dp.make_dino_train_step(vit_cfg, dino_cfg, clip=cfg["clip_grad"])
    center = torch.zeros(1, 256)
    losses, grads = [], None
    for g, l in batches:
        losses.append(float(step(student, teacher, center, opt, g, l,
                                 cfg["teacher_temp"], cfg["momentum_teacher"],
                                 0.0)))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in student.named_parameters()}
    ref = ref_dino.run_steps(w, batches, cfg, microbatch=2)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for k, g in ref["first_grads"].items():
        scale = float(g.abs().max()) or 1.0
        assert float((grads[k] - g).abs().max()) <= 1e-4 * scale, k
    moves = {k: p.detach() - w[k] for k, p in student.named_parameters()}
    t_moves = {k: p.detach() - w[k] for k, p in teacher.named_parameters()}
    from benchmark.drivers.dino_pretrain import compare_steps
    numbers = compare_steps(
        {"losses": losses,
         "grad_norms": {k: float(g.norm()) for k, g in grads.items()},
         "moves": moves, "teacher_moves": t_moves, "center": center}, ref)
    assert max(numbers.values()) < 1e-3, numbers
