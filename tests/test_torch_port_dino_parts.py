"""The parts of DINO pretraining: dino_tpu_torch's against dino_tpu's on the
CPU, from the same numpy inputs.

The DINO head and the multi-crop grouping, the loss, the centre and teacher
EMAs, the per-leaf clip, LARS, the parameter groups, the schedules, the
retrieval utilities, the weight converters and the multi-crop host path
(parameter draws, the cv2 bytes and the native loader's bytes).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn
from PIL import Image

from dino_tpu.data import native_loader as jnative
from dino_tpu.models import dino_head as jhead
from dino_tpu.models import vit as jvit
from dino_tpu.train import dino_pretrain as jdp
from dino_tpu.train import optim as joptim
from dino_tpu.utils import retrieval as jret
from dino_tpu.utils import schedules as jsched
from dino_tpu_torch.checkpointing import convert
from dino_tpu_torch.checkpointing.io import flatten_params
from dino_tpu_torch.data import native_loader as tnative
from dino_tpu_torch.models import dino_head as thead
from dino_tpu_torch.models import vit as tvit
from dino_tpu_torch.train import dino_pretrain as tdp
from dino_tpu_torch.train import optim as toptim
from dino_tpu_torch.utils import retrieval as tret
from dino_tpu_torch.utils import schedules as tsched

IN_DIM, OUT_DIM = 128, 64
HEAD_KW = dict(hidden_dim=64, bottleneck_dim=16)
# head forward and gradients: float32 products in another order (measured
# up to 5.8e-7 of the largest |y| or |g| of a tensor)
HEAD_REL = 1e-5
# loss, centre, EMA: the same float32 operations, summed in another order
# (measured 1.5e-8 on a centre entry of 5e-3 where its two terms cancel)
F32_RTOL = 1e-6
CENTER_ATOL = 1e-7
# LARS over 3 steps: float32 norms summed in another order
LARS_TOL = dict(rtol=1e-6, atol=1e-8)
# multi_scale: PyTorch's antialiased bilinear against jax.image.resize's
# (both a triangle filter widened by the downscale; float32 taps in
# another order: the resized pixels part by up to 1.8e-7, the features by
# 8.9e-8)
MULTI_SCALE_ATOL = 1e-6
CROP_CFG = dict(out_dim=32, n_local_crops=4, global_size=64, local_size=32)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# the head and the multi-crop forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm_last_layer", [True, False])
def test_head_forward_and_gradient_match(norm_last_layer):
    jp = jhead.init_dino_head(jax.random.PRNGKey(0), IN_DIM, OUT_DIM,
                              norm_last_layer=norm_last_layer, **HEAD_KW)
    rs = np.random.RandomState(1)
    x = rs.randn(12, IN_DIM).astype(np.float32)
    cot = rs.randn(12, OUT_DIM).astype(np.float32)
    trainable = {k: v for k, v in jp.items() if k != "_meta"}

    def jloss(p, x):
        return jnp.sum(jhead.dino_head_apply(dict(p, _meta=jp["_meta"]), x)
                       * cot)

    jy = jhead.dino_head_apply(jp, x)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(trainable, x)

    head = thead.DINOHead(IN_DIM, OUT_DIM, norm_last_layer=norm_last_layer,
                          **HEAD_KW)
    head.load_state_dict(convert.dino_head_state_dict(
        jax.tree.map(np.asarray, trainable)), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = head(xt)
    (y * torch.from_numpy(cot)).sum().backward()
    assert _rel_err(y.detach(), jy) <= HEAD_REL
    assert _rel_err(xt.grad, jg_x) <= HEAD_REL
    got = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
           for k, p in head.named_parameters()}
    want = convert.dino_head_state_dict(jax.tree.map(np.asarray, jg_p))
    for k in want:
        assert _rel_err(got[k], want[k]) <= HEAD_REL, k
    if norm_last_layer:  # g frozen: no gradient from the loss
        assert head.last_layer.g.grad is None
        assert not np.asarray(jg_p["last_layer"]["g"]).any()
    else:
        assert head.last_layer.g.grad.abs().max() > 0


def test_head_normalizes_with_epsilon_added():
    """x / (||x|| + 1e-12), not F.normalize's max(||x||, eps): a zero
    bottleneck row stays zero, and the weight norm adds 1e-12 too."""
    head = thead.init_dino_head(thead.DINOHead(4, 3, nlayers=1,
                                               bottleneck_dim=2),
                                torch.Generator().manual_seed(0))
    with torch.no_grad():
        head.mlp[0].weight.zero_()
        head.mlp[0].bias.zero_()
    assert torch.equal(head(torch.ones(2, 4)), torch.zeros(2, 3))
    jp = {"mlp": [{"kernel": np.zeros((4, 2), np.float32),
                   "bias": np.zeros(2, np.float32)}],
          "last_layer": {"v": np.zeros((2, 3), np.float32),
                         "g": np.ones(3, np.float32)},
          "_meta": {"norm_last_layer": True, "nlayers": 1}}
    np.testing.assert_array_equal(
        np.asarray(jhead.dino_head_apply(jp, np.ones((2, 4), np.float32))),
        np.zeros((2, 3), np.float32))


def test_multi_crop_forward_groups_like_dino_tpu():
    rs = np.random.RandomState(2)
    crops = [rs.rand(3, s, s, 3).astype(np.float32)
             for s in (32, 32, 16, 16, 16)]
    calls = {"jax": [], "torch": []}

    def jbackbone(b):
        calls["jax"].append(b.shape)
        return b.mean(axis=(1, 2))

    def tbackbone(b):
        calls["torch"].append(tuple(b.shape))
        return b.mean(dim=(1, 2))

    want = jhead.multi_crop_forward(jbackbone, lambda f: f * 2.0,
                                    [jnp.asarray(c) for c in crops])
    got = thead.multi_crop_forward(tbackbone, lambda f: f * 2.0,
                                   [torch.from_numpy(c) for c in crops])
    assert calls["torch"] == [tuple(s) for s in calls["jax"]] == [
        (6, 32, 32, 3), (9, 16, 16, 3)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# loss, centre, EMA
# ---------------------------------------------------------------------------

def test_dino_loss_and_center_match():
    rs = np.random.RandomState(3)
    b, k, n_crops = 4, 16, 4
    s_out = rs.randn(n_crops * b, k).astype(np.float32)
    t_out = rs.randn(2 * b, k).astype(np.float32)
    center = rs.randn(1, k).astype(np.float32) * 0.1
    for temp in (0.04, 0.07):
        want = jdp.dino_loss(s_out, t_out, center, 0.1, jnp.float32(temp),
                             n_crops)
        got = tdp.dino_loss(torch.from_numpy(s_out), torch.from_numpy(t_out),
                            torch.from_numpy(center), 0.1, temp, n_crops)
        np.testing.assert_allclose(float(got), float(want), rtol=F32_RTOL)
    want = jdp.update_center(center, t_out, 0.9)
    got = tdp.update_center(torch.from_numpy(center),
                            torch.from_numpy(t_out), 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL,
                               atol=CENTER_ATOL)


def test_ema_update_matches_and_skips_integer_tensors():
    rs = np.random.RandomState(4)
    w_t, w_s = (rs.randn(5, 3).astype(np.float32) for _ in range(2))

    class M(nn.Module):
        def __init__(self, w):
            super().__init__()
            self.w = nn.Parameter(torch.from_numpy(w.copy()))
            self.register_buffer("count", torch.arange(3))

    teacher, student = M(w_t), M(w_s)
    student.count += 7
    want = jdp.ema_update({"w": w_t, "count": np.arange(3)},
                          {"w": w_s, "count": np.arange(3) + 7},
                          jnp.float32(0.996))
    tdp.ema_update(teacher, student, 0.996)
    np.testing.assert_allclose(teacher.w.detach().numpy(),
                               np.asarray(want["w"]), rtol=F32_RTOL)
    assert torch.equal(teacher.count, torch.arange(3))


# ---------------------------------------------------------------------------
# clip, LARS, parameter groups
# ---------------------------------------------------------------------------

def test_clip_gradients_is_per_leaf():
    rs = np.random.RandomState(5)
    grads = {"a": rs.randn(6, 4).astype(np.float32) * 10,
             "b": rs.randn(7).astype(np.float32) * 1e-3,
             "c": np.zeros(3, np.float32)}
    want, want_norms = joptim.clip_gradients(grads, 3.0)
    got = [torch.from_numpy(grads[k].copy()) for k in ("a", "b", "c")]
    norms = toptim.clip_gradients(got, 3.0)
    for t, n, k in zip(got, norms, ("a", "b", "c")):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]),
                                   rtol=F32_RTOL)
        np.testing.assert_allclose(float(n), float(want_norms[k]),
                                   rtol=F32_RTOL)
    np.testing.assert_array_equal(got[1].numpy(), grads["b"])  # not clipped
    assert float(torch.linalg.vector_norm(got[0])) == pytest.approx(3.0,
                                                                    rel=1e-5)


@pytest.mark.parametrize("schedule", [False, True])
def test_lars_three_steps_match(schedule):
    rs = np.random.RandomState(6)
    params = {"w": rs.randn(5, 4).astype(np.float32),
              "b": rs.randn(4).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in
              params.items()} for _ in range(3)]
    lr = (lambda count: 0.1 / count) if schedule else 0.1
    jopt = joptim.lars(lr, momentum=0.9, weight_decay=1e-2)
    state = jopt.init(params)
    jp = params
    tp = {k: nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = toptim.LARS(list(tp.values()), lr, momentum=0.9,
                       weight_decay=1e-2)
    for g in grads:
        upd, state = jopt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jp[k]), **LARS_TOL)


def test_params_groups_decay_the_matrices_only():
    student, _ = jdp.init_dino_params(jax.random.PRNGKey(0),
                                      jvit.ViTConfig(patch_size=8,
                                                     embed_dim=128,
                                                     num_heads=2),
                                      jdp.DinoConfig(out_dim=32, **HEAD_KW),
                                      depth=1)
    trainable = {"vit": student["vit"],
                 "head": {k: v for k, v in student["head"].items()
                          if k != "_meta"}}
    reg, not_reg = joptim.get_params_groups(trainable)
    model = tdp.DinoModel(tvit.ViTConfig(patch_size=8, embed_dim=128,
                                         num_heads=2),
                          tdp.DinoConfig(out_dim=32, **HEAD_KW), depth=1)
    model.load_state_dict(convert.from_jax_dino(
        jax.tree.map(np.asarray, student)))
    groups = toptim.get_params_groups(model)
    names = {id(p): n for n, p in model.named_parameters()}
    port = {n: i for i, g in enumerate(groups) for n in
            (names[id(p)] for p in g["params"])}
    want = {}
    for path, flag in flatten_params(reg).items():
        want[path] = 0 if bool(flag) else 1
    got = flatten_params(convert.to_jax_dino(
        {n: torch.full_like(p, float(port[n]))
         for n, p in model.named_parameters()}))
    assert groups[1]["weight_decay"] == 0.0
    assert len(port) == len(want)
    for path, i in want.items():
        assert (got[path] == i).all(), path
    assert all(not bool(v) for v in jax.tree.leaves(
        jax.tree.map(lambda a, b: a and b, reg, not_reg)))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 2])
def test_schedules_are_bit_equal(warmup):
    want = jsched.cosine_scheduler(5e-4, 1e-6, 5, 7, warmup_epochs=warmup)
    got = tsched.cosine_scheduler(5e-4, 1e-6, 5, 7, warmup_epochs=warmup)
    np.testing.assert_array_equal(got, want)
    fn = jsched.as_optax_schedule(want)
    for step in (-3, 0, 11, 34, 35, 90):
        assert tsched.schedule_at(got, step) == float(fn(step))
    kw = dict(warmup_epochs=warmup, warmup_teacher_temp=0.02,
              teacher_temp=0.05, warmup_teacher_temp_epochs=3)
    for a, b in zip(tdp.dino_schedules(1e-3, 5, 7, **kw),
                    jdp.dino_schedules(1e-3, 5, 7, **kw)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------

def test_retrieval_matches():
    rs = np.random.RandomState(7)
    x = rs.randn(200, 16) @ rs.randn(16, 16)
    np.testing.assert_array_equal(tret.PCA(8, 0.5).fit(x).apply(x),
                                  jret.PCA(8, 0.5).fit(x).apply(x))
    ranks = np.argsort(rs.rand(30, 4), axis=0)
    gnd = [{"ok": [1, 5], "junk": [2]}, {"ok": [7]}, {"ok": []},
           {"ok": [0, 3, 9], "junk": [4, 8]}]
    got, want = (m.compute_map(ranks, gnd, kappas=[1, 5, 10])
                 for m in (tret, jret))
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    assert tret.compute_ap(np.array([1, 4]), 3) == jret.compute_ap(
        np.array([1, 4]), 3)


def test_multi_scale_matches():
    rs = np.random.RandomState(8)
    x = rs.rand(2, 48, 40, 3).astype(np.float32)
    w = rs.randn(3, 5).astype(np.float32)
    want = jret.multi_scale(jnp.asarray(x),
                            lambda b: b.mean(axis=(1, 2)) @ w)
    got = tret.multi_scale(torch.from_numpy(x),
                           lambda b: b.mean(dim=(1, 2)) @ torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MULTI_SCALE_ATOL)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

def test_dino_converters_round_trip(tmp_path):
    cfg = jvit.ViTConfig(patch_size=8, embed_dim=128, num_heads=2)
    student, teacher = jdp.init_dino_params(
        jax.random.PRNGKey(3), cfg, jdp.DinoConfig(out_dim=32, **HEAD_KW),
        depth=1)
    for tree in (student, teacher):
        tree = jax.tree.map(np.asarray, tree)
        back = convert.to_jax_dino(convert.from_jax_dino(tree))
        assert back["head"]["_meta"] == tree["head"]["_meta"]
        assert (jax.tree.structure(back) == jax.tree.structure(tree))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)
    # convert_dino_pretrain: a converted .npz and a raw .pth backbone
    vit = jax.tree.map(np.asarray, teacher["vit"])
    want = convert.strip_prefix(convert.from_jax_params(vit), "dino.")
    npz = str(tmp_path / "backbone.npz")
    np.savez(npz, **flatten_params(vit))
    pth = str(tmp_path / "backbone.pth")
    torch.save(want, pth)
    for path in (npz, pth):
        got = convert.convert_dino_pretrain(path)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# the multi-crop host path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dino_crops")
    rs = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate([(200, 300), (96, 128), (417, 211)]):
        p = str(root / f"{i}.jpg")
        Image.fromarray(rs.randint(0, 255, (h, w, 3), np.uint8)).save(
            p, quality=95)
        paths.append(p)
    return paths


def test_draws_and_packing_match():
    jcfg, tcfg = jdp.DinoConfig(**CROP_CFG), tdp.DinoConfig(**CROP_CFG)
    for seed in range(20):
        want = jdp.draw_dino_params(np.random.default_rng(seed), 90, 130,
                                    jcfg)
        got = tdp.draw_dino_params(np.random.default_rng(seed), 90, 130,
                                   tcfg)
        np.testing.assert_array_equal(tdp.pack_dino_params(got),
                                      jdp.pack_dino_params(want))
        assert [p["rect"] for p in got] == [p["rect"] for p in want]


def test_cv2_crops_give_dino_tpu_bytes(jpegs):
    jcfg, tcfg = jdp.DinoConfig(**CROP_CFG), tdp.DinoConfig(**CROP_CFG)
    for seed, path in enumerate(jpegs):
        img = np.array(Image.open(path).convert("RGB"))
        want = jdp.dino_multi_crop(np.random.default_rng(seed), img, jcfg)
        got = tdp.dino_multi_crop(np.random.default_rng(seed), img, tcfg)
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rung", ["native", "cv2"])
def test_crop_batches_give_dino_tpu_bytes(jpegs, rung, monkeypatch):
    """dino_multi_crop_batch on each rung, and the port's native entry
    against dino_tpu's on the same packed parameters."""
    if rung == "native":
        if tnative.get_lib() is None or jnative.get_lib() is None:
            pytest.skip(f"native loader unavailable: {tnative.build_error}")
        packed = np.stack([jdp.pack_dino_params(jdp.draw_dino_params(
            np.random.default_rng(i), 96, 128, jdp.DinoConfig(**CROP_CFG)))
            for i in range(len(jpegs))])
        want = jnative.dino_crops_batch(jpegs, packed, 4, 64, 32)
        got = tnative.dino_crops_batch(jpegs, packed, 4, 64, 32)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    else:
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    rngs = [[7, 1, i] for i in range(len(jpegs))]
    want = jdp.dino_multi_crop_batch(
        jpegs, [np.random.default_rng(r) for r in rngs],
        jdp.DinoConfig(**CROP_CFG))
    got = tdp.dino_multi_crop_batch(
        jpegs, [np.random.default_rng(r) for r in rngs],
        tdp.DinoConfig(**CROP_CFG))
    assert got[0].shape == (2, 3, 64, 64, 3)
    assert got[1].shape == (4, 3, 32, 32, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert os.path.exists(jpegs[0])
