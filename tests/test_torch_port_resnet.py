"""The cnn1/cnn2 ResNet-50 backbones (ROADMAP item 8.3):
dino_tpu_torch.models.resnet and DINOSeg(backbone='cnn1'/'cnn2') against
dino_tpu's on carried weights, on the CPU.  Follows tests/test_resnet.py.

BatchNorm stats are perturbed from their init (scale, bias, mean, var drawn
from seed 0) so that eval mode is not the identity.  At dino_tpu's random
init the activations grow to ~1e3 by layer2 (eval BatchNorm with var 1 does
not normalize them), so float tolerances are against each tensor's max |ref|:
measured 1.2e-6 (cnn1) and 1.1e-6 (cnn2) in float32, and 9.8e-3 / 9.1e-3 in
bf16 (two to three bf16 steps of the largest values: the two packages' conv
sums round in another order).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dino_tpu.api import DINOSeg as JaxDINOSeg
from dino_tpu.models import resnet as jr
from dino_tpu.models.heads import init_head as jinit_head
from dino_tpu.models.vit import ViTConfig as JViTConfig
from dino_tpu.train import loop as jloop
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.checkpointing.convert import (from_jax_params,
                                                  strip_prefix, to_jax_params)
from dino_tpu_torch.models import heads as theads
from dino_tpu_torch.models import resnet as tr
from dino_tpu_torch.models.vit import ViTConfig
from dino_tpu_torch.train import loop as tloop

RES, N_CLASSES, BATCH = 64, 3, 2
F32_REL, BF16_REL = 1e-5, 3e-2
LOSS_RTOL = 1e-5
# one train step, float32 on both sides: gradients and updated stats
# against each leaf's max |ref| (measured up to 2.4e-6)
STEP_REL = 1e-4
MARGIN = 1e-4  # top-2 log-prob gap below which fp32 argmax may flip


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(params, seed=0):
    """dino_tpu's cnn params with BatchNorm stats and cnn2 biases drawn."""
    rs = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                c = node["scale"].shape[0]
                return {"scale": (rs.rand(c) + 0.5).astype(np.float32),
                        "bias": (rs.randn(c) * 0.1).astype(np.float32),
                        "mean": (rs.randn(c) * 0.1).astype(np.float32),
                        "var": (rs.rand(c) + 0.5).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    out = walk(_np(params))
    for k in ("upconv", "conv"):
        if k in out:
            out[k]["bias"] = (rs.randn(512) * 0.1).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=["cnn1", "cnn2"])
def carried(request):
    """dino_tpu's cnn pytree with drawn BatchNorm stats, and the port's
    backbone holding it.  The draw starts from the port's init of
    dino_tpu's distributions (JAX's own init takes ~5 s eagerly here)."""
    variant = request.param
    init = tr.init_resnet_params(tr.ResNetBackbone(variant),
                                 torch.Generator().manual_seed(0))
    p = _perturb(to_jax_params({"dino." + k: v for k, v in
                                init.state_dict().items()})[0])
    m = tr.ResNetBackbone(variant)
    m.load_state_dict(strip_prefix(from_jax_params(p), "dino."), strict=True)
    return variant, p, m


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_conv2d_matches_dino_tpu():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 16, 16, 8).astype(np.float32)
    w = rs.randn(3, 3, 8, 4).astype(np.float32)  # HWIO
    ref = np.asarray(jr.conv2d(jnp.asarray(x), jnp.asarray(w), stride=2,
                               padding=1))
    out = tr.conv2d(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                    torch.from_numpy(w.transpose(3, 2, 0, 1)), stride=2,
                    padding=1).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def _bn_module(p):
    bn = torch.nn.BatchNorm2d(p["scale"].shape[0]).requires_grad_(False)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(p["mean"]))
        bn.running_var.copy_(torch.from_numpy(p["var"]))
    return bn


def _bn_params(rs, c):
    return {"scale": rs.randn(c).astype(np.float32),
            "bias": rs.randn(c).astype(np.float32),
            "mean": rs.randn(c).astype(np.float32),
            "var": (rs.rand(c) + 0.5).astype(np.float32)}


def test_batch_norm_eval_matches_dino_tpu():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 8, 8, 16).astype(np.float32)
    p = _bn_params(rs, 16)
    ref = np.asarray(jr.batch_norm(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x)))
    out = tr.batch_norm(_bn_module(p), torch.from_numpy(
        x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_batch_norm_train_matches_dino_tpu_and_torch():
    """Batch statistics normalize; the running stats take the unbiased
    variance at momentum 0.1: dino_tpu's and torch's BatchNorm2d.train()."""
    rs = np.random.RandomState(0)
    x = rs.randn(4, 6, 5, 3).astype(np.float32)  # NHWC
    p = _bn_params(rs, 3)
    y_ref, new_ref = jr.batch_norm_train(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x))
    bn = _bn_module(p)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    y, (mean, var) = tr.batch_norm_train(bn, xt)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1),
                               np.asarray(y_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(new_ref["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(new_ref["var"]),
                               atol=1e-5)
    bn.train()
    with torch.no_grad():
        ty = bn(xt)
    np.testing.assert_allclose(y.numpy(), ty.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mean.numpy(), bn.running_mean.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), bn.running_var.numpy(),
                               atol=1e-5)


def test_max_pool_matches_dino_tpu():
    x = np.random.RandomState(2).randn(2, 9, 9, 4).astype(np.float32)
    ref = np.asarray(jr.max_pool(jnp.asarray(x)))
    out = tr.max_pool(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_array_equal(out.numpy().transpose(0, 2, 3, 1), ref)


def test_conv_transpose_matches_dino_tpu_and_torch():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5, 6, 8).astype(np.float32)
    w = rs.randn(8, 4).astype(np.float32)  # (in, out)
    b = rs.randn(4).astype(np.float32)
    ref = np.asarray(jr.conv_transpose_1x1_s2(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    wt = torch.from_numpy(w[:, :, None, None])
    out = tr.conv_transpose_1x1_s2(xt, wt, torch.from_numpy(b))
    assert out.shape == (2, 4, 10, 12)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref,
                               atol=1e-5, rtol=1e-5)
    torch_ref = F.conv_transpose2d(xt, wt, torch.from_numpy(b), stride=2,
                                   output_padding=1)
    np.testing.assert_allclose(out.numpy(), torch_ref.numpy(), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the backbones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rel", [("float32", F32_REL),
                                       ("bfloat16", BF16_REL)])
def test_features_match_dino_tpu(carried, dtype, rel, record_property):
    variant, p, m = carried
    x = np.random.RandomState(4).randn(BATCH, RES, RES, 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jr.resnet_backbone_apply(
        p, x, variant))(p, jnp.asarray(x).astype(getattr(jnp, dtype))).astype(
            jnp.float32))
    with torch.no_grad():
        feats = tr.resnet_features(m, torch.from_numpy(x).to(
            getattr(torch, dtype)))
    assert feats.shape == (BATCH * (RES // 8) ** 2, 512)
    assert feats.dtype == getattr(torch, dtype)
    # the fold is dino_tpu's row-major NHWC order
    got = _rel(feats.float().numpy(), ref.reshape(-1, 512))
    record_property("max_abs_diff_over_max_ref", float(got))
    assert got < rel


def test_last_block_relu_off(carried):
    """The last bottleneck's relu is Identity at all three sites: its output
    has negative entries, an earlier block's has none."""
    variant, _, m = carried
    x = torch.from_numpy(np.random.RandomState(5).randn(
        1, RES, RES, 3).astype(np.float32))
    with torch.no_grad():
        out = tr.resnet_backbone_apply(m, x)
        if variant == "cnn1":
            assert float(out.min()) < 0
        stages = m.stages()
        h = x.permute(0, 3, 1, 2)
        h = tr.max_pool(torch.relu(tr.batch_norm(m.bn1, tr.conv2d(
            h, m.conv1.weight, stride=2, padding=3))))
        first = tr._bottleneck(stages[0][0], h, 1, True, tr.batch_norm)
        assert float(first.min()) >= 0
        last = stages[-1][-1]
        pre = tr._bottleneck(last, torch.randn(1, last.conv1.in_channels, 4,
                                               4), 1, False, tr.batch_norm)
        assert float(pre.min()) < 0


def test_convert_round_trip(carried):
    variant, p, m = carried
    vit_p, _ = to_jax_params({"dino." + k: v
                              for k, v in m.state_dict().items()})
    assert len(vit_p["layers"]) == (2 if variant == "cnn1" else 3)
    for a, b in zip(jax.tree.leaves(vit_p), jax.tree.leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree.structure(vit_p) == jax.tree.structure(p)


def test_local_file_loader(tmp_path, monkeypatch):
    """A torchvision-named ResNet-50 state dict from a local file: prefixes
    stripped, layers past the cut dropped, loaded into the backbone; with no
    file it warns and keeps the random init.  Nothing is downloaded.  The
    ladder caches what it converts (checkpointing/pretrained.py), so the
    cache and the hub cache live under tmp_path."""
    from dino_tpu_torch.checkpointing.pretrained import \
        load_pretrained_resnet
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("DINO_TPU_CACHE", str(tmp_path / "cache"))
    src = tr.init_resnet_params(tr.ResNetBackbone("cnn2"),
                                torch.Generator().manual_seed(7))
    sd = {"module." + k: v for k, v in src.state_dict().items()
          if not k.startswith(("upconv.", "conv."))}
    sd["module.fc.weight"] = torch.zeros(1000, 2048)  # past the cut
    path = str(tmp_path / "rn50.pth")
    torch.save(sd, path)
    got = load_pretrained_resnet("cnn1", path)
    assert set(got) == set(tr.ResNetBackbone("cnn1").state_dict())
    torch.testing.assert_close(got["layer2.3.bn3.running_var"],
                               src.layer2[3].bn3.running_var)
    monkeypatch.delenv("DINO_TPU_PRETRAINED_RESNET", raising=False)
    os.remove(str(tmp_path / "cache" / "dino_resnet50_pretrain_cnn1.npz"))
    assert load_pretrained_resnet("cnn1") is None
    with pytest.warns(UserWarning, match="DINO_TPU_PRETRAINED_RESNET"):
        DINOSeg(backbone="cnn1", head="linear", n_classes=3, device="cpu")
    monkeypatch.setenv("DINO_TPU_PRETRAINED_RESNET", path)
    model = DINOSeg(backbone="cnn2", head="linear", n_classes=3,
                    device="cpu")
    torch.testing.assert_close(model.model.dino.layer3[1].conv2.weight,
                               src.layer3[1].conv2.weight)
    with pytest.raises(KeyError, match="lacks"):
        torch.save({"conv1.weight": torch.zeros(64, 3, 7, 7)}, path)
        load_pretrained_resnet("cnn1", path)


# ---------------------------------------------------------------------------
# the train step: BatchNorm in train mode, running stats written back
# ---------------------------------------------------------------------------

def _batch(seed=0):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 255, (BATCH, RES, RES, 3)).astype(np.uint8)
    labels = rs.randint(0, N_CLASSES, (BATCH, (RES // 8) ** 2)).astype(
        np.int32)
    return images, labels


def _leaf_rel(got, want):
    worst = 0.0
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        worst = max(worst, np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    return worst


@pytest.mark.parametrize("frozen", [True, False])
def test_train_step_matches_dino_tpu(carried, frozen, record_property):
    """One SGD step (lr 0.1) of the float32 train step: loss, confusion
    matrix, updated weights and running stats against dino_tpu's."""
    variant, p, _ = carried
    head_p = _np(jinit_head(jax.random.PRNGKey(1), "linear", N_CLASSES, 512))
    images, labels = _batch()
    jopt = jloop.make_optimizer("sgd", 0.1)
    jstep = jloop.make_train_step(JViTConfig(patch_size=8), "linear",
                                  N_CLASSES, jopt, frozen, donate=False,
                                  backbone=variant)
    new_v, new_h, _, jl, jcm = jstep(
        p, head_p, jloop.init_opt_state(jopt, p, head_p, frozen), images,
        labels)
    sd = from_jax_params(p, head_p)
    m = tr.ResNetBackbone(variant)
    m.load_state_dict(strip_prefix(sd, "dino."), strict=True)
    head = theads.LinearHead(N_CLASSES, 512)
    head.load_state_dict(strip_prefix(sd, "clf."), strict=True)
    m.requires_grad_(not frozen)
    topt = tloop.make_optimizer("sgd", 0.1)
    tstep = tloop.make_train_step(ViTConfig(patch_size=8), "linear",
                                  N_CLASSES, topt, frozen, backbone=variant)
    loss, cm = tstep(m, head, tloop.init_opt_state(topt, m, head, frozen),
                     torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    got_v, got_h = to_jax_params(
        {**{"dino." + k: v for k, v in m.state_dict().items()},
         **{"clf." + k: v for k, v in head.state_dict().items()}})
    record_property("head_leaf_rel", float(_leaf_rel(got_h, _np(new_h))))
    record_property("backbone_leaf_rel", float(_leaf_rel(got_v, _np(new_v))))
    assert _leaf_rel(got_h, _np(new_h)) < STEP_REL
    assert _leaf_rel(got_v, _np(new_v)) < STEP_REL
    # the running stats moved, frozen or not; frozen weights did not
    assert not np.allclose(got_v["bn1"]["mean"], p["bn1"]["mean"])
    assert not np.allclose(got_v["layers"][1][0]["bn3"]["var"],
                           p["layers"][1][0]["bn3"]["var"])
    if frozen:
        np.testing.assert_array_equal(got_v["conv1"], p["conv1"])
        np.testing.assert_array_equal(got_v["bn1"]["scale"],
                                      p["bn1"]["scale"])
    assert int(m.bn1.num_batches_tracked) == 1


def test_accum_steps_guard():
    for kw in (dict(backbone="cnn1", accum_steps=2),
               dict(backbone="cnn2", accum_steps=4)):
        with pytest.raises(ValueError, match="BatchNorm"):
            tloop.make_train_step(ViTConfig(patch_size=8), "linear", 3,
                                  tloop.make_optimizer("adam", 1e-3), True,
                                  **kw)
    with pytest.raises(ValueError, match="unknown backbone"):
        tloop.make_train_step(ViTConfig(patch_size=8), "linear", 3,
                              tloop.make_optimizer("adam", 1e-3), True,
                              backbone="cnn3")


# ---------------------------------------------------------------------------
# DINOSeg with a cnn backbone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["cnn1", "cnn2"])
def test_dinoseg_cnn_predict_matches_dino_tpu(variant, tmp_path):
    """fp32 predict at 240px on dino_tpu's weights (through its .npz
    checkpoint): labels equal except near ties; guards as dino_tpu's."""
    jm = JaxDINOSeg(head="mlp", n_classes=5, backbone=variant,
                    random_init=True, seed=0, precision="fp32")
    jm.vit_params = jax.tree.map(jnp.asarray, _perturb(jm.vit_params))
    jm.set_resolution(240)
    path = str(tmp_path / "cnn.npz")
    jm.save(path)
    pm = DINOSeg.load_from_checkpoint(path, device="cpu")
    assert pm.backbone == variant and pm.mlp_input_dim == 512
    pm.set_resolution(240)
    img = np.random.RandomState(0).randint(0, 255, (100, 120, 3), np.uint8)
    out, ref = pm.predict(img), jm.predict(img)
    assert out.shape == (480, 480) and out.dtype == np.int32
    assert out.max() < 5
    logp = pm.log_probs(torch.from_numpy(img[None])).numpy()
    top2 = np.sort(logp, axis=-1)[:, -2:]
    near = ((top2[:, 1] - top2[:, 0]) < MARGIN).reshape(30, 30)
    np.testing.assert_array_equal(out[::16, ::16][~near],
                                  ref[::16, ::16][~near])
    assert pm.predict_batch(img[None]).shape == (1, 480, 480)
    for call in (lambda: pm.get_last_selfattention(img[None]),
                 lambda: pm.predict(img, parallelism="sp")):
        with pytest.raises(ValueError, match="ViT backbone"):
            call()


def test_dinoseg_cnn_fit_updates_running_stats(tmp_path):
    """A tiny frozen cnn1 fit: no feature cache (BatchNorm trains), the
    running stats move, the best checkpoint reloads with them."""
    from tests.test_torch_port_multiprocess import MemoryDINOSeg
    model = MemoryDINOSeg(data_path="in-memory", write_path=str(tmp_path),
                          backbone="cnn1", head="linear", n_classes=3,
                          batch_size=2, max_epochs=1, augmented=False,
                          train_resolution=64, random_init=True,
                          precision="fp32", device="cpu")
    assert model._cache_plan("auto", 2, 2) == (False, False)
    before = model.model.dino.bn1.running_mean.clone()
    metrics = model.fit(samples_per_epoch=4)
    assert np.isfinite(metrics["test_acc"])
    ck = DINOSeg.load_from_checkpoint(str(tmp_path / "1_linear_frozen.ckpt.npz"),
                                      device="cpu")
    assert ck.backbone == "cnn1"
    assert not torch.equal(ck.model.dino.bn1.running_mean, before)
    evaluated = model.evaluate("in-memory")
    assert evaluated["test_support"] == metrics["test_support"]
    assert os.path.exists(tmp_path / "1_linear_frozen.ckpt.npz")


class _ReluRecord:
    """torch.relu recording each call's mask (x > 0) or replaying recorded
    masks in call order."""

    def __init__(self, replay=None):
        self.masks, self.replay, self.flips = [], replay, 0

    def __enter__(self):
        self.real, self.calls = torch.relu, iter(self.replay or ())

        def relu(x):
            own = x > 0
            if self.replay is None:
                self.masks.append(own)
                return self.real(x)
            mask = next(self.calls)
            self.flips += int((mask != own).sum())
            return x * mask.to(x.dtype)
        torch.relu = relu
        return self

    def __exit__(self, *exc):
        torch.relu = self.real


def test_cpu_step_gradients_against_float64(record_property):
    """The cnn1 train-mode step's float32 gradients on the CPU against the
    same step in float64, with float64's ReLU choices replayed: a unit at
    0 within rounding takes either side, and train-mode BatchNorm's
    backward carries a flip far, so without the replay two float32 runs
    of one step are no yardstick for each other.  The port's conv route
    (PyTorch's im2col + GEMM, oneDNN off) holds each leaf within 1e-4 of
    its max (or of 1e-3 of the largest gradient: the last block's bn2.bias
    gradient vanishes exactly).  Recorded for both routes, the port's and
    oneDNN's: the features' error against float64, the ReLU units that
    flip, and the worst leaf with the choices replayed."""
    from dino_tpu_torch.models.heads import init_head
    from dino_tpu_torch.ops.preprocess import normalize_imagenet
    from dino_tpu_torch.train.loop import nll_loss
    gen = torch.Generator().manual_seed(3)
    net = tr.init_resnet_params(tr.ResNetBackbone("cnn1"), gen)
    head = init_head("mlp", N_CLASSES, 512, generator=gen)
    images, labels = _batch(4)
    y = torch.from_numpy(labels).reshape(-1)

    def step(dtype, relu, conv2d=tr.conv2d):
        m, h = (copy.deepcopy(net).to(dtype), copy.deepcopy(head).to(dtype))
        x = normalize_imagenet(torch.from_numpy(images)).to(dtype)
        saved, tr.conv2d = tr.conv2d, conv2d
        try:
            with relu:
                feats = tr.resnet_features(m, x, {})
                z = torch.relu(feats @ h.layer_1.weight.t() + h.layer_1.bias)
                z = torch.relu(z @ h.layer_2.weight.t() + h.layer_2.bias)
                logp = torch.log_softmax(
                    z @ h.layer_3.weight.t() + h.layer_3.bias, dim=-1)
                nll_loss(logp, y).backward()
        finally:
            tr.conv2d = saved
        return feats.detach().double(), {
            k: p.grad.double() for k, p in m.named_parameters()}

    def onednn_conv(x, w, stride=1, padding=0):
        return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)

    rec = _ReluRecord()
    ref_feats, ref = step(torch.float64, rec)
    floor = 1e-3 * max(g.abs().max().item() for g in ref.values())

    def worst(got):
        return max(((got[k] - g).abs().max().item()
                    / max(g.abs().max().item(), floor))
                   for k, g in ref.items())

    out = {}
    for name, conv in (("port", tr.conv2d), ("onednn", onednn_conv)):
        own = _ReluRecord()
        feats, _ = step(torch.float32, own, conv)
        out[name + "_features_err"] = ((feats - ref_feats).abs().max()
                                       / ref_feats.abs().max()).item()
        out[name + "_relu_flips"] = sum(int((a != b).sum()) for a, b in
                                        zip(own.masks, rec.masks))
        out[name + "_worst_leaf_replayed"] = worst(
            step(torch.float32, _ReluRecord(rec.masks), conv)[1])
    for k, v in out.items():
        record_property(k, v)
    assert out["port_worst_leaf_replayed"] < 1e-4
