"""The train slice: dino_tpu_torch's train step, eval step, feature function
and metrics vs dino_tpu's on carried weights, on the CPU.

A small ViT (D=128, 2 heads of hd=64 as the kernels take, depth 2) at 48px
(36 patches), MLP head, 3 classes, batch 4 with a ragged-tail mask; weights
from one JAX init carried to the port with from_jax_params.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tpu.models import vit as jvit
from dino_tpu.models.heads import init_head as jinit_head
from dino_tpu.ops import fused_mlp as jfm
from dino_tpu.train import loop as jloop
from dino_tpu.train import metrics as jmetrics
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.checkpointing.convert import (from_jax_params,
                                                  strip_prefix, to_jax_params)
from dino_tpu_torch.models import heads as theads
from dino_tpu_torch.models import vit as tvit
from dino_tpu_torch.ops import fused_mlp as tfm
from dino_tpu_torch.train import loop as tloop
from dino_tpu_torch.train import metrics as tmetrics

D, DEPTH, RES, N_CLASSES, BATCH = 128, 2, 48, 3, 4
N_PATCH = (RES // 8) ** 2
# tests/test_train_smoke.py:284-325, the JAX package's own accum test
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
# one-step gradients: float32 sums in another order on the two sides
# (measured max |diff| ~1e-8 against gradients of 1e-5 .. 5e-2)
GRAD_TOL = dict(atol=1e-7, rtol=1e-4)
# finetune learning rates; Adam's update of a gradient within a few eps of
# 0 is sensitive to its last bits, so lr bounds how far those entries drift
LRS = {"adam": 1e-4, "adamw": 1e-4, "sgd": 0.1}

JCFG = jvit.ViTConfig(patch_size=8, embed_dim=D, num_heads=2)
TCFG = tvit.ViTConfig(patch_size=8, embed_dim=D, num_heads=2)


@pytest.fixture(scope="module")
def setup():
    vit_p = jax.tree.map(np.asarray, jvit.init_vit_params(
        jax.random.PRNGKey(0), JCFG, depth=DEPTH))
    head_p = jax.tree.map(np.asarray, jinit_head(jax.random.PRNGKey(1), "mlp",
                                                 N_CLASSES, D))
    rs = np.random.RandomState(0)
    images = rs.randint(0, 255, (BATCH, RES, RES, 3)).astype(np.uint8)
    labels = rs.randint(0, N_CLASSES, (BATCH, N_PATCH)).astype(np.int32)
    mask = np.array([1, 1, 1, 0], np.float32)  # ragged tail
    return vit_p, head_p, images, labels, mask


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_modules(vit_p, head_p):
    sd = from_jax_params(vit_p, head_p)
    vit = tvit.VisionTransformer(TCFG, depth=DEPTH)
    vit.load_state_dict(strip_prefix(sd, "dino."), strict=True)
    head = theads.MLPHead(N_CLASSES, D)
    head.load_state_dict(strip_prefix(sd, "clf."), strict=True)
    return vit, head


def _jax_layout(vit, head, attr=None):
    """The port's parameters (or their ``.grad``) as dino_tpu pytrees."""
    def get(p):
        t = p if attr is None else getattr(p, attr)
        return torch.zeros_like(p) if t is None else t.detach()
    sd = {"dino." + k: get(p) for k, p in vit.named_parameters()}
    sd.update({"clf." + k: get(p) for k, p in head.named_parameters()})
    return to_jax_params(sd)


def _assert_trees_close(got, want, **tol):
    g_leaves, w_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for a, b in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _run_port_step(vit, head, setup, frozen, **kw):
    _, _, images, labels, mask = setup
    opt = tloop.make_optimizer("sgd", 0.0)  # leaves the params as they are
    step = tloop.make_train_step(TCFG, "mlp", N_CLASSES, opt, frozen, **kw)
    return step(vit, head, tloop.init_opt_state(opt, vit, head, frozen),
                _t(images), _t(labels), _t(mask))


# ---------------------------------------------------------------------------
# the train step against dino_tpu's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frozen", [False, True])
def test_one_step_loss_cm_and_grads_match_jax(setup, frozen):
    vit_p, head_p, images, labels, mask = setup
    y = labels.reshape(-1)
    w = jnp.repeat(jnp.asarray(mask), N_PATCH)

    def jloss(trainable):
        vp = vit_p if frozen else trainable["vit"]
        logp = jloop.seg_forward(vp, trainable["head"], JCFG, "mlp", images)
        return jloop.nll_loss(logp, y, w), logp

    trainable = {"head": head_p} if frozen else {"head": head_p, "vit": vit_p}
    (jl, jlogp), jg = jax.value_and_grad(jloss, has_aux=True)(trainable)
    jcm = jmetrics.confusion_matrix(jnp.argmax(jlogp, axis=-1), y, N_CLASSES,
                                    weights=w)
    vit, head = _port_modules(vit_p, head_p)
    loss, cm = _run_port_step(vit, head, setup, frozen)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    grad_vit, grad_head = _jax_layout(vit, head, "grad")
    _assert_trees_close(grad_head, jg["head"], **GRAD_TOL)
    if frozen:
        assert all(p.grad is None for p in vit.parameters())
    else:
        _assert_trees_close(grad_vit, jg["vit"], **GRAD_TOL)


@pytest.mark.parametrize("accum", [1, 2, 4])
@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_three_steps_match_jax(setup, name, frozen, accum):
    vit_p, head_p, images, labels, mask = setup
    jopt = jloop.make_optimizer(name, LRS[name])
    jstep = jloop.make_train_step(JCFG, "mlp", N_CLASSES, jopt, frozen,
                                  donate=False, accum_steps=accum)
    vp, hp = vit_p, head_p
    state = jloop.init_opt_state(jopt, vp, hp, frozen)
    vit, head = _port_modules(vit_p, head_p)
    topt = tloop.make_optimizer(name, LRS[name])
    opt_state = tloop.init_opt_state(topt, vit, head, frozen)
    tstep = tloop.make_train_step(TCFG, "mlp", N_CLASSES, topt, frozen,
                                  accum_steps=accum)
    for _ in range(3):
        vp, hp, state, jl, jcm = jstep(vp, hp, state, images, labels, mask)
        loss, cm = tstep(vit, head, opt_state, _t(images), _t(labels),
                         _t(mask))
        np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
        np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    got_vit, got_head = _jax_layout(vit, head)
    _assert_trees_close(got_head, hp, **PARAM_TOL)
    _assert_trees_close(got_vit, vp, **PARAM_TOL)
    # the steps moved what they train, far beyond the tolerance
    moved = max(np.abs(a - b).max() for a, b in
                zip(jax.tree.leaves(got_head), jax.tree.leaves(head_p)))
    assert moved > 20 * PARAM_TOL["atol"]
    if frozen:
        for a, b in zip(jax.tree.leaves(got_vit), jax.tree.leaves(vit_p)):
            np.testing.assert_array_equal(a, b)


def test_bf16_step_matches_jax_at_bf16_level(setup):
    """The unfrozen bf16 step on the CPU: flash backward and the MLP
    composition under autograd, loss within bf16 rounding of dino_tpu's and
    a finite gradient on every backbone parameter."""
    vit_p, head_p, images, labels, mask = setup
    jopt = jloop.make_optimizer("adam", 1e-4)
    jstep = jloop.make_train_step(JCFG, "mlp", N_CLASSES, jopt, False,
                                  donate=False, compute_dtype=jnp.bfloat16,
                                  accum_steps=2)
    jl = jstep(vit_p, head_p, jloop.init_opt_state(jopt, vit_p, head_p, False),
               images, labels, mask)[3]
    vit, head = _port_modules(vit_p, head_p)
    loss, _ = _run_port_step(vit, head, setup, False,
                             compute_dtype=torch.bfloat16, accum_steps=2)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-2)
    for p in vit.parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())
        assert p.grad.dtype == torch.float32


# bf16 gradients: each side's worst leaf distance from its own fp32
# gradient, max |g_bf16 - g_fp32| / max |g_fp32| over a leaf, must be within
# this factor of the other side's (measured: the port 0.200, dino_tpu 0.212,
# both at pos_embed).  Two-sided: a port bf16 backward that rounds less than
# dino_tpu's sits closer to fp32 and is as wrong as one that rounds more.
BF16_GRAD_FACTOR = 1.25


def _worst_leaf(got, ref):
    """(worst max|got - ref| / max|ref| over the leaves, its leaf path)."""
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_r = jax.tree.leaves(ref)
    dist = {jax.tree_util.keystr(k): float(
        np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
        / max(float(np.abs(np.asarray(b)).max()), 1e-30))
        for (k, a), b in zip(flat_g, flat_r)}
    leaf = max(dist, key=dist.get)
    return dist[leaf], leaf


def test_bf16_gradients_as_far_from_fp32_as_jax(setup):
    """One unfrozen step at bf16 and at fp32 on each side: the port's bf16
    gradients stand as far from its fp32 gradients as dino_tpu's bf16
    gradients stand from its own, within BF16_GRAD_FACTOR either way."""
    vit_p, head_p, images, labels, mask = setup
    y = labels.reshape(-1)
    w = jnp.repeat(jnp.asarray(mask), N_PATCH)

    def jgrads(cdt):
        def loss(t):
            logp = jloop.seg_forward(t["vit"], t["head"], JCFG, "mlp",
                                     images, compute_dtype=cdt)
            return jloop.nll_loss(logp, y, w)
        g = jax.jit(jax.grad(loss))({"vit": vit_p, "head": head_p})
        return (g["vit"], g["head"])

    def tgrads(cdt):
        vit, head = _port_modules(vit_p, head_p)
        _run_port_step(vit, head, setup, False, compute_dtype=cdt)
        return _jax_layout(vit, head, "grad")

    jax_worst, jax_leaf = _worst_leaf(jgrads(jnp.bfloat16), jgrads(None))
    port_worst, port_leaf = _worst_leaf(tgrads(torch.bfloat16),
                                        tgrads(None))
    print(f"bf16 vs fp32 worst leaf: port {port_worst:.4f} ({port_leaf}), "
          f"dino_tpu {jax_worst:.4f} ({jax_leaf})")
    assert jax_worst / BF16_GRAD_FACTOR <= port_worst
    assert port_worst <= jax_worst * BF16_GRAD_FACTOR


def test_remat_gives_the_same_gradients(setup, monkeypatch):
    """REMAT_TOKENS=0 makes every unfrozen batch recompute its blocks in
    the backward pass; the gradients stay the same bits."""
    calls = []
    checkpoint = torch.utils.checkpoint.checkpoint

    def counting(*args, **kw):
        calls.append(1)
        return checkpoint(*args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    grads = []
    for threshold in (tloop.REMAT_TOKENS, 0):
        monkeypatch.setattr(tloop, "REMAT_TOKENS", threshold)
        vit, head = _port_modules(*setup[:2])
        _run_port_step(vit, head, setup, False)
        grads.append([p.grad for p in (*vit.parameters(),
                                       *head.parameters())])
    assert len(calls) == DEPTH  # only the second step rematerialized
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_nll_loss_mask_gives_padded_rows_zero_gradient():
    rs = np.random.RandomState(3)
    logits = rs.randn(12, N_CLASSES).astype(np.float32)
    y = rs.randint(0, N_CLASSES, 12)
    w = np.repeat(np.array([1, 1, 0], np.float32), 4)
    logp = torch.log_softmax(_t(logits), dim=-1).requires_grad_()
    loss = tloop.nll_loss(logp, _t(y), _t(w))
    loss.backward()
    assert bool((logp.grad[_t(w) == 0] == 0).all())
    assert bool((logp.grad[_t(w) == 1] != 0).any())
    jlogp = jax.nn.log_softmax(logits)
    np.testing.assert_allclose(loss.item(), float(jloop.nll_loss(jlogp, y, w)),
                               rtol=1e-6)
    np.testing.assert_allclose(tloop.nll_loss(logp, _t(y)).item(),
                               float(jloop.nll_loss(jlogp, y)), rtol=1e-6)


def test_eval_step_and_feature_fn_match_jax(setup):
    vit_p, head_p, images, labels, _ = setup
    vit, head = _port_modules(vit_p, head_p)
    cm = tloop.make_eval_step(TCFG, "mlp", N_CLASSES)(vit, head, _t(images),
                                                       _t(labels))
    jcm = jloop.make_eval_step(JCFG, "mlp", N_CLASSES)(vit_p, head_p, images,
                                                       labels)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    feats = tloop.make_feature_fn(TCFG)(vit, _t(images))
    assert feats.shape == (BATCH, N_PATCH, D) and not feats.requires_grad
    np.testing.assert_allclose(
        feats.numpy(), np.asarray(jloop.make_feature_fn(JCFG)(vit_p, images)),
        atol=2e-4, rtol=1e-4)  # tests/test_vit_parity.py:17-18


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(head_type="moe", moe_dispatch="sparse", accum_steps=2),
     ValueError, "sparse"),
    (dict(backbone="cnn1", accum_steps=2), ValueError, "BatchNorm"),
    (dict(zero_mesh=object()), TypeError, "process group"),
    (dict(fsdp_mesh=object()), TypeError, "process group"),
    (dict(zero_mesh=object(), fsdp_mesh=object()), ValueError,
     "mutually exclusive"),
    (dict(accum_steps=0), ValueError, "accum_steps"),
])
def test_make_train_step_rejects(kwargs, exc, match):
    args = dict(cfg=TCFG, head_type="mlp", n_classes=N_CLASSES,
                optimizer=tloop.make_optimizer("adam", 1e-3),
                freeze_backbone=False)
    args.update(kwargs)
    with pytest.raises(exc, match=match):
        tloop.make_train_step(**args)


def test_batch_must_divide_by_accum_steps(setup):
    vit, head = _port_modules(*setup[:2])
    with pytest.raises(ValueError, match="divide"):
        _run_port_step(vit, head, setup, False, accum_steps=3)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tloop.make_optimizer("lamb", 1e-3)


def test_optimizers_use_the_jax_packages_hyperparameters(setup):
    vit, head = _port_modules(*setup[:2])
    for name, cls in (("adam", torch.optim.Adam), ("adamw", torch.optim.AdamW),
                      ("sgd", torch.optim.SGD)):
        opt = tloop.init_opt_state(tloop.make_optimizer(name, 1e-3), vit,
                                   head, freeze_backbone=False)
        assert type(opt) is cls
        group = opt.param_groups[0]
        assert group["lr"] == 1e-3
        assert len(group["params"]) == len(list(vit.parameters())) + 6
        if name != "sgd":
            assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
            assert group["weight_decay"] == (0.01 if name == "adamw" else 0)
    frozen = tloop.init_opt_state(tloop.make_optimizer("adam", 1e-3), vit,
                                  head, freeze_backbone=True)
    assert len(frozen.param_groups[0]["params"]) == 6  # the head only


# ---------------------------------------------------------------------------
# the MLP under autograd, the converter, the metrics, the API
# ---------------------------------------------------------------------------

def test_fused_mlp_kernel_refuses_autograd():
    blk = tvit.Block(tvit.ViTConfig())
    x = torch.randn(4, 384).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        tfm.fused_ln_mlp_residual(blk.norm2, blk.mlp, x, 1e-6)
    blk.requires_grad_(False)
    with pytest.raises(RuntimeError, match="no backward"):
        tfm.fused_ln_mlp_residual(blk.norm2, blk.mlp,
                                  x.clone().requires_grad_(), 1e-6)
    out = tfm.fused_ln_mlp_residual(blk.norm2, blk.mlp, x, 1e-6)
    assert torch.equal(out, tfm.fused_ln_mlp_residual_plain(
        blk.norm2, blk.mlp, x, 1e-6))


@pytest.mark.parametrize("grad_mode,params_grad,x_grad,want", [
    (True, True, False, True),     # unfrozen training
    (True, False, True, True),     # gradient wanted for the input only
    (True, False, False, False),   # everything frozen
    (False, True, True, False),    # under torch.no_grad (predict, frozen)
])
def test_block_takes_the_fused_kernel_only_without_grad(grad_mode,
                                                        params_grad, x_grad,
                                                        want):
    blk = tvit.Block(tvit.ViTConfig()).requires_grad_(params_grad)
    x = torch.zeros(1, 5, 384, requires_grad=x_grad)
    with torch.set_grad_enabled(grad_mode):
        assert tvit._needs_grad(blk, x) is want


def test_block_under_grad_is_the_xla_reference_composition():
    """block_apply's MLP half under autograd: value and gradients equal the
    JAX custom_vjp's forward rule, _xla_reference (float32)."""
    rs = np.random.RandomState(9)
    blk = tvit.Block(tvit.ViTConfig(embed_dim=D, num_heads=2))
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.from_numpy(rs.randn(*p.shape).astype(np.float32)
                                     * 0.05))
    x = rs.randn(2, 7, D).astype(np.float32)
    xt = _t(x).requires_grad_()
    out = tvit.mlp_residual(blk.norm2, blk.mlp, xt, 1e-6)
    g = rs.randn(*out.shape).astype(np.float32)
    out.backward(_t(g))
    norm_p = {"scale": blk.norm2.weight.detach().numpy(),
              "bias": blk.norm2.bias.detach().numpy()}
    mlp_p = {n: {"kernel": lin.weight.detach().numpy().T,
                 "bias": lin.bias.detach().numpy()}
             for n, lin in (("fc1", blk.mlp.fc1), ("fc2", blk.mlp.fc2))}
    ref, vjp = jax.vjp(lambda n_, m_, x_: jfm._xla_reference(n_, m_, x_,
                                                             1e-6),
                       norm_p, mlp_p, x)
    d_norm, d_mlp, d_x = vjp(g)
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(d_x), **tol)
    np.testing.assert_allclose(blk.mlp.fc1.weight.grad.numpy().T,
                               np.asarray(d_mlp["fc1"]["kernel"]), **tol)
    np.testing.assert_allclose(blk.norm2.weight.grad.numpy(),
                               np.asarray(d_norm["scale"]), **tol)


def test_converter_carries_every_trainable_leaf(setup):
    vit_p, head_p = setup[:2]
    vit, head = _port_modules(vit_p, head_p)
    sd = from_jax_params(vit_p, head_p)
    names = ({"dino." + k for k, _ in vit.named_parameters()}
             | {"clf." + k for k, _ in head.named_parameters()})
    assert set(sd) == names
    assert len(jax.tree.leaves((vit_p, head_p))) == len(names)
    back_vit, back_head = to_jax_params(sd)
    for a, b in zip(jax.tree.leaves((back_vit, back_head)),
                    jax.tree.leaves((vit_p, head_p))):
        np.testing.assert_array_equal(a, b)


def test_metrics_match_dino_tpu():
    rs = np.random.RandomState(5)
    pred = rs.randint(0, 4, 500)
    gt = rs.randint(0, 3, 500)  # class 3 only predicted, class 4 absent
    w = (rs.rand(500) > 0.2).astype(np.float32)
    for weights in (None, w):
        cm = tmetrics.confusion_matrix(
            _t(pred), _t(gt), 5, None if weights is None else _t(weights))
        jcm = np.asarray(jmetrics.confusion_matrix(
            jnp.asarray(pred), jnp.asarray(gt), 5,
            weights=None if weights is None else jnp.asarray(weights)))
        np.testing.assert_array_equal(cm.numpy(), jcm)
        assert (tmetrics.segmentation_metrics(cm, "test")
                == jmetrics.segmentation_metrics(jcm, "test"))
        assert (tmetrics.per_class_metrics_from_cm(cm, "abcde")
                == jmetrics.per_class_metrics_from_cm(jcm, "abcde"))
    for cm in (jcm, np.zeros((3, 3), np.int64)):
        for fn in ("balanced_accuracy_from_cm", "macro_f1_from_cm",
                   "macro_jaccard_from_cm"):
            assert getattr(tmetrics, fn)(cm) == getattr(jmetrics, fn)(cm)


def test_freeze_and_unfreeze_backbone(tmp_path):
    model = DINOSeg(head="mlp", n_blocks=1, random_init=True, device="cpu")
    assert model.freeze_backbone and model.hparams["freeze_backbone"]
    assert not any(p.requires_grad for p in model.model.dino.parameters())
    model.unfreeze_bb()
    assert not model.freeze_backbone and not model.hparams["freeze_backbone"]
    assert all(p.requires_grad for p in model.model.dino.parameters())
    path = str(tmp_path / "unfrozen.npz")
    model.save(path)
    back = DINOSeg.load_from_checkpoint(path, device="cpu")
    assert back.freeze_backbone is False
    back.freeze_bb()
    assert back.freeze_backbone and back.hparams["freeze_backbone"]
    assert not any(p.requires_grad for p in back.model.dino.parameters())
