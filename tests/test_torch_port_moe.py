"""The MoE head (ROADMAP item 8.2): dino_tpu_torch.models.heads' router,
dense and sparse dispatch, balance loss and statistics, and the MoE train
steps (monolithic, accumulated, cached-feature, sequence-parallel) against
dino_tpu's on carried weights, on the CPU.  Follows tests/test_moe.py and
tests/test_heads.py.

Heads: D=32 features, 5 classes, 4 experts, 50 patches.  Train steps: the
small ViT of tests/test_torch_port_train.py (D=128, 2 heads of hd=64, depth
2, 48px, 36 patches), MoE head, 3 classes, batch 4 with a ragged-tail mask.
The SP step runs in a world of two gloo processes that import neither jax
nor dino_tpu (tests/test_torch_port_multiprocess.py's spawn).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tpu.models import heads as jheads
from dino_tpu.models import vit as jvit
from dino_tpu.train import loop as jloop
from dino_tpu.train import metrics as jmetrics
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.checkpointing.convert import (from_jax_params,
                                                  head_params_of,
                                                  head_state_dict,
                                                  strip_prefix, to_jax_params)
from dino_tpu_torch.models import heads as theads
from dino_tpu_torch.models import vit as tvit
from dino_tpu_torch.parallel import ring_attention as tring
from dino_tpu_torch.train import loop as tloop
from tests.test_torch_port_multiprocess import spawn_ranks, tiny_model

E, D_HEAD, C_HEAD, M = 4, 32, 5, 50
D, DEPTH, RES, N_CLASSES, BATCH = 128, 2, 48, 3, 4
N_PATCH = (RES // 8) ** 2
# head log-probs, float32 and bf16 experts alike: sums in another order
# (measured max |diff| 1.2e-7 in both dtypes, dense and sparse)
HEAD_TOL = dict(atol=1e-5, rtol=1e-5)
# tests/test_torch_port_train.py's one-step tolerances
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-7, rtol=1e-4)
# the SP step against the replicated one: every gradient against its
# leaf's max |g| (sums over two ranks in another order)
SP_GRAD_REL = 1e-4

JCFG = jvit.ViTConfig(patch_size=8, embed_dim=D, num_heads=2)
TCFG = tvit.ViTConfig(patch_size=8, embed_dim=D, num_heads=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_head(head_p, n_classes, dim):
    head = theads.MoEHead(n_classes, dim, E)
    head.load_state_dict(head_state_dict(head_p), strict=True)
    return head


@pytest.fixture(scope="module")
def heads():
    head_p = _np(jheads.init_head(jax.random.PRNGKey(0), "moe", C_HEAD,
                                  D_HEAD, n_experts=E))
    x = np.random.RandomState(0).randn(M, D_HEAD).astype(np.float32)
    return head_p, _port_head(head_p, C_HEAD, D_HEAD), x


def test_init_shapes_and_router_init():
    head = theads.init_head("moe", 7, 384, torch.Generator().manual_seed(0),
                            n_experts=E)
    assert head.layer_1.weight.shape == (E, 384, 200)
    assert head.layer_1.bias.shape == (E, 200)
    assert head.layer_3.weight.shape == (E, 100, 7)
    assert head.router.weight.shape == (E, 384)
    assert not head.router.bias.any()
    assert 0.015 < head.router.weight.std().item() < 0.025
    bound = 1 / np.sqrt(384)
    assert head.layer_1.weight.abs().max().item() <= bound
    assert head.layer_1.bias.abs().max().item() <= bound


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_dino_tpu(heads, dispatch, dtype, record_property):
    head_p, head, x = heads
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_allclose(theads.moe_gate(head, xt).detach().numpy(),
                               np.asarray(jheads.moe_gate(head_p, xj)),
                               **HEAD_TOL)
    ref = np.asarray(jheads.head_apply("moe", head_p, xj,
                                       moe_dispatch=dispatch,
                                       moe_capacity=1.25))
    with torch.no_grad():
        out = theads.head_apply("moe", head, xt, dispatch, 1.25).numpy()
    assert out.dtype == np.float32 and out.shape == (M, C_HEAD)
    np.testing.assert_allclose(np.exp(out).sum(-1), 1.0, atol=1e-5)
    record_property("max_abs_diff", float(np.abs(out - ref).max()))
    np.testing.assert_allclose(out, ref, **HEAD_TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_balance_loss_and_stats_match_dino_tpu(heads, weighted):
    head_p, head, x = heads
    w = ((np.arange(M) % 3) != 0).astype(np.float32) if weighted else None
    wj = None if w is None else jnp.asarray(w)
    wt = None if w is None else torch.from_numpy(w)
    xt = torch.from_numpy(x)
    loss = theads.moe_balance_loss(head, xt, wt)
    np.testing.assert_allclose(loss.item(), float(jheads.moe_balance_loss(
        head_p, jnp.asarray(x), wj)), rtol=1e-6)
    assert 1.0 <= loss.item() <= E  # minimized (=1) at uniform routing
    for a, b in zip(theads.moe_balance_stats(head, xt, wt),
                    jheads.moe_balance_stats(head_p, jnp.asarray(x), wj)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6,
                                   atol=1e-6)
    # the gradient reaches the router (through the mean gate probability)
    loss.backward()
    assert float(head.router.weight.grad.abs().max()) > 0
    head.zero_grad(set_to_none=True)


def test_single_expert_reduces_to_mlp():
    """With E=1 the gate is 1 and the MoE head is the MLP head on the same
    weights."""
    moe = theads.init_head("moe", 5, 32, torch.Generator().manual_seed(1),
                           n_experts=1)
    mlp = theads.MLPHead(5, 32)
    with torch.no_grad():
        for name in ("layer_1", "layer_2", "layer_3"):
            getattr(mlp, name).weight.copy_(getattr(moe, name).weight[0].t())
            getattr(mlp, name).bias.copy_(getattr(moe, name).bias[0])
        x = torch.randn(20, 32, generator=torch.Generator().manual_seed(2))
        torch.testing.assert_close(theads.moe_head_apply(moe, x),
                                   theads.mlp_head_apply(mlp, x))


def test_sparse_equals_dense_when_capacity_ample(heads):
    _, head, x = heads
    xt = torch.from_numpy(x)
    with torch.no_grad():
        dense = theads.moe_head_apply(head, xt)
        for cf in (float(E), 8.0):
            assert torch.equal(theads.moe_head_apply_sparse(head, xt, cf),
                               dense)


def test_sparse_overflow_gives_uniform(heads):
    """Capacity 1 per expert: at most E patches keep their logits, every
    other patch predicts the uniform distribution."""
    _, head, x = heads
    with torch.no_grad():
        out = theads.moe_head_apply_sparse(head, torch.from_numpy(x),
                                           capacity_factor=E / M)
    uniform = torch.allclose(out, torch.full_like(out, -np.log(C_HEAD)),
                             atol=1e-6)
    assert not uniform
    rows = (out - out[:, :1]).abs().max(-1).values < 1e-6
    assert int((~rows).sum()) <= E and int(rows.sum()) >= M - E


def test_sparse_capacity_follows_batch_order(heads):
    """The first patches routed to an expert claim its slots: with all
    patches on one expert and capacity c, patches 0..c-1 keep their
    logits and the rest are uniform."""
    _, head, x = heads
    routed = theads.MoEHead(C_HEAD, D_HEAD, E)
    routed.load_state_dict(head.state_dict())
    with torch.no_grad():
        routed.router.weight.zero_()
        routed.router.bias.copy_(torch.tensor([0.0, 5.0, 0.0, 0.0]))
        cap = theads.moe_capacity_of(M, E, 1.25)
        out = theads.moe_head_apply_sparse(routed, torch.from_numpy(x), 1.25)
        dense = theads.moe_head_apply(routed, torch.from_numpy(x))
    assert cap == 16
    assert torch.equal(out[:cap], dense[:cap])
    torch.testing.assert_close(out[cap:], torch.full_like(
        out[cap:], -float(np.log(C_HEAD))))


def test_convert_round_trip(heads):
    head_p, head, _ = heads
    back = head_params_of(head.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(head_p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(head_p)):
        np.testing.assert_array_equal(a, b)
    assert back["layer_1"]["kernel"].shape == (E, D_HEAD, 200)


def test_checkpoints_cross_packages(tmp_path):
    """A dino_tpu MoE checkpoint (.npz) loads in the port with its experts,
    router and options, and the port's save loads back in dino_tpu."""
    from dino_tpu.api import DINOSeg as JaxDINOSeg
    jm = JaxDINOSeg(head="moe", n_experts=E, moe_dispatch="sparse",
                    moe_capacity=2.0, n_blocks=1, n_classes=3,
                    random_init=True, precision="fp32", seed=2)
    path = str(tmp_path / "jax_moe.ckpt.npz")
    jm.save(path)
    pm = DINOSeg.load_from_checkpoint(path, device="cpu")
    assert (pm.head, pm.n_experts, pm.moe_dispatch, pm.moe_capacity) == (
        "moe", E, "sparse", 2.0)
    _, head_p = to_jax_params(pm.model.state_dict())
    _assert_trees_close(head_p, _np(jm.head_params), atol=0, rtol=0)
    back = str(tmp_path / "port_moe.ckpt.npz")
    pm.save(back)
    jm2 = JaxDINOSeg.load_from_checkpoint(back)
    _assert_trees_close(_np(jm2.head_params), _np(jm.head_params), atol=0,
                        rtol=0)
    _assert_trees_close(_np(jm2.vit_params), _np(jm.vit_params), atol=0,
                        rtol=0)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    vit_p = _np(jvit.init_vit_params(jax.random.PRNGKey(0), JCFG,
                                     depth=DEPTH))
    head_p = _np(jheads.init_head(jax.random.PRNGKey(1), "moe", N_CLASSES,
                                  D, n_experts=E))
    rs = np.random.RandomState(0)
    images = rs.randint(0, 255, (BATCH, RES, RES, 3)).astype(np.uint8)
    labels = rs.randint(0, N_CLASSES, (BATCH, N_PATCH)).astype(np.int32)
    mask = np.array([1, 1, 1, 0], np.float32)  # ragged tail
    return vit_p, head_p, images, labels, mask


def _port_modules(vit_p, head_p):
    sd = from_jax_params(vit_p, head_p)
    vit = tvit.VisionTransformer(TCFG, depth=DEPTH)
    vit.load_state_dict(strip_prefix(sd, "dino."), strict=True)
    head = theads.MoEHead(N_CLASSES, D, E)
    head.load_state_dict(strip_prefix(sd, "clf."), strict=True)
    return vit, head


def _grads(vit, head):
    sd = {"dino." + k: (torch.zeros_like(p) if p.grad is None else p.grad)
          for k, p in vit.named_parameters()}
    sd.update({"clf." + k: p.grad for k, p in head.named_parameters()})
    return to_jax_params(sd)


def _assert_trees_close(got, want, **tol):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                    strict=True):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _port_step(setup, frozen, **kw):
    vit_p, head_p, images, labels, mask = setup
    vit, head = _port_modules(vit_p, head_p)
    vit.requires_grad_(not frozen)
    opt = tloop.make_optimizer("sgd", 0.0)  # leaves the params as they are
    step = tloop.make_train_step(TCFG, "moe", N_CLASSES, opt, frozen, **kw)
    loss, cm = step(vit, head, tloop.init_opt_state(opt, vit, head, frozen),
                    torch.from_numpy(images), torch.from_numpy(labels),
                    torch.from_numpy(mask))
    return vit, head, loss, cm


@pytest.mark.parametrize("frozen", [True, False])
def test_one_step_matches_dino_tpu(setup, frozen):
    """Loss (nll + 0.01 x balance over the real patches), confusion matrix
    and gradients of one step against jax.value_and_grad of dino_tpu's."""
    vit_p, head_p, images, labels, mask = setup
    y = labels.reshape(-1)
    w = jnp.repeat(jnp.asarray(mask), N_PATCH)

    def jloss(trainable):
        vp = vit_p if frozen else trainable["vit"]
        sink = {}
        logp = jloop.seg_forward(vp, trainable["head"], JCFG, "moe", images,
                                 use_flash=False, feat_sink=sink)
        loss = jloop.nll_loss(logp, y, w) + 0.01 * jheads.moe_balance_loss(
            trainable["head"], sink["feats"], weights=w)
        return loss, logp

    trainable = {"head": head_p} if frozen else {"head": head_p, "vit": vit_p}
    (jl, jlogp), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        trainable)
    jcm = jmetrics.confusion_matrix(jnp.argmax(jlogp, axis=-1), y, N_CLASSES,
                                    weights=w)
    vit, head, loss, cm = _port_step(setup, frozen)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    grad_vit, grad_head = _grads(vit, head)
    _assert_trees_close(grad_head, jg["head"], **GRAD_TOL)
    if frozen:
        assert all(p.grad is None for p in vit.parameters())
    else:
        _assert_trees_close(grad_vit, jg["vit"], **GRAD_TOL)


def test_accum_two_equals_monolithic(setup):
    """accum_steps=2: the stats pass's full-batch routing fractions make
    the accumulated loss and gradients the monolithic step's."""
    *_, mono_loss, mono_cm = _port_step(setup, False)
    vit_m, head_m, _, _ = _port_step(setup, False)
    vit_a, head_a, acc_loss, acc_cm = _port_step(setup, False,
                                                 accum_steps=2)
    np.testing.assert_allclose(float(acc_loss), float(mono_loss),
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(acc_cm.numpy(), mono_cm.numpy())
    _assert_trees_close(_grads(vit_a, head_a), _grads(vit_m, head_m),
                        **GRAD_TOL)


def test_accum_matches_dino_tpu_accum(setup):
    """Three Adam steps with accum_steps=2 against dino_tpu's."""
    vit_p, head_p, images, labels, mask = setup
    jopt = jloop.make_optimizer("adam", 1e-4)
    jstep = jloop.make_train_step(JCFG, "moe", N_CLASSES, jopt, False,
                                  donate=False, accum_steps=2)
    vp, hp = vit_p, head_p
    state = jloop.init_opt_state(jopt, vp, hp, False)
    vit, head = _port_modules(vit_p, head_p)
    topt = tloop.make_optimizer("adam", 1e-4)
    opt_state = tloop.init_opt_state(topt, vit, head, False)
    tstep = tloop.make_train_step(TCFG, "moe", N_CLASSES, topt, False,
                                  accum_steps=2)
    for _ in range(3):
        vp, hp, state, jl, _ = jstep(vp, hp, state, images, labels, mask)
        loss, _ = tstep(vit, head, opt_state, torch.from_numpy(images),
                        torch.from_numpy(labels), torch.from_numpy(mask))
        np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    got_v, got_h = to_jax_params(
        {**{"dino." + k: v for k, v in vit.state_dict().items()},
         **{"clf." + k: v for k, v in head.state_dict().items()}})
    _assert_trees_close(got_h, _np(hp), atol=1e-5, rtol=1e-4)
    _assert_trees_close(got_v, _np(vp), atol=1e-5, rtol=1e-4)


def test_cached_head_step_matches_dino_tpu(setup):
    """The cached-feature head step with the MoE head (balance term over
    the masked patches) against dino_tpu's, sparse dispatch."""
    _, head_p, _, _, _ = setup
    rs = np.random.RandomState(3)
    feats = rs.randn(6, N_PATCH, D).astype(np.float32)
    labels = rs.randint(0, N_CLASSES, (6, N_PATCH)).astype(np.int32)
    ids = np.array([4, 0, 2, 5], np.int64)
    mask = np.array([1, 1, 0, 1], np.float32)
    kw = dict(moe_dispatch="sparse", moe_capacity=1.25)
    jopt = jloop.make_optimizer("adam", 1e-3)
    jstep = jloop.make_cached_head_train_step("moe", N_CLASSES, jopt,
                                              donate=False, **kw)
    hp, _, jl, jcm = jstep(head_p, jopt.init({"head": head_p}), feats,
                           labels, ids, mask)
    _, head = _port_modules(setup[0], head_p)
    topt = tloop.make_optimizer("adam", 1e-3)
    tstep = tloop.make_cached_head_train_step("moe", N_CLASSES, topt, **kw)
    loss, cm = tstep(head, topt(head.parameters()), torch.from_numpy(feats),
                     torch.from_numpy(labels), torch.from_numpy(ids),
                     torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    _assert_trees_close(head_params_of(head.state_dict()), _np(hp),
                        atol=1e-5, rtol=1e-4)
    ev = tloop.make_cached_head_eval_step("moe", N_CLASSES, **kw)
    jev = jloop.make_cached_head_eval_step("moe", N_CLASSES, **kw)
    np.testing.assert_array_equal(
        ev(head, torch.from_numpy(feats), torch.from_numpy(labels)).numpy(),
        np.asarray(jev(hp, feats, labels)))


def test_sparse_guards():
    opt = tloop.make_optimizer("adam", 1e-3)
    with pytest.raises(ValueError, match="sparse"):
        tloop.make_train_step(TCFG, "moe", 3, opt, False, accum_steps=2,
                              moe_dispatch="sparse")
    with pytest.raises(ValueError, match="sparse"):
        tring.make_sp_train_step(TCFG, "moe", 3, opt, moe_dispatch="sparse")
    with pytest.raises(ValueError, match="moe_dispatch"):
        DINOSeg(head="moe", moe_dispatch="topk", random_init=True,
                device="cpu")


# ---------------------------------------------------------------------------
# SP: the balance statistics summed over a world of two
# ---------------------------------------------------------------------------

_SP_RANK = """
import json, sys
import numpy as np
import torch
cfg = json.loads(sys.argv[1])
from dino_tpu_torch.checkpointing.convert import strip_prefix
from dino_tpu_torch.models.heads import MoEHead
from dino_tpu_torch.models.vit import ViTConfig, VisionTransformer
from dino_tpu_torch.parallel import dist as pd
from dino_tpu_torch.parallel.ring_attention import make_sp_train_step
from dino_tpu_torch.train.loop import init_opt_state, make_optimizer
assert not any(m in ("jax", "dino_tpu") or m.startswith(("jax.", "dino_tpu."))
               for m in sys.modules)
pd.init_distributed_mode("gloo", cfg["init"], cfg["world"], cfg["rank"])
z = {k: torch.from_numpy(v) for k, v in np.load(cfg["inputs"]).items()}
sd = {k[3:]: v for k, v in z.items() if k.startswith("sd.")}
tcfg = ViTConfig(patch_size=8, embed_dim=cfg["d"], num_heads=2)
vit = VisionTransformer(tcfg, depth=cfg["depth"])
vit.load_state_dict(strip_prefix(sd, "dino."), strict=True)
head = MoEHead(cfg["n_classes"], cfg["d"], cfg["e"])
head.load_state_dict(strip_prefix(sd, "clf."), strict=True)
opt = make_optimizer("sgd", 0.0)
step = make_sp_train_step(tcfg, "moe", cfg["n_classes"], opt)
loss, cm = step(vit, head, init_opt_state(opt, vit, head, False),
                z["images"], z["labels"], z["mask"])
out = {"loss": loss.numpy(), "cm": cm.numpy()}
for prefix, mod in (("dino.", vit), ("clf.", head)):
    for k, p in mod.named_parameters():
        out[prefix + k] = p.grad.numpy()
np.savez(cfg["out"] + ".npz", **out)
"""


def test_sp_step_matches_replicated(setup, tmp_path):
    vit_p, head_p, images, labels, mask = setup
    arrays = {"sd." + k: v.numpy()
              for k, v in from_jax_params(vit_p, head_p).items()}
    arrays.update(images=images, labels=labels, mask=mask)
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, **arrays)
    outs = spawn_ranks(tmp_path, 2, _SP_RANK,
                       dict(inputs=inputs, d=D, depth=DEPTH, e=E,
                            n_classes=N_CLASSES), tag="sp_moe")
    ranks = [dict(np.load(o + ".npz")) for o in outs]
    vit, head, loss, cm = _port_step(setup, False)
    want = {"dino." + k: p.grad.numpy() for k, p in vit.named_parameters()}
    want.update({"clf." + k: p.grad.numpy()
                 for k, p in head.named_parameters()})
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), float(loss),
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(r["cm"], cm.numpy())
        for k, g in want.items():
            rel = np.abs(r[k] - g).max() / max(np.abs(g).max(), 1e-30)
            assert rel < SP_GRAD_REL, (k, rel)
    np.testing.assert_array_equal(ranks[0]["clf.router.weight"],
                                  ranks[1]["clf.router.weight"])


# ---------------------------------------------------------------------------
# DINOSeg(head='moe'): fit, checkpoint, predict
# ---------------------------------------------------------------------------

def test_fit_loss_falls_and_checkpoint_round_trip(tmp_path):
    model = tiny_model(str(tmp_path))
    model = type(model)(data_path="in-memory", write_path=str(tmp_path),
                        head="moe", n_experts=E, moe_dispatch="sparse",
                        moe_capacity=2.0, n_blocks=1, n_classes=3,
                        batch_size=2, max_epochs=3, lr=1e-2,
                        optimizer="adam", augmented=False,
                        train_resolution=64, random_init=True,
                        precision="fp32", device="cpu", logger=_Log())
    model.fit(samples_per_epoch=8, cache_features=False)
    losses = [m["train_loss"] for s, m in model.logger.metrics if s >= 0]
    assert len(losses) == 3 and losses[-1] < losses[0]
    ck = str(tmp_path / "1_moe_frozen.ckpt.npz")
    loaded = DINOSeg.load_from_checkpoint(ck, device="cpu")
    assert (loaded.head, loaded.n_experts, loaded.moe_dispatch,
            loaded.moe_capacity) == ("moe", E, "sparse", 2.0)
    img = np.random.RandomState(1).randint(0, 255, (64, 64, 3), np.uint8)
    loaded.set_resolution(64)
    model.set_resolution(64)
    best = DINOSeg(head="moe", n_experts=E, moe_dispatch="sparse",
                   moe_capacity=2.0, n_blocks=1, n_classes=3,
                   random_init=True, precision="fp32", device="cpu")
    best.load_state_dict(loaded.model.state_dict())
    best.set_resolution(64)
    np.testing.assert_array_equal(loaded.predict(img), best.predict(img))
    assert json.loads(json.dumps(loaded.hparams))["head"] == "moe"


class _Log:
    def __init__(self):
        self.metrics = []

    def log_metrics(self, metrics, step):
        self.metrics.append((step, dict(metrics)))
