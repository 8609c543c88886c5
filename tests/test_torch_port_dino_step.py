"""The DINO pretraining step: dino_tpu_torch's against dino_tpu's on carried
weights, on the CPU.

A small configuration whose shapes the card's kernels also take: ViT
patch 8, embed 128, 2 heads (head dim 64), depth 2; the DINO head out_dim
32, hidden 64, bottleneck 16; 2 local crops, global 32 px and local 16 px;
batch 4.  One dino_tpu init is carried to the port (checkpointing/
convert.py:from_jax_dino) and both packages take 3 steps from it on the
same crops, made with numpy from a seed.  dino_tpu runs as its own tests
run it (XLA attention on the CPU under tests/conftest.py's highest matmul
precision); the port takes its kernels' plain versions.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dino_tpu.models import vit as jvit
from dino_tpu.ops.preprocess import normalize_imagenet as jnormalize
from dino_tpu.train import dino_pretrain as jdp
from dino_tpu.train.optim import get_params_groups as jget_params_groups
from dino_tpu_torch.checkpointing.convert import from_jax_dino, to_jax_dino
from dino_tpu_torch.checkpointing.io import flatten_params
from dino_tpu_torch.models import vit as tvit
from dino_tpu_torch.ops.preprocess import normalize_imagenet
from dino_tpu_torch.train import dino_pretrain as tdp

D, DEPTH, BATCH = 128, 2, 4
JVIT = jvit.ViTConfig(patch_size=8, embed_dim=D, num_heads=2)
TVIT = tvit.ViTConfig(patch_size=8, embed_dim=D, num_heads=2)
KW = dict(out_dim=32, n_local_crops=2, global_size=32, local_size=16,
          hidden_dim=64, bottleneck_dim=16)
JDINO, TDINO = jdp.DinoConfig(**KW), tdp.DinoConfig(**KW)
N_CROPS = 2 + KW["n_local_crops"]
LR, WD = 3e-4, 1e-4   # optax.adamw(3e-4)'s learning rate and weight decay
# the CLI's injected hyperparameters, one (lr, wd) per step (float32)
SCHED = [(np.float32(3e-4), np.float32(0.04)),
         (np.float32(2e-4), np.float32(0.1)),
         (np.float32(1e-4), np.float32(0.2))]
TEACHER_TEMP, MOMENTUM = 0.04, 0.99

# the loss: float32 sums in another order, and by the third step the
# states part as PARAM_* says (measured up to 6.1e-6 relative)
LOSS_RTOL = 3e-5
# clipped gradients from the same pre-step state (the port's), each leaf's
# max |err| against its largest |g|: float32 sums in another order on the
# two sides (measured up to 4.3e-6)
GRAD_REL = 2e-5
# post-step student, as a share of the step's learning rate: Adam turns a
# gradient within float32 noise of 0 into a step of up to lr, so such an
# entry may land up to 2 lr apart; elsewhere the parts differ by float32
# rounding.  Entries beyond PARAM_LR_SHARE * lr: none allowed past 2.1 lr,
# and at most PARAM_FLIP_SHARE of all entries past PARAM_LR_SHARE * lr
# (measured: max 0.59 lr, 2.6e-4 of the entries past 0.02 lr)
PARAM_LR_SHARE = 0.02
PARAM_FLIP_SHARE = 1e-3
# the teacher moves by (1 - m) of the student's change, the centre by
# (1 - 0.9) of the teacher's output mean (measured: teacher 1.1e-5,
# centre 1.6e-7 against entries up to 0.14)
TEACHER_ATOL = 2.1 * (1 - MOMENTUM) * 3 * LR
CENTER_TOL = dict(atol=1e-6, rtol=1e-5)
# bf16 backbones: bf16 rounding of every activation on both sides, in
# other orders, sharpened by the teacher temperature (1/0.04) (measured:
# loss 1.4e-2 relative, gradients 3.9e-2 of a leaf's largest |g|)
BF16_LOSS_RTOL = 5e-2
BF16_GRAD_REL = 0.1


@pytest.fixture(scope="module")
def setup():
    student, teacher = jdp.init_dino_params(jax.random.PRNGKey(0), JVIT,
                                            JDINO, depth=DEPTH)
    student = jax.tree.map(np.asarray, student)
    teacher = jax.tree.map(np.asarray, teacher)
    rs = np.random.RandomState(0)
    g = rs.randint(0, 255, (2, BATCH, 32, 32, 3)).astype(np.uint8)
    l = rs.randint(0, 255, (2, BATCH, 16, 16, 3)).astype(np.uint8)
    return student, teacher, g, l


def _flat(tree):
    """{path: array} of a dino_tpu tree, the head's _meta left out."""
    tree = dict(tree, head={k: v for k, v in tree["head"].items()
                            if k != "_meta"})
    return {k: np.asarray(v, np.float32)
            for k, v in flatten_params(tree).items()}


def _port_flat(model, attr=None):
    sd = {k: (p if attr is None else getattr(p, attr)).detach()
          for k, p in model.named_parameters()}
    return _flat(to_jax_dino(sd))


def _port_pair(student):
    s = tdp.DinoModel(TVIT, TDINO, depth=DEPTH)
    s.load_state_dict(from_jax_dino(student), strict=True)
    return tdp.dino_pair(s, "cpu")


def _jax_opt(masked):
    if not masked:
        return optax.adamw(LR)
    return optax.inject_hyperparams(functools.partial(
        optax.adamw, mask=lambda p: jget_params_groups(p)[0]))(
            learning_rate=LR, weight_decay=0.04)


@functools.lru_cache(maxsize=None)
def _jax_step(masked, accum, bf16=False):
    return jdp.make_dino_train_step(
        JVIT, JDINO, _jax_opt(masked), accum_steps=accum,
        compute_dtype=jnp.bfloat16 if bf16 else None)


@functools.lru_cache(maxsize=None)
def _jax_clipped_grads_fn(bf16=False):
    """dino_tpu's clipped (and last-layer gated) gradients of one step,
    from its own _forward and dino_loss."""
    cdt = jnp.bfloat16 if bf16 else None

    @jax.jit
    def fn(s_p, t_p, center, g, l, freeze_last):
        g = jnormalize(g)
        l = jnormalize(l)
        meta = {"norm_last_layer": True, "nlayers": 3}

        def join(p):
            return {"vit": p["vit"], "head": dict(p["head"], _meta=meta)}

        def loss_fn(p):
            crops = [g[0], g[1]] + [l[i] for i in range(l.shape[0])]
            s_out = jdp._forward(join(p), crops, JVIT, cdt)
            t_out = jax.lax.stop_gradient(
                jdp._forward(join(t_p), [g[0], g[1]], JVIT, cdt))
            return jdp.dino_loss(s_out, t_out, center, JDINO.student_temp,
                                 jnp.float32(TEACHER_TEMP), N_CROPS)

        grads = jax.grad(loss_fn)(s_p)
        grads = jax.tree.map(
            lambda x: x * jnp.minimum(1.0, 3.0 / (jnp.linalg.norm(x) + 1e-6)),
            grads)
        grads["head"]["last_layer"] = jax.tree.map(
            lambda x: x * (1.0 - freeze_last), grads["head"]["last_layer"])
        return grads
    return fn


def _nometa(tree):
    return {"vit": tree["vit"],
            "head": {k: v for k, v in tree["head"].items() if k != "_meta"}}


def _assert_grads_close(port_model, jgrads, rel):
    got, want = _port_flat(port_model, "grad"), _flat(jgrads)
    assert set(got) == set(want)
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-30)
        err = np.abs(got[k] - want[k]).max()
        assert err <= rel * scale, (k, err, scale)


def _assert_params_close(port_model, jtree, lr_total):
    got, want = _port_flat(port_model), _flat(jtree)
    assert set(got) == set(want)
    n_far = n_all = 0
    for k in want:
        err = np.abs(got[k] - want[k])
        assert err.max() <= 2.1 * lr_total, (k, err.max(), lr_total)
        n_far += int((err > PARAM_LR_SHARE * lr_total).sum())
        n_all += err.size
    assert n_far <= PARAM_FLIP_SHARE * n_all, (n_far, n_all)


def _run(setup, masked, accum, freeze_last, crops="uint8", bf16=False,
         check_grads=True):
    """3 steps of both packages from the same weights and crops; holds the
    losses and clipped gradients step by step and the final state."""
    student, teacher, g_u8, l_u8 = setup
    jstep = _jax_step(masked, accum, bf16)
    jopt = _jax_opt(masked)
    s_p, t_p = student, teacher
    jstate = jdp.init_dino_opt_state(jopt, s_p)
    jcenter = jnp.zeros((1, KW["out_dim"]), jnp.float32)

    ts, tt = _port_pair(student)
    topt = tdp.make_dino_optimizer(ts, LR, WD if not masked else 0.04,
                                   masked=masked)
    tstep = tdp.make_dino_train_step(
        TVIT, TDINO, accum_steps=accum,
        compute_dtype=torch.bfloat16 if bf16 else None)
    tcenter = torch.zeros(1, KW["out_dim"])
    g_t, l_t = torch.from_numpy(g_u8), torch.from_numpy(l_u8)
    if crops == "float":
        g_t, l_t = normalize_imagenet(g_t), normalize_imagenet(l_t)
    lr_total = 0.0
    for i in range(3):
        lr, wd = SCHED[i] if masked else (np.float32(LR), None)
        if masked:
            jstate.hyperparams["learning_rate"] = jnp.float32(lr)
            jstate.hyperparams["weight_decay"] = jnp.float32(wd)
            tdp.set_hyperparams(topt, float(lr), float(wd))
        lr_total += float(lr)
        if check_grads:  # from the port's state before this step
            jgrads = _jax_clipped_grads_fn(bf16)(
                _nometa(to_jax_dino(ts.state_dict())),
                _nometa(to_jax_dino(tt.state_dict())), tcenter.numpy(),
                g_u8, l_u8, jnp.float32(freeze_last))
        s_p, t_p, jcenter, jstate, jl = jstep(
            s_p, t_p, jcenter, jstate, jnp.asarray(g_u8), jnp.asarray(l_u8),
            jnp.float32(TEACHER_TEMP), jnp.float32(MOMENTUM),
            jnp.float32(freeze_last))
        loss = tstep(ts, tt, tcenter, topt, g_t, l_t, TEACHER_TEMP,
                     MOMENTUM, freeze_last)
        np.testing.assert_allclose(float(loss), float(jl),
                                   rtol=BF16_LOSS_RTOL if bf16
                                   else LOSS_RTOL)
        if check_grads:
            _assert_grads_close(ts, jgrads, BF16_GRAD_REL if bf16
                                else GRAD_REL)
    return (ts, tt, tcenter), (s_p, t_p, jcenter), lr_total


@pytest.mark.parametrize("freeze_last", [0.0, 1.0])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_three_steps_match_dino_tpu(setup, masked, accum, freeze_last):
    port, jax_out, lr_total = _run(setup, masked, accum, freeze_last,
                                   check_grads=accum == 1)
    ts, tt, tcenter = port
    s_p, t_p, jcenter = jax_out
    _assert_params_close(ts, s_p, lr_total)
    got_t, want_t = _port_flat(tt), _flat(t_p)
    for k in want_t:
        np.testing.assert_allclose(got_t[k], want_t[k], rtol=0,
                                   atol=TEACHER_ATOL, err_msg=k)
    np.testing.assert_allclose(tcenter.numpy(), np.asarray(jcenter),
                               **CENTER_TOL)
    # the steps moved the last layer's direction far beyond the tolerance,
    # unless frozen: then only the weight decay moved it (v is a matrix,
    # decayed masked or not)
    v0 = setup[0]["head"]["last_layer"]["v"]
    v = ts.head.last_layer.v.detach().numpy().T
    if freeze_last:
        decay = (sum(float(lr) * float(wd) for lr, wd in SCHED) if masked
                 else 3 * LR * WD)
        # one float32 rounding of v per step beside the decay
        assert (np.abs(v - v0) <= 1.01 * decay * np.abs(v0)
                + 3 * np.spacing(np.abs(v0))).all()
    else:
        assert np.abs(v - v0).max() > 20 * PARAM_LR_SHARE * lr_total


def test_uint8_crops_match_prenormalized(setup):
    """uint8 crops normalize inside the step; prenormalized float crops
    give the same step (and both dino_tpu's)."""
    a = _run(setup, False, 1, 0.0, crops="uint8", check_grads=False)
    b = _run(setup, False, 1, 0.0, crops="float", check_grads=False)
    for x, y in zip(a[0][0].parameters(), b[0][0].parameters()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=0, atol=2.1 * a[2])
    _assert_params_close(b[0][0], b[1][0], b[2])
    torch.testing.assert_close(a[0][2], b[0][2], **CENTER_TOL)


def test_bf16_step_matches_dino_tpu(setup):
    """compute_dtype=bf16: backbones in bf16 on both sides; loss and
    clipped gradients at bf16 tolerance, every gradient float32."""
    port, _, _ = _run(setup, False, 1, 0.0, bf16=True)
    for p in port[0].parameters():
        assert p.grad.dtype == torch.float32
        assert bool(torch.isfinite(p.grad).all())


def test_every_port_tensor_is_one_dino_tpu_leaf(setup):
    """The per-leaf clip and norms need one port parameter per dino_tpu
    leaf, of the same size; the converters carry them both ways."""
    student = setup[0]
    ts, tt = _port_pair(student)
    leaves = _flat(student)
    assert len(list(ts.parameters())) == len(leaves)
    got = _port_flat(ts)
    assert set(got) == set(leaves)
    for k in leaves:
        np.testing.assert_array_equal(got[k], leaves[k])
    back = to_jax_dino(ts.state_dict())
    assert back["head"]["_meta"] == student["head"]["_meta"]
    # the teacher is a copy with no gradient, not an alias
    for a, b in zip(ts.parameters(), tt.parameters()):
        assert a.data_ptr() != b.data_ptr() and not b.requires_grad


def test_head_g_takes_adam_and_decay_with_zero_gradient(setup):
    """norm_last_layer: g gets no gradient from the loss, yet stays in
    the optimizer with a zero gradient, so unmasked AdamW decays it as
    optax's adamw does."""
    (ts, _, _), (s_p, _, _), _ = _run(setup, False, 1, 0.0,
                                      check_grads=False)
    assert torch.equal(ts.head.last_layer.g.grad,
                       torch.zeros_like(ts.head.last_layer.g))
    want = np.asarray(s_p["head"]["last_layer"]["g"])
    assert (want < 1).all()   # decayed by (1 - lr * wd) per step
    np.testing.assert_allclose(ts.head.last_layer.g.detach().numpy(), want,
                               rtol=1e-7)


def test_fsdp_and_bad_accum_raise():
    # FSDP takes shard_dino_state's optimizer, not a plain one
    step = tdp.make_dino_train_step(TVIT, TDINO, fsdp_mesh=object())
    with pytest.raises(TypeError, match="shard_dino_state"):
        step(None, None, None, None, torch.zeros(2, 4, 32, 32, 3),
             torch.zeros(2, 4, 16, 16, 3), 0.04, 0.99, 0.0)
    step = tdp.make_dino_train_step(TVIT, TDINO, accum_steps=3)
    with pytest.raises(ValueError, match="accum_steps"):
        step(None, None, None, None, torch.zeros(2, 4, 32, 32, 3),
             torch.zeros(2, 4, 16, 16, 3), 0.04, 0.99, 0.0)
