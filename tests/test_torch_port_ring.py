"""The sequence-parallel slice: dino_tpu_torch's dynamic-bound attention,
ring attention, SP forward, SP train step and SP predict vs dino_tpu's, on
the CPU.

The port's ranks are real gloo processes (``subprocess``, a FileStore under
``tmp_path``) that import neither jax nor dino_tpu: this process computes
the JAX references and hands the inputs over as ``.npz``.  Two spawns: a
world of two (forward, one Adam step, predict) and a world of four
(forward).  Small model: D=128, 2 heads of hd=64 (the kernels' head dim),
48px images, N+1 = 37 tokens, so the last shard pads at d=2 and d=4.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import logsumexp
import pytest
import torch

import dino_tpu.ops.attention as jatt
from dino_tpu.api import DINOSeg as JaxDINOSeg
from dino_tpu.models import vit as jvit
from dino_tpu.models.heads import init_head as jinit_head
from dino_tpu.ops.preprocess import preprocess as jax_preprocess
from dino_tpu.parallel.mesh import make_mesh
from dino_tpu.parallel import ring_attention as jring
from dino_tpu.train import loop as jloop
from dino_tpu.train.loop import seg_forward as jax_seg_forward
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.checkpointing.convert import from_jax_params
from dino_tpu_torch.models.vit import ViTConfig
from dino_tpu_torch.ops import attention as tatt
from dino_tpu_torch.parallel import dist as tdist
from dino_tpu_torch.parallel import ring_attention as tring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, DEPTH, RES, N_CLASSES, BATCH = 128, 2, 48, 5, 3
N_PATCH = (RES // 8) ** 2
PRED_RES = 240
MARGIN = 1e-4  # top-2 log-prob gap below which fp32 argmax may flip
LR = 1e-4
CHILD_TIMEOUT = 300  # seconds per rank process: a hang fails, not stalls
# tests/test_ring_attention.py's tolerances for the same functions
FWD_TOL = dict(atol=2e-5, rtol=1e-5)
BWD_TOL = dict(atol=2e-4, rtol=1e-4)
# SP forward: port (plain hop kernels, f32) vs dino_tpu (Pallas hop kernels
# in interpret mode), f32 sums in another order; measured max |diff| 2.5e-6
# at d=2 (and 2.4e-6 against the port's own single-device forward)
SP_FWD_TOL = dict(atol=2e-5, rtol=1e-5)
# one SP Adam step: the JAX package's own SP test allows atol 2e-4, rtol
# 1e-3; tightened to the port's train tests' tolerance.  Measured: every
# param within 1.7e-6 (Adam's first update is ~lr * sign(g), so a gradient
# within a few ulps of 0 sets how far an entry can drift)
STEP_PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
LOSS_RTOL = 1e-5

JCFG = jvit.ViTConfig(patch_size=8, embed_dim=D, num_heads=2)

_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    cfg = json.loads(sys.argv[1])
    from dino_tpu_torch import DINOSeg
    from dino_tpu_torch.checkpointing.convert import strip_prefix
    from dino_tpu_torch.models.heads import MLPHead
    from dino_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                           vit_forward)
    from dino_tpu_torch.parallel import dist as pd
    from dino_tpu_torch.parallel.ring_attention import (
        make_sp_train_step, vit_forward_seq_parallel)
    from dino_tpu_torch.train.loop import init_opt_state, make_optimizer
    assert not any(m in ("jax", "dino_tpu")
                   or m.startswith(("jax.", "dino_tpu."))
                   for m in sys.modules)

    pd.init_distributed_mode("gloo", cfg["init"], cfg["world"], cfg["rank"])
    z = dict(np.load(cfg["inputs"]))
    t = {k: torch.from_numpy(v) for k, v in z.items()}
    sd = {k[3:]: v for k, v in t.items() if k.startswith("sd.")}
    tcfg = ViTConfig(patch_size=8, embed_dim=cfg["d_model"], num_heads=2)

    def modules():
        vit = VisionTransformer(tcfg, depth=cfg["depth"])
        vit.load_state_dict(strip_prefix(sd, "dino."), strict=True)
        head = MLPHead(cfg["n_classes"], cfg["d_model"])
        head.load_state_dict(strip_prefix(sd, "clf."), strict=True)
        return vit, head

    out = {}
    vit, head = modules()
    with torch.no_grad():
        out["sp_tokens"] = vit_forward_seq_parallel(vit, t["x"], tcfg).numpy()
        out["tokens"] = vit_forward(vit, t["x"], tcfg).numpy()
    if cfg["train"]:
        opt = make_optimizer("adam", cfg["lr"])
        step = make_sp_train_step(tcfg, "mlp", cfg["n_classes"], opt)
        loss, cm = step(vit, head, init_opt_state(opt, vit, head, False),
                        t["images"], t["labels"], t["mask"])
        out["loss"], out["cm"] = loss.numpy(), cm.numpy()
        for k, p in list(vit.named_parameters()):
            out["vit." + k] = p.detach().numpy()
        for k, p in list(head.named_parameters()):
            out["head." + k] = p.detach().numpy()
        pm = DINOSeg(head="mlp", n_blocks=1, precision="fp32",
                     random_init=True, device="cpu")
        pm.load_state_dict({k[4:]: v for k, v in t.items()
                            if k.startswith("pdm.")})
        pm.set_resolution(cfg["pred_res"])
        out["pred"] = pm.predict_batch(z["frames"], parallelism="sp")
    np.savez(cfg["out"], **out)
""")


def _spawn(tmp, world, inputs, train):
    """Run ``world`` gloo rank processes on ``inputs``; returns each rank's
    results.  A rank that fails or outlives CHILD_TIMEOUT fails the test
    and takes its peers down."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs, outs = [], []
    for r in range(world):
        cfg = dict(init=f"file://{tmp}/store{world}", world=world, rank=r,
                   inputs=inputs, out=f"{tmp}/rank{world}_{r}.npz",
                   d_model=D, depth=DEPTH, n_classes=N_CLASSES, lr=LR,
                   pred_res=PRED_RES, train=train)
        outs.append(cfg["out"])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK, json.dumps(cfg)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(o)) for o in outs]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    vit_p = _np_tree(jvit.init_vit_params(jax.random.PRNGKey(0), JCFG,
                                          depth=DEPTH))
    head_p = _np_tree(jinit_head(jax.random.PRNGKey(1), "mlp", N_CLASSES, D))
    rs = np.random.RandomState(0)
    x = rs.randn(2, RES, RES, 3).astype(np.float32)
    images = rs.randint(0, 255, (BATCH, RES, RES, 3)).astype(np.uint8)
    labels = rs.randint(0, N_CLASSES, (BATCH, N_PATCH)).astype(np.int32)
    mask = np.array([1, 1, 0], np.float32)  # ragged tail
    frames = rs.randint(0, 256, (2, 240, 320, 3)).astype(np.uint8)
    jm = JaxDINOSeg(head="mlp", n_blocks=1, precision="fp32",
                    random_init=True, seed=0)
    jm.set_resolution(PRED_RES)
    return dict(vit=vit_p, head=head_p, x=x, images=images, labels=labels,
                mask=mask, frames=frames, jm=jm)


@pytest.fixture(scope="module")
def inputs(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    sd = from_jax_params(setup["vit"], setup["head"])
    jm = setup["jm"]
    pdm = from_jax_params(_np_tree(jm.vit_params), _np_tree(jm.head_params))
    arrays = {"sd." + k: v.numpy() for k, v in sd.items()}
    arrays.update({"pdm." + k: v.numpy() for k, v in pdm.items()})
    arrays.update({k: setup[k] for k in ("x", "images", "labels", "mask",
                                         "frames")})
    path = str(tmp / "inputs.npz")
    np.savez(path, **arrays)
    return str(tmp), path


@pytest.fixture(scope="module")
def world2(inputs):
    return _spawn(inputs[0], 2, inputs[1], train=True)


@pytest.fixture(scope="module")
def world4(inputs):
    return _spawn(inputs[0], 4, inputs[1], train=False)


# ---------------------------------------------------------------------------
# The dynamic-bound hop kernels (plain versions) vs the Pallas kernels
# ---------------------------------------------------------------------------

_DYN_FWD = jax.jit(lambda q, k, v, vd: jatt.flash_attention_with_lse_dyn(
    q, k, v, 64 ** -0.5, vd, interpret=True))
_DYN_BWD = jax.jit(lambda q, g, lse, dsum, k, v, vd: jatt.flash_attention_bwd_dyn(
    q, g, lse, dsum, k, v, 64 ** -0.5, vd, interpret=True))


def _qkv(nq, nk, seed, b=1, nh=2):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, nh, nq, 64).astype(np.float32),
            rs.randn(b, nh, nk, 64).astype(np.float32),
            rs.randn(b, nh, nk, 64).astype(np.float32))


@pytest.mark.parametrize("valid", [96, 50, 1, 0])
def test_dyn_forward_matches_pallas(valid):
    """attention_dyn_plain == _flash_kernel_dyn (interpret) for Nq != Nk.
    At valid 0 only the lse is compared (both ~ -1e30, which the ring merge
    weighs 0): JAX's output there averages V over its zero-padded K rows,
    which the port does not have; the port's is 0."""
    q, k, v = _qkv(130, 96, seed=valid)
    out_j, lse_j = _DYN_FWD(q, k, v, jnp.int32(valid))
    out, lse = tatt.flash_attention_with_lse_dyn(
        *(torch.from_numpy(a) for a in (q, k, v)), 64 ** -0.5, valid)
    assert out.shape == (1, 2, 130, 64) and lse.shape == (2, 130)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :130, 0],
                               **FWD_TOL)
    assert torch.isfinite(out).all()
    if valid == 0:
        assert float(lse.max()) <= -1e29
        assert float(out.abs().max()) == 0.0
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **FWD_TOL)


@pytest.mark.parametrize("valid", [96, 40, 1, 0])
def test_dyn_backward_matches_pallas(valid):
    """attention_bwd_dyn_plain == _flash_bwd_kernel_dyn (interpret), given
    the global lse and D over the valid prefix; dk/dv rows >= valid are
    exact zeros on both sides."""
    q, k, v = _qkv(64, 96, seed=100 + valid)
    g = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    scale = 64 ** -0.5
    if valid:
        s = np.einsum("bhqd,bhkd->bhqk", q, k[:, :, :valid]) * scale
        lse = np.array(logsumexp(s, axis=-1, keepdims=True))
        out = np.einsum("bhqk,bhkd->bhqd", np.exp(s - lse), v[:, :, :valid])
    else:
        lse = np.full(q.shape[:3] + (1,), -1e30, np.float32)
        out = np.zeros_like(q)
    dsum = (g * out).sum(-1, keepdims=True).astype(np.float32)
    ref = _DYN_BWD(q, g, lse, dsum, k, v, jnp.int32(valid))
    got = tatt.flash_attention_bwd_dyn(
        *(torch.from_numpy(a) for a in (q, g, lse.reshape(2, 64),
                                        dsum.reshape(2, 64), k, v)),
        scale, valid)
    for a, r in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **BWD_TOL)
    if valid < 96:  # dead keys get exactly zero grads
        for a, r in zip(got[1:], ref[1:]):
            assert float(a[:, :, valid:].abs().max()) == 0.0
            assert float(jnp.abs(r[:, :, valid:]).max()) == 0.0


def test_dyn_wrappers_match_plain_at_full_bound():
    """At valid = N the dynamic-bound functions are the static ones."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(45, 45, seed=3))
    g = torch.from_numpy(np.random.RandomState(4).randn(1, 2, 45, 64)
                         .astype(np.float32))
    out, lse = tatt.flash_attention_with_lse_dyn(q, k, v, 0.125, 45)
    ref, ref_lse = tatt.attention_plain(q, k, v, 0.125)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    dsum = (g * out).sum(-1).reshape(2, 45)
    got = tatt.flash_attention_bwd_dyn(q, g, lse, dsum, k, v, 0.125, 45)
    want = tatt.attention_bwd_plain(q, k, v, out, lse, g, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("valid", [-1, 97, 3.0])
def test_dyn_bound_must_be_a_host_int_in_range(valid):
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 96, seed=5))
    with pytest.raises(ValueError, match="valid_k"):
        tatt.flash_attention_with_lse_dyn(q, k, v, 0.125, valid)


def test_dyn_kernels_refuse_other_devices():
    q, k, v = (torch.zeros(1, 2, 8, 64, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="device"):
        tatt.flash_attention_with_lse_dyn(q, k, v, 0.125, 8)
    lse = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        tatt.flash_attention_bwd_dyn(q, q, lse, lse, k, v, 0.125, 8)


def test_streaming_forward_covers_the_chunked_kernel(monkeypatch):
    """Kernel 4: past 8 resident K/V slices dino_tpu runs
    _flash_kernel_chunked (no LSE).  A shrunken VMEM budget forces that
    branch at N = 4,001; the port's forward (one K/V stream at any N)
    equals it."""
    budget = 200_000
    n = 4001
    assert jatt._split_count(n, 64, 4, budget) is None
    calls = []
    real = jatt._flash_kernel_chunked

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(jatt, "_KV_VMEM_BUDGET", budget)
    monkeypatch.setattr(jatt, "_flash_kernel_chunked", spy)
    q, k, v = _qkv(n, n, seed=11, nh=1)
    ref = np.asarray(jatt.flash_attention(q, k, v, 64 ** -0.5, True))
    assert calls, "dino_tpu did not take the chunked kernel"
    out = tatt.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               64 ** -0.5)
    np.testing.assert_allclose(out.numpy(), ref, **FWD_TOL)


# ---------------------------------------------------------------------------
# Collectives and the API without a process group
# ---------------------------------------------------------------------------

def test_collectives_are_identities_in_a_world_of_one():
    assert not tdist.is_dist_avail_and_initialized()
    assert tdist.get_world_size() == 1 and tdist.get_rank() == 0
    a, b = torch.arange(6.0).reshape(2, 3), torch.ones(2, dtype=torch.int64)
    assert tdist.ring_shift([a, b]) == [a, b]
    tdist.all_reduce_sum_([a, b])
    assert torch.equal(a, torch.arange(6.0).reshape(2, 3))
    assert tdist.all_gather_seq(a, dim=1) is a


def test_sp_predict_needs_a_process_group():
    pm = DINOSeg(head="mlp", n_blocks=1, random_init=True, device="cpu")
    frame = np.zeros((48, 48, 3), np.uint8)
    with pytest.raises(RuntimeError, match="init_distributed_mode"):
        pm.predict(frame, parallelism="sp")
    with pytest.raises(RuntimeError, match="init_distributed_mode"):
        pm.predict_batch(frame[None], parallelism="tp")
    with pytest.raises(ValueError, match="parallelism"):
        pm.predict_batch(frame[None], parallelism="pp")


@pytest.mark.parametrize("call, exc, match", [
    (lambda: tring.make_sp_train_step(ViTConfig(), "moe", 7, None,
                                      moe_dispatch="sparse"),
     ValueError, "sparse"),
    (lambda: tring.make_sp_train_step(ViTConfig(), "seg", 7, None,
                                      zero=True), ValueError,
     "unknown head"),
    (lambda: tring.make_sp_tp_train_step(ViTConfig(), "moe", 7, None),
     ValueError, "mlp/linear"),
    (lambda: tring.make_sp_tp_train_step(ViTConfig(), "seg", 7, None),
     ValueError, "mlp/linear"),
])
def test_unported_sp_options_raise(call, exc, match):
    with pytest.raises(exc, match=match):
        call()


# ---------------------------------------------------------------------------
# Rank processes vs dino_tpu
# ---------------------------------------------------------------------------

def _jax_sp_tokens(setup, d):
    return np.asarray(jring.vit_forward_seq_parallel(
        setup["vit"], jnp.asarray(setup["x"]), JCFG,
        make_mesh(d, model_axis=1), seq_axis="data", flash="force"))


@pytest.mark.parametrize("d", [2, 4])
def test_sp_forward_matches_dino_tpu(setup, world2, world4, d):
    ranks = world2 if d == 2 else world4
    ref = _jax_sp_tokens(setup, d)
    for r, res in enumerate(ranks):  # every rank holds the gathered tokens
        assert res["sp_tokens"].shape == ref.shape == (2, N_PATCH + 1, D)
        np.testing.assert_allclose(res["sp_tokens"], ref, **SP_FWD_TOL,
                                   err_msg=f"rank {r} of {d}")


@pytest.mark.parametrize("d", [2, 4])
def test_sp_forward_matches_the_ports_single_device_forward(world2, world4,
                                                            d):
    for res in (world2 if d == 2 else world4):
        np.testing.assert_allclose(res["sp_tokens"], res["tokens"],
                                   **SP_FWD_TOL)


@pytest.fixture(scope="module")
def jax_sp_step(setup):
    opt = jloop.make_optimizer("adam", LR)
    step = jring.make_sp_train_step(JCFG, "mlp", N_CLASSES, opt,
                                    make_mesh(2, model_axis=1),
                                    seq_axis="data", flash="force")
    vit_p, head_p = setup["vit"], setup["head"]
    out = step(vit_p, head_p, jloop.init_opt_state(opt, vit_p, head_p, False),
               setup["images"], setup["labels"], jnp.asarray(setup["mask"]))
    return _np_tree(out)


def test_sp_train_step_loss_and_cm_match_dino_tpu(world2, jax_sp_step):
    _, _, _, loss, cm = jax_sp_step
    for res in world2:
        np.testing.assert_allclose(float(res["loss"]), float(loss),
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(res["cm"], cm)
        assert int(res["cm"].sum()) == 2 * N_PATCH  # the masked sample drops


def test_sp_train_step_params_match_dino_tpu(world2, jax_sp_step):
    names = {"dino.": "vit.", "clf.": "head."}
    want = {names[k[:k.index(".") + 1]] + k[k.index(".") + 1:]: v.numpy()
            for k, v in from_jax_params(*jax_sp_step[:2]).items()}
    for res in world2:
        got = {k: v for k, v in res.items()
               if k.startswith(("vit.", "head."))}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **STEP_PARAM_TOL,
                                       err_msg=k)


def test_sp_predict_batch_matches_dino_tpu(setup, world2):
    """DINOSeg.predict_batch(parallelism='sp') over two ranks vs dino_tpu's
    SP predict_batch (8 devices): fp32 labels equal except at patches
    whose top-2 log-prob margin is < 1e-4."""
    jm, frames = setup["jm"], setup["frames"]
    ref = jm.predict_batch(frames, precision="fp32", parallelism="sp")
    x = jax_preprocess(jnp.asarray(frames), PRED_RES)
    logp = np.asarray(jax_seg_forward(jm.vit_params, jm.head_params, jm.cfg,
                                      "mlp", pre_normalized=x))
    out = PRED_RES // 8
    f = 480 // out
    top2 = np.sort(logp, axis=-1)[:, -2:]
    near = ((top2[:, 1] - top2[:, 0]) < MARGIN).reshape(2, out, out)
    for res in world2:
        pred = res["pred"]
        assert pred.shape == (2, 480, 480) and pred.dtype == np.int32
        low = pred[:, ::f, ::f]
        np.testing.assert_array_equal(low[~near], ref[:, ::f, ::f][~near])
        np.testing.assert_array_equal(pred, np.kron(
            low, np.ones((1, f, f), np.int32)))
