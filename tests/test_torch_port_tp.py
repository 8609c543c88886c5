"""Tensor-parallel predict: DINOSeg.predict/predict_batch/predict_stream/
log_probs(parallelism='tp') of the port over 2 and 4 gloo ranks against
dino_tpu's plain and 'tp' predict_batch, on the CPU.

The config of tests/test_sharding.py::test_tp_serving_mode: full-width
ViT-S/8 (D 384, 6 heads, MLP 1,536), 2 blocks, MLP head, 5 classes, fp32,
64px, batch 3, dino_tpu's random init carried to the port; the MoE head (4
experts, dense and sparse dispatch) the same way.  One module-scoped world
per layout (TP 2; TP 4, where the 6 heads split 2, 2, 1, 1), its ranks real
gloo processes (tests/test_torch_port_multiprocess.py:spawn_ranks) that
import neither jax nor dino_tpu; the inputs reach them as ``.npz``.  TP 4
also runs a 2-head model (D 128), whose ranks 2 and 3 hold no head, through
predict and a train step over the ranks.

In this process: the packing against dino_tpu's ``tp_pack_block``, the
column-parallel products against the single-rank layers bit for bit, the
worlds dino_tpu accepts, and the errors without a process group.
"""
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tpu.api import DINOSeg as JaxDINOSeg
from dino_tpu.models.vit import ViTConfig as JaxViTConfig
from dino_tpu.models.vit import init_vit_params as jax_init_vit
from dino_tpu.ops.preprocess import preprocess as jax_preprocess
from dino_tpu.parallel import tp as jtp
from dino_tpu.parallel.mesh import make_mesh, shard_params, vit_param_spec
from dino_tpu.train.loop import seg_forward as jax_seg_forward
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.checkpointing.convert import (from_jax_params,
                                                  strip_prefix)
from dino_tpu_torch.models.heads import affine, dense
from dino_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                       layer_norm, prepare_tokens)
from dino_tpu_torch.ops.preprocess import preprocess
from dino_tpu_torch.parallel import tp as ttp
from tests.test_torch_port_multiprocess import spawn_ranks

RES, N_CLASSES, BATCH, DEPTH = 64, 5, 3, 2
OUT = RES // 8
MARGIN = 1e-4  # top-2 log-prob gap below which fp32 argmax may flip
BF16_MARGIN = 1e-2  # the same for bf16 against the port's bf16 world of one
# log-probs of the ranks against the world of one's, over the largest
# |log-prob|: the row-parallel sums add the same float32 products in
# another order (measured 2.4e-7 absolute)
LOGP_REL = 1e-5
# the 2-head model of the TP 4 world (hd 64), its train step's lr
SMALL_D, SMALL_LR = 128, 1e-3
GRAD_REL = 1e-5  # each gradient leaf against its max, world of one

_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    cfg = json.loads(sys.argv[1])
    from dino_tpu_torch import DINOSeg
    from dino_tpu_torch.checkpointing.convert import strip_prefix
    from dino_tpu_torch.models.heads import MLPHead
    from dino_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from dino_tpu_torch.parallel import dist as pd
    from dino_tpu_torch.parallel import tp
    from dino_tpu_torch.train.loop import (init_opt_state, make_optimizer,
                                           make_train_step)
    assert not any(m in ("jax", "dino_tpu")
                   or m.startswith(("jax.", "dino_tpu."))
                   for m in sys.modules)

    torch.set_num_threads(1)  # the ranks share the host's cores
    pd.init_distributed_mode("gloo", cfg["init"], cfg["world"], cfg["rank"])
    z = dict(np.load(cfg["inputs"]))
    frames = z["frames"]
    imgs = torch.from_numpy(frames)
    out = {}

    def sd(prefix):
        return {k: torch.from_numpy(v)
                for k, v in strip_prefix(z, prefix).items()}

    def model(prefix, **kw):
        m = DINOSeg(n_blocks=2, n_classes=5, precision="fp32",
                    random_init=True, device="cpu", **kw)
        m.load_state_dict(sd(prefix))
        m.set_resolution(cfg["res"])
        return m

    m = model("mlp.", head="mlp")
    out["fp32"] = m.predict_batch(frames, parallelism="tp")
    out["bf16"] = m.predict_batch(frames, precision="bf16", parallelism="tp")
    out["lp"] = m.log_probs(imgs, parallelism="tp").numpy()
    out["one"] = m.predict(frames[0], parallelism="tp")
    out["stream"] = np.stack(list(m.predict_stream(
        iter(frames), batch_size=2, parallelism="tp")))
    first = m._tp_params()
    kept = m._tp_params() is first
    m.load_state_dict(sd("mlp2."))
    out["cache"] = np.array([kept, m._tp_params() is not first])
    out["after"] = m.predict_batch(frames, parallelism="tp")
    for disp in ("dense", "sparse"):
        mm = model("moe.", head="moe", n_experts=4, moe_dispatch=disp)
        out["moe_" + disp] = mm.predict_batch(frames, parallelism="tp")
        out["moe_lp_" + disp] = mm.log_probs(imgs, parallelism="tp").numpy()

    # the 2-head model: at 4 ranks, ranks 2 and 3 hold no head
    scfg = ViTConfig(patch_size=8, embed_dim=cfg["small_d"], num_heads=2)
    vit = VisionTransformer(scfg, depth=2)
    vit.load_state_dict(sd("small.vit."))
    head = MLPHead(5, cfg["small_d"])
    head.load_state_dict(sd("small.head."))
    x = torch.from_numpy(z["small_x"])
    blocks = tp.tp_serving_slices(vit, scfg, cfg["rank"], cfg["world"])
    out["small_heads"] = np.array([b["heads"] for b in blocks])
    with torch.no_grad():
        out["small_tokens"] = tp.vit_forward_tp(
            vit, x, scfg, torch.distributed.group.WORLD, blocks).numpy()
    tvit = tp.tp_shard_vit(vit)
    opt = make_optimizer("adam", cfg["small_lr"])
    step = make_train_step(scfg, "mlp", 5, opt, False,
                           tp_group=torch.distributed.group.WORLD)
    loss, _ = step(tvit, head, init_opt_state(opt, tvit, head, False),
                   torch.from_numpy(z["small_imgs"]),
                   torch.from_numpy(z["small_labels"]))
    out["small_loss"] = loss.numpy()
    for k, g in tp.tp_gather_state(tvit, grads=True).items():
        out["small_grad." + k] = g.numpy()

    def error(fn):
        try:
            fn()
        except Exception as e:  # the type is the result
            return type(e).__name__
        return "none"
    # the other error cases raise before the process group is read and
    # are checked in the test process
    out["moe_3_experts"] = np.array(error(lambda: DINOSeg(
        head="moe", n_experts=3, n_blocks=1, random_init=True,
        device="cpu").predict_batch(frames[:1], parallelism="tp")))
    with open(cfg["out"], "wb") as fh:
        np.savez(fh, **out)
""")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_log_probs(jm, frames, **kw):
    x = jax_preprocess(jnp.asarray(frames), RES)
    return np.asarray(jax_seg_forward(jm.vit_params, jm.head_params, jm.cfg,
                                      jm.head, pre_normalized=x, **kw))


def _port(jm, **kw):
    pm = DINOSeg(n_blocks=DEPTH, n_classes=N_CLASSES, precision="fp32",
                 random_init=True, device="cpu", **kw)
    pm.load_state_dict(from_jax_params(_np(jm.vit_params),
                                       _np(jm.head_params)))
    pm.set_resolution(RES)
    return pm


def _small():
    """The 2-head model (random weights from seed 3) and its step's batch."""
    cfg = ViTConfig(patch_size=8, embed_dim=SMALL_D, num_heads=2)
    from dino_tpu_torch.models.heads import init_head
    from dino_tpu_torch.models.vit import VisionTransformer, init_vit_params
    g = torch.Generator().manual_seed(3)
    vit = init_vit_params(VisionTransformer(cfg, depth=2), g)
    head = init_head("mlp", N_CLASSES, SMALL_D, generator=g)
    rs = np.random.RandomState(4)
    return cfg, vit, head, dict(
        small_x=rs.randn(2, 48, 48, 3).astype(np.float32),
        small_imgs=rs.randint(0, 255, (2, 48, 48, 3)).astype(np.uint8),
        small_labels=rs.randint(0, N_CLASSES, (2, 36)).astype(np.int32))


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """dino_tpu's models and predictions; the rank worlds, started in the
    background on the inputs before dino_tpu's predictions are computed
    (``refs["worlds"]``: world -> a future of its ranks' results)."""
    rs = np.random.RandomState(0)
    frames = rs.randint(0, 255, (BATCH, RES, RES, 3), np.uint8)
    jm = JaxDINOSeg(head="mlp", n_blocks=DEPTH, n_classes=N_CLASSES,
                    random_init=True, seed=0, precision="fp32")
    jm.set_resolution(RES)
    jmoe = JaxDINOSeg(head="moe", n_experts=4, n_blocks=DEPTH,
                      n_classes=N_CLASSES, random_init=True, seed=1,
                      precision="fp32")
    jm2 = JaxDINOSeg(head="mlp", n_blocks=DEPTH, n_classes=N_CLASSES,
                     random_init=True, seed=2, precision="fp32")
    _, vit, head, small = _small()
    arrays = dict(frames=frames, **small)
    for prefix, m in (("mlp.", jm), ("moe.", jmoe), ("mlp2.", jm2)):
        sd = from_jax_params(_np(m.vit_params), _np(m.head_params))
        arrays.update({prefix + k: v.numpy() for k, v in sd.items()})
    for prefix, mod in (("small.vit.", vit), ("small.head.", head)):
        arrays.update({prefix + k: v.numpy()
                       for k, v in mod.state_dict().items()})
    tmp = tmp_path_factory.mktemp("tp")
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **arrays)
    pool = ThreadPoolExecutor(2)
    started = {w: pool.submit(_spawn, tmp, inputs, w) for w in (2, 4)}
    pool.shutdown(wait=False)
    return dict(
        frames=frames, jm=jm, jmoe=jmoe, jm2=jm2, worlds=started,
        plain=jm.predict_batch(frames),
        tp=jm.predict_batch(frames, parallelism="tp"),
        logp=_jax_log_probs(jm, frames),
        moe_logp={d: _jax_log_probs(jmoe, frames, moe_dispatch=d)
                  for d in ("dense", "sparse")})


def _spawn(tmp, inputs, world):
    outs = spawn_ranks(tmp, world, _RANK, dict(
        inputs=inputs, res=RES, small_d=SMALL_D, small_lr=SMALL_LR),
        tag="tp")
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def worlds(refs):
    return {w: f.result() for w, f in refs["worlds"].items()}


@pytest.fixture(scope="module")
def port(refs):
    """The port's world-of-one models on dino_tpu's weights, and their
    log-probs (fp32, and bf16 with its labels) on the frames."""
    imgs = torch.from_numpy(refs["frames"])
    pm = _port(refs["jm"], head="mlp")
    out = dict(pm=pm, lp=pm.log_probs(imgs).numpy(),
               bf16=pm.predict_batch(refs["frames"], precision="bf16"),
               bf16_lp=pm.log_probs(imgs, precision="bf16").float().numpy())
    for d in ("dense", "sparse"):
        out["moe_lp_" + d] = _port(refs["jmoe"], head="moe", n_experts=4,
                                   moe_dispatch=d).log_probs(imgs).numpy()
    return out


def _near_ties(logp):
    top2 = np.sort(logp, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) < MARGIN


def _patches(maps):
    f = 480 // OUT
    return maps[:, ::f, ::f].reshape(-1)


def _assert_labels(got, want, logp, margin=MARGIN):
    """Label maps equal at every patch whose top-2 gap in ``logp`` is at
    least ``margin``."""
    assert got.shape == want.shape and got.dtype == np.int32
    top2 = np.sort(logp, axis=-1)[:, -2:]
    far = (top2[:, 1] - top2[:, 0]) >= margin
    diff = _patches(got) != _patches(want)
    assert not (diff & far).any(), int((diff & far).sum())


@pytest.mark.parametrize("world", [2, 4])
def test_tp_fp32_labels_match_dino_tpu(refs, worlds, world):
    """fp32 labels equal dino_tpu's plain predict_batch (and its 'tp' one)
    except at near ties; predict, predict_stream and predict_batch agree."""
    r0 = worlds[world][0]
    _assert_labels(r0["fp32"], refs["plain"], refs["logp"])
    _assert_labels(r0["fp32"], refs["tp"], refs["logp"])
    np.testing.assert_array_equal(r0["one"], r0["fp32"][0])
    np.testing.assert_array_equal(r0["stream"], r0["fp32"])


@pytest.mark.parametrize("world", [2, 4])
def test_tp_ranks_return_the_same_bits(worlds, world):
    results = worlds[world]
    for key in ("fp32", "bf16", "lp", "after", "moe_dense", "moe_sparse",
                "moe_lp_dense", "small_tokens", "small_loss"):
        for r in results[1:]:
            np.testing.assert_array_equal(r[key], results[0][key], key)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_log_probs_match_world_of_one(port, worlds, world):
    want = port["lp"]
    got = worlds[world][0]["lp"]
    assert np.abs(got - want).max() <= LOGP_REL * np.abs(want).max()


@pytest.mark.parametrize("world", [2, 4])
def test_tp_bf16_labels_match_world_of_one(port, worlds, world):
    """bf16 over the ranks against the port's bf16 world of one, except at
    top-2 gaps under BF16_MARGIN (the TP block rounds fc1 before its GELU,
    as dino_tpu's tp_block_apply; the single-device block does not)."""
    _assert_labels(worlds[world][0]["bf16"], port["bf16"], port["bf16_lp"],
                   BF16_MARGIN)


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
@pytest.mark.parametrize("world", [2, 4])
def test_tp_moe_experts_split_over_the_ranks(refs, port, worlds, world,
                                             dispatch):
    """The MoE head with its 4 experts split over the ranks: labels
    dino_tpu's except near ties, log-probs the world of one's."""
    r0 = worlds[world][0]
    logp = refs["moe_logp"][dispatch]
    want = np.argmax(logp, axis=-1)
    far = ~_near_ties(logp)
    diff = _patches(r0["moe_" + dispatch]) != want
    assert not (diff & far).any()
    mine = port["moe_lp_" + dispatch]
    got = r0["moe_lp_" + dispatch]
    assert np.abs(got - mine).max() <= LOGP_REL * np.abs(mine).max()


@pytest.mark.parametrize("world", [2, 4])
def test_tp_cache_rebuilt_after_a_weight_change(refs, worlds, world):
    """The sharded serving weights are cached until the weights change;
    after a load_state_dict the labels are the new weights' (dino_tpu's
    model of seed 2, except near ties)."""
    r0 = worlds[world][0]
    assert r0["cache"].tolist() == [True, True]
    jm2 = refs["jm2"]
    jm2.set_resolution(RES)
    _assert_labels(r0["after"], jm2.predict_batch(refs["frames"]),
                   _jax_log_probs(jm2, refs["frames"]))


def _error(fn):
    try:
        fn()
    except Exception as e:  # the type is the result
        return type(e).__name__
    return "none"


def _jax_error(case, refs):
    """The error type of dino_tpu's predict for one case.  Its backbone
    check runs on a stand-in model: it reads only the backbone's name, and
    a random ResNet-50 takes seconds to build."""
    import types
    frames, jm = refs["frames"], refs["jm"]
    return _error({
        "moe_3_experts": lambda: JaxDINOSeg(
            head="moe", n_experts=3, n_blocks=1, random_init=True,
            seed=0).predict_batch(frames[:1], parallelism="tp"),
        "int8": lambda: jm.predict_batch(frames[:1], precision="int8",
                                         parallelism="tp"),
        "cnn1": lambda: JaxDINOSeg._serving_params(
            types.SimpleNamespace(backbone="cnn1", precision="fp32"), None,
            "tp"),
        "pp": lambda: jm.predict(frames[0], parallelism="pp")}[case])


@pytest.mark.parametrize("case", ["moe_3_experts", "int8", "cnn1", "pp"])
def test_tp_errors_are_dino_tpu_s(refs, port, worlds, case):
    """The errors of predict(parallelism='tp') are dino_tpu's types: a MoE
    head whose experts do not split over the world (over the ranks); int8,
    a ResNet backbone and 'pp', which raise before the process group is
    read (here)."""
    want = _jax_error(case, refs)
    assert want == "ValueError"
    frames, pm = refs["frames"], port["pm"]
    if case == "moe_3_experts":
        got = [str(r[case]) for w in (2, 4) for r in worlds[w]]
    else:
        got = [_error({
            "int8": lambda: pm.predict_batch(frames[:1], precision="int8",
                                             parallelism="tp"),
            "cnn1": lambda: DINOSeg(backbone="cnn1", random_init=True,
                                    device="cpu").predict_batch(
                frames[:1], parallelism="tp"),
            "pp": lambda: pm.predict_batch(frames[:1],
                                           parallelism="pp")}[case])]
    assert set(got) == {want}


def test_tp_ranks_without_heads(worlds):
    """At 4 ranks a 2-head model leaves ranks 2 and 3 without a head: they
    run no attention, join every all-reduce, and the forward and the train
    step's gradients are the world of one's."""
    from dino_tpu_torch.models.vit import vit_forward
    from dino_tpu_torch.train.loop import (init_opt_state, make_optimizer,
                                           make_train_step)
    cfg, vit, head, small = _small()
    results = worlds[4]
    assert [r["small_heads"].tolist() for r in results] == [
        [1, 1], [1, 1], [0, 0], [0, 0]]
    with torch.no_grad():
        want = vit_forward(vit, torch.from_numpy(small["small_x"]), cfg)
    got = results[0]["small_tokens"]
    np.testing.assert_allclose(got, want.numpy(), atol=2e-5, rtol=1e-5)
    opt = make_optimizer("adam", SMALL_LR)
    loss, _ = make_train_step(cfg, "mlp", N_CLASSES, opt, False)(
        vit, head, init_opt_state(opt, vit, head, False),
        torch.from_numpy(small["small_imgs"]),
        torch.from_numpy(small["small_labels"]))
    np.testing.assert_allclose(results[0]["small_loss"], loss.item(),
                               rtol=1e-5)
    for name, p in vit.named_parameters():
        g = p.grad.numpy()
        err = np.abs(results[0]["small_grad." + name] - g).max()
        assert err <= GRAD_REL * np.abs(g).max(), name


# ---------------------------------------------------------------------------
# In this process
# ---------------------------------------------------------------------------

def test_tp_pack_block_matches_dino_tpu():
    """The head-aligned packing is dino_tpu's, bit for bit."""
    jcfg = JaxViTConfig(patch_size=8)
    vit_p = _np(jax_init_vit(jax.random.PRNGKey(0), jcfg, depth=1))
    vit = VisionTransformer(ViTConfig(patch_size=8), depth=1)
    vit.load_state_dict(strip_prefix(from_jax_params(vit_p), "dino."))
    want = jtp.tp_pack_block(vit_p["blocks"][0], jcfg)
    got = ttp.tp_pack_block(vit.blocks[0], vit.cfg)
    for k in ("qkv_w", "qkv_b", "proj_w", "proj_b", "fc1_w", "fc1_b",
              "fc2_w", "fc2_b"):
        np.testing.assert_array_equal(got[k].detach().numpy(),
                                      np.asarray(want[k]), k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("layer", ["qkv", "fc1"])
def test_tp_column_parallel_is_the_single_rank_layer(refs, port, world,
                                                     layer):
    """Each rank's column-parallel qkv and fc1 give the single-rank layer's
    bits on its columns (at the predict shapes: 3 frames of 65 tokens)."""
    pm = port["pm"]
    cfg, blk = pm.cfg, pm.model.dino.blocks[0]
    with torch.no_grad():
        x = preprocess(torch.from_numpy(refs["frames"]), RES)
        tokens = prepare_tokens(pm.model.dino, x, cfg)
        nh, hd, c = cfg.num_heads, cfg.head_dim, cfg.embed_dim
        if layer == "qkv":
            h = layer_norm(blk.norm1, tokens, cfg.ln_eps)
            full = dense(h, blk.attn.qkv.weight, blk.attn.qkv.bias)
            full = full.reshape(*h.shape[:2], 3, nh, hd)
        else:
            h = layer_norm(blk.norm2, tokens, cfg.ln_eps)
            full = affine(blk.mlp.fc1, h)
        groups = ttp.head_groups(nh, world)
        k = cfg.mlp_hidden // world
        for rank in range(world):
            p = ttp.tp_rank_slice(ttp.tp_pack_block(blk, cfg), cfg, rank,
                                  world)
            if layer == "qkv":
                h0, h1 = groups[rank]
                got = ttp.qkv_local(p, h).reshape(*h.shape[:2], h1 - h0, 3,
                                                  hd)
                want = full[:, :, :, h0:h1].permute(0, 1, 3, 2, 4)
            else:
                got = ttp.fc1_local(p, h)
                want = full[..., rank * k:(rank + 1) * k]
            assert torch.equal(got, want), rank
    assert c == 384


@pytest.mark.parametrize("world", range(1, 9))
def test_tp_worlds_are_dino_tpu_s(world):
    """The port accepts a world exactly where dino_tpu's TP sharding does
    (the qkv, proj and fc1 widths must divide: 5 and 7 do not)."""
    jcfg = JaxViTConfig(patch_size=8)
    vit_p = _np(jax_init_vit(jax.random.PRNGKey(0), jcfg, depth=1))
    try:
        shard_params(vit_p, vit_param_spec(1),
                     make_mesh(world, model_axis=world))
        jax_ok = True
    except ValueError:
        jax_ok = False
    try:
        ttp.check_tp_world(ViTConfig(patch_size=8), world)
        port_ok = True
    except ValueError:
        port_ok = False
    assert port_ok == jax_ok


def test_head_groups():
    assert ttp.head_groups(6, 4) == [(0, 2), (2, 4), (4, 5), (5, 6)]
    assert ttp.head_groups(6, 2) == [(0, 3), (3, 6)]
    assert ttp.head_groups(6, 8)[6:] == [(6, 6), (6, 6)]


def test_tp_predict_needs_a_process_group(refs, port):
    with pytest.raises(RuntimeError, match="init_distributed_mode"):
        port["pm"].predict(refs["frames"][0], parallelism="tp")
