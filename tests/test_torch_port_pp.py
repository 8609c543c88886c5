"""Pipeline parallelism of the port (``parallel/pipeline.py``) over gloo
ranks against dino_tpu, on the CPU.

dino_tpu's test sizes (tests/test_pipeline.py): ViT with D 64, 2 heads,
48px, depth 8 (4 for the 3-axis step), 5 classes, Adam 1e-3, dino_tpu's
random init carried to the port.  One module-scoped world per layout, its
ranks real gloo processes (tests/test_torch_port_multiprocess.py:
spawn_ranks) that import neither jax nor dino_tpu; the inputs reach them as
``.npz``, and a hung hop is cut by CHILD_TIMEOUT:

  * S = 2: the pipelined forward; 1F1B and interleaved 1F1B (V = 2, M =
    4), each also with a ragged mask and in bf16 (beside the port's own
    bf16 step); GPipe with the MoE head (dense dispatch) and GPipe with
    ``remat``; the interleaved fill-drain with ``waves=2``;
  * S = 4: the pipelined forward; 1F1B with M = 6 (a partial last group)
    and interleaved 1F1B with V = 2;
  * data 2 x stage 2 x model 2 (eight ranks, ``make_grid(2, stage=2)``):
    ``vit_forward_pp_tp`` and ``make_dp_pp_tp_train_step`` (with and
    without ``remat``).

The reference is dino_tpu's replicated step: ``jax.value_and_grad`` of its
loss (every gradient leaf, checked before the update, so a gradient summed
once too often fails) and its Adam update of those gradients.  dino_tpu's
own PP step is run where the port claims its contract: one
``make_pp_1f1b_train_step(scan=True)`` for the loss and confusion matrix.
"""
import functools
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dino_tpu.models import heads as jheads
from dino_tpu.models.heads import init_head as jax_init_head
from dino_tpu.models.vit import ViTConfig as JaxViTConfig
from dino_tpu.models.vit import init_vit_params as jax_init_vit
from dino_tpu.models.vit import vit_forward as jax_vit_forward
from dino_tpu.parallel import pipeline as jpp
from dino_tpu.train import loop as jloop
from dino_tpu.train import metrics as jmetrics
from dino_tpu_torch.checkpointing.convert import from_jax_params
from dino_tpu_torch.models.vit import ViTConfig
from dino_tpu_torch.parallel import pipeline as tpp
from tests.test_torch_port_multiprocess import spawn_ranks

D, HEADS, RES, N_CLASSES, LR = 64, 2, 48, 5, 1e-3
N_PATCH = (RES // 8) ** 2
DEPTH, DEPTH3 = 8, 4
FWD_TOL = dict(atol=1e-5, rtol=1e-5)    # tests/test_pipeline.py:23-24
PARAM_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_pipeline.py:94
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5  # each gradient leaf against its max
N_REAL = 5       # the ragged batch: 3 of 8 samples padded

# case -> (world, reference batch, head); the steps each rank runs
CASES = {
    "1f1b": (2, "b8", "mlp"), "i1f1b": (2, "b8", "mlp"),
    "1f1b_mask": (2, "b8m", "mlp"), "i1f1b_mask": (2, "b8m", "mlp"),
    "gpipe_moe": (2, "b8", "moe"), "gpipe_remat": (2, "b8", "mlp"),
    "waves": (2, "b8", "mlp"),
    "1f1b_m6": (4, "b12", "mlp"), "i1f1b_m6": (4, "b12", "mlp"),
    "dpp_tp": (8, "b4", "mlp"), "dpp_tp_remat": (8, "b4", "mlp"),
}
# compute_dtype=bfloat16 (S = 2, M = 4): the loss and the parameters after
# one step against dino_tpu's bf16 replicated step at its bf16 bounds
# (tests/test_pipeline.py:403-408: loss atol/rtol 2e-2, parameters atol
# 5e-3 / rtol 5e-2).  The gradients, which read the bf16 stash, both bf16
# hops and the pending cotangent, are held to the port's own bf16
# make_train_step on the same four microbatches (accum_steps=4), within
# 2e-2 of each leaf's max: bf16 keeps 8 bits, and the pipeline and the
# world of one round the block boundaries' activations and cotangents
# apart.  (dino_tpu's bf16 gradient is another rounding of the same
# function: the port's casts are torch autocast's, not jnp's.)
BF16_CASES = ("1f1b_bf16", "i1f1b_bf16")
BF16_LOSS_TOL = dict(atol=2e-2, rtol=2e-2)
BF16_PARAM_TOL = dict(atol=5e-3, rtol=5e-2)
BF16_GRAD_REL = 2e-2

_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    cfg = json.loads(sys.argv[1])
    from dino_tpu_torch.checkpointing.convert import strip_prefix
    from dino_tpu_torch.models.heads import MLPHead, MoEHead
    from dino_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from dino_tpu_torch.parallel import dist as pd
    from dino_tpu_torch.parallel import pipeline as pp
    from dino_tpu_torch.parallel.mesh import make_grid
    from dino_tpu_torch.train.loop import (init_opt_state, make_optimizer,
                                           make_train_step)
    assert not any(m in ("jax", "dino_tpu")
                   or m.startswith(("jax.", "dino_tpu."))
                   for m in sys.modules)

    torch.set_num_threads(1)  # the ranks share the host's cores
    pd.init_distributed_mode("gloo", cfg["init"], cfg["world"], cfg["rank"])
    z = {k: torch.from_numpy(v) for k, v in np.load(cfg["inputs"]).items()}
    tcfg = ViTConfig(patch_size=8, embed_dim=cfg["d"], num_heads=cfg["heads"])
    G = dist.group.WORLD
    out = {}

    def fresh(prefix, head_type="mlp", depth=cfg["depth"]):
        vit = VisionTransformer(tcfg, depth=depth)
        vit.load_state_dict(strip_prefix(z, prefix + "dino."))
        head = (MoEHead(5, cfg["d"], 4) if head_type == "moe"
                else MLPHead(5, cfg["d"]))
        head.load_state_dict(strip_prefix(z, prefix + "clf."))
        return vit, head

    def save(prefix, named):
        for k, v in named.items():
            out[prefix + k] = v.detach().numpy().copy()

    def stage_case(name, make, head_type="mlp", batch="8", mask=None,
                   chunks=1):
        vit, head = fresh("moe." if head_type == "moe" else "", head_type)
        svit = pp.pp_shard_vit(vit, G, chunks)
        opt = make_optimizer("adam", cfg["lr"])
        opt_state = init_opt_state(opt, svit, head, False)
        step = make(opt)
        args = (z["imgs" + batch], z["labels" + batch])
        res = step(svit, head, opt_state, *args,
                   *(() if mask is None else (z[mask],)))
        loss, cm = res if isinstance(res, tuple) else (res, None)
        out[name + ".loss"] = loss.numpy()
        if cm is not None:
            out[name + ".cm"] = cm.numpy()
        save(name + ".grad.dino.", pp.pp_gather_state(svit, vit, G,
                                                      grads=True))
        save(name + ".grad.clf.", {k: p.grad for k, p in
                                   head.named_parameters()})
        save(name + ".param.dino.", pp.pp_gather_state(svit, vit, G))
        save(name + ".param.clf.", dict(head.named_parameters()))
        held = {id(p) for p in list(svit.parameters())
                + list(head.parameters())}
        out[name + ".held"] = np.array(svit.block_ids)
        out[name + ".moments"] = np.array([
            set(id(p) for p in opt_state.state) == held,
            sum(s["exp_avg"].numel() for s in opt_state.state.values())
            == sum(p.numel() for p in list(svit.parameters())
                   + list(head.parameters()))])

    if cfg["layout"] in ("s2", "s4"):
        vit, _ = fresh("")
        for m in (1, 2, 4):
            with torch.no_grad():
                out["fwd.m%d" % m] = pp.vit_forward_pipelined(
                    pp.pp_shard_vit(vit, G), z["x4"], tcfg, G,
                    n_microbatches=m).numpy()
    if cfg["layout"] == "s2":
        one = lambda opt: pp.make_pp_1f1b_train_step(  # noqa: E731
            tcfg, "mlp", 5, opt, G, n_microbatches=4)
        inter = lambda opt: pp.make_pp_interleaved_1f1b_train_step(  # noqa
            tcfg, "mlp", 5, opt, G, n_chunks=2, n_microbatches=4)
        stage_case("1f1b", one)
        stage_case("i1f1b", inter, chunks=2)
        vit, head = fresh("")  # the port's world of one, the same microbatches
        opt = make_optimizer("adam", cfg["lr"])
        make_train_step(tcfg, "mlp", 5, opt, False, accum_steps=4,
                        compute_dtype=torch.bfloat16)(
            vit, head, init_opt_state(opt, vit, head, False), z["imgs8"],
            z["labels8"])
        save("plain_bf16.grad.dino.", {k: p.grad for k, p in
                                       vit.named_parameters()})
        save("plain_bf16.grad.clf.", {k: p.grad for k, p in
                                      head.named_parameters()})
        for name, chunks in (("1f1b_bf16", 1), ("i1f1b_bf16", 2)):
            stage_case(name, lambda opt, c=chunks: pp.make_pp_1f1b_train_step(
                tcfg, "mlp", 5, opt, G, n_microbatches=4,
                compute_dtype=torch.bfloat16) if c == 1 else
                pp.make_pp_interleaved_1f1b_train_step(
                    tcfg, "mlp", 5, opt, G, n_chunks=2, n_microbatches=4,
                    compute_dtype=torch.bfloat16), chunks=chunks)
        stage_case("1f1b_mask", one, mask="mask8")
        stage_case("i1f1b_mask", inter, mask="mask8", chunks=2)
        stage_case("gpipe_moe", lambda opt: pp.make_pp_train_step(
            tcfg, "moe", 5, opt, G, n_microbatches=2), head_type="moe")
        stage_case("gpipe_remat", lambda opt: pp.make_pp_train_step(
            tcfg, "mlp", 5, opt, G, n_microbatches=4, remat=True))
        stage_case("waves", lambda opt: pp.make_pp_interleaved_train_step(
            tcfg, "mlp", 5, opt, G, n_chunks=2, n_microbatches=2, waves=2),
            chunks=2)
    elif cfg["layout"] == "s4":
        stage_case("1f1b_m6", lambda opt: pp.make_pp_1f1b_train_step(
            tcfg, "mlp", 5, opt, G, n_microbatches=6), batch="12")
        stage_case("i1f1b_m6",
                   lambda opt: pp.make_pp_interleaved_1f1b_train_step(
                       tcfg, "mlp", 5, opt, G, n_chunks=2, n_microbatches=6),
                   batch="12", chunks=2)
    else:
        dg, sg, mg = make_grid(2, stage=2)
        out["grid"] = np.array([dist.get_process_group_ranks(g)
                                for g in (dg, sg, mg)])
        vit, _ = fresh("d4.", depth=4)
        with torch.no_grad():
            for flash in ("off", "auto"):
                out["fwd3." + flash] = pp.vit_forward_pp_tp(
                    vit, z["x4"], tcfg, dg, sg, mg, n_microbatches=2,
                    flash=flash).numpy()
        for name, remat in (("dpp_tp", False), ("dpp_tp_remat", True)):
            vit, head = fresh("d4.", depth=4)
            opt = make_optimizer("adam", cfg["lr"])
            step = pp.make_dp_pp_tp_train_step(
                tcfg, "mlp", 5, opt, dg, sg, mg, n_microbatches=2,
                remat=remat)
            loss, cm = step(vit, head, init_opt_state(opt, vit, head, False),
                            z["imgs4"], z["labels4"])
            out[name + ".loss"], out[name + ".cm"] = loss.numpy(), cm.numpy()
            save(name + ".grad.dino.", {k: p.grad for k, p in
                                        vit.named_parameters()})
            save(name + ".grad.clf.", {k: p.grad for k, p in
                                       head.named_parameters()})
            save(name + ".param.dino.", dict(vit.named_parameters()))
            save(name + ".param.clf.", dict(head.named_parameters()))
    with open(cfg["out"], "wb") as fh:
        np.savez(fh, **out)
""")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(vit_p, head_p):
    """dino_tpu pytrees -> {'dino.<torch name>': array, 'clf.<...>'}"""
    return {k: v.numpy() for k, v in from_jax_params(_np(vit_p),
                                                     _np(head_p)).items()}


def _jcfg(depth):
    return JaxViTConfig(patch_size=8, embed_dim=D, depth=depth,
                        num_heads=HEADS)


@functools.lru_cache(maxsize=None)
def _value_and_grad(depth, head_type, compute_dtype=None):
    """dino_tpu's loss of the replicated step and its gradient, jitted once
    per (depth, head, compute dtype): the batch, labels and weights are
    arguments."""
    def jloss(params, images, y, w):
        sink = {}
        logp = jloop.seg_forward(params["vit"], params["head"], _jcfg(depth),
                                 head_type, images, use_flash=False,
                                 compute_dtype=compute_dtype, feat_sink=sink)
        loss = jloop.nll_loss(logp, y, w)
        if head_type == "moe":
            loss = loss + 0.01 * jheads.moe_balance_loss(
                params["head"], sink["feats"], weights=w)
        return loss, logp
    return jax.jit(jax.value_and_grad(jloss, has_aux=True))


@functools.lru_cache(maxsize=None)
def _adam_step(depth, head_type):
    """dino_tpu's optimizer (make_optimizer('adam')) from a fresh state,
    one update, jitted once per parameter tree."""
    opt = jloop.make_optimizer("adam", LR)

    def update(grads, params):
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates)
    return jax.jit(update)


def _reference(vit_p, head_p, head_type, images, labels, mask=None,
               compute_dtype=None):
    """dino_tpu's replicated step: loss, confusion matrix, gradients and
    the parameters after one Adam step, in the port's names."""
    y = jnp.asarray(labels).reshape(-1)
    m = np.ones(images.shape[0], np.float32) if mask is None else mask
    w = jnp.repeat(jnp.asarray(m), N_PATCH)
    params = {"vit": vit_p, "head": head_p}
    (loss, logp), grads = _value_and_grad(len(vit_p["blocks"]), head_type,
                                          compute_dtype)(
        params, jnp.asarray(images), y, w)
    new = _adam_step(len(vit_p["blocks"]), head_type)(grads, params)
    cm = jmetrics.confusion_matrix(jnp.argmax(logp, axis=-1), y, N_CLASSES,
                                   weights=w)
    return dict(loss=float(loss), cm=np.asarray(cm),
                grads=_flat(grads["vit"], grads["head"]),
                params=_flat(new["vit"], new["head"]))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """dino_tpu's weights, batches and references; the rank worlds start in
    a background thread, one after another, before the references are
    computed on four threads (XLA compiles them side by side)."""
    vit8 = _np(jax_init_vit(jax.random.PRNGKey(0), _jcfg(DEPTH), depth=DEPTH))
    head = _np(jax_init_head(jax.random.PRNGKey(1), "mlp", N_CLASSES, D))
    moe = _np(jax_init_head(jax.random.PRNGKey(2), "moe", N_CLASSES, D))
    vit4 = _np(jax_init_vit(jax.random.PRNGKey(3), _jcfg(DEPTH3),
                            depth=DEPTH3))
    rs = np.random.RandomState(0)
    data = {}
    for b in (8, 12, 4):
        data[f"imgs{b}"] = rs.randint(0, 255, (b, RES, RES, 3)).astype(
            np.uint8)
        data[f"labels{b}"] = rs.randint(0, N_CLASSES, (b, N_PATCH)).astype(
            np.int32)
    data["mask8"] = (np.arange(8) < N_REAL).astype(np.float32)
    data["x4"] = rs.randn(4, RES, RES, 3).astype(np.float32)
    arrays = dict(data, **_flat(vit8, head))
    arrays.update({"moe." + k: v for k, v in _flat(vit8, moe).items()})
    arrays.update({"d4." + k: v for k, v in _flat(vit4, head).items()})
    tmp = tmp_path_factory.mktemp("pp")
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **arrays)

    def worlds():
        out = {}
        for layout, world, depth in (("s2", 2, DEPTH), ("s4", 4, DEPTH),
                                     ("grid", 8, DEPTH3)):
            outs = spawn_ranks(tmp, world, _RANK, dict(
                inputs=inputs, d=D, heads=HEADS, depth=depth, lr=LR,
                layout=layout), tag="pp" + layout)
            out[layout] = [dict(np.load(o)) for o in outs]
        return out
    pool = ThreadPoolExecutor(1)
    ranks = pool.submit(worlds)
    pool.shutdown(wait=False)

    jobs = {
        ("b8", "mlp"): (vit8, head, "mlp", data["imgs8"], data["labels8"]),
        ("b8m", "mlp"): (vit8, head, "mlp", data["imgs8"], data["labels8"],
                         data["mask8"]),
        ("b8", "bf16"): (vit8, head, "mlp", data["imgs8"], data["labels8"],
                         None, jnp.bfloat16),
        ("b8", "moe"): (vit8, moe, "moe", data["imgs8"], data["labels8"]),
        ("b12", "mlp"): (vit8, head, "mlp", data["imgs12"],
                         data["labels12"]),
        ("b4", "mlp"): (vit4, head, "mlp", data["imgs4"], data["labels4"]),
    }

    def forward(depth, vp):
        return np.asarray(jax.jit(lambda p, x: jax_vit_forward(
            p, x, _jcfg(depth), use_flash=False))(vp,
                                                  jnp.asarray(data["x4"])))
    with ThreadPoolExecutor(4) as refs_pool:
        refs = {k: refs_pool.submit(_reference, *a) for k, a in jobs.items()}
        fwd = {depth: refs_pool.submit(forward, depth, vp)
               for depth, vp in ((DEPTH, vit8), (DEPTH3, vit4))}
        scan = refs_pool.submit(_dino_tpu_1f1b_scan, vit8, head, data)
        refs = {k: f.result() for k, f in refs.items()}
        fwd = {k: f.result() for k, f in fwd.items()}
    return dict(data=data, refs=refs, fwd=fwd, scan=scan.result(),
                ranks=ranks)


@pytest.fixture(scope="module")
def ranks(setup):
    return setup["ranks"].result()


def _leaves(rank, prefix):
    return {k[len(prefix):]: v for k, v in rank.items()
            if k.startswith(prefix)}


def _world(ranks, case):
    world = CASES.get(case, (2,))[0]  # the bf16 cases run at S = 2
    return ranks[{2: "s2", 4: "s4", 8: "grid"}[world]]


@pytest.mark.parametrize("layout,m", [("s2", 1), ("s2", 2), ("s2", 4),
                                      ("s4", 1), ("s4", 2), ("s4", 4)])
def test_pipelined_forward_matches_dino_tpu(setup, ranks, layout, m):
    """Every rank returns dino_tpu's vit_forward (atol/rtol 1e-5)."""
    for r in ranks[layout]:
        np.testing.assert_allclose(r["fwd.m%d" % m], setup["fwd"][DEPTH],
                                   **FWD_TOL)


@pytest.mark.parametrize("flash", ["off", "auto"])
def test_pp_tp_forward_matches_dino_tpu(setup, ranks, flash):
    for r in ranks["grid"]:
        np.testing.assert_allclose(r["fwd3." + flash], setup["fwd"][DEPTH3],
                                   **FWD_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_gradients_match_dino_tpu(setup, ranks, case):
    """Every gradient leaf, before the update, within GRAD_REL of its max of
    dino_tpu's replicated gradient, on every rank: the embeddings', the
    norm's and the head's too, so a sum over the stages taken twice (or
    not at all) fails."""
    _, batch, head_type = CASES[case]
    want = setup["refs"][(batch, head_type)]["grads"]
    for r in _world(ranks, case):
        got = _leaves(r, case + ".grad.")
        assert set(got) == set(want)
        for k, g in want.items():
            err = np.abs(got[k] - g).max()
            assert err <= GRAD_REL * np.abs(g).max(), (k, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_loss_and_params_match_dino_tpu(setup, ranks, case):
    """The loss (rtol 1e-5), the confusion matrix (equal, where the step
    returns one) and the parameters after one Adam step (dino_tpu's atol
    2e-4 / rtol 1e-3), every rank the same."""
    _, batch, head_type = CASES[case]
    want = setup["refs"][(batch, head_type)]
    results = _world(ranks, case)
    for r in results:
        np.testing.assert_allclose(float(r[case + ".loss"]), want["loss"],
                                   rtol=LOSS_RTOL)
        if case + ".cm" in r:
            np.testing.assert_array_equal(r[case + ".cm"], want["cm"])
        got = _leaves(r, case + ".param.")
        assert set(got) == set(want["params"])
        for k, v in want["params"].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL)
            np.testing.assert_array_equal(got[k], _leaves(
                results[0], case + ".param.")[k], k)


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_step_matches_dino_tpu(setup, ranks, case):
    """compute_dtype=bfloat16: every gradient leaf before the update (the
    blocks' read the bf16 cotangent hops, the stash ring and the pending
    cotangent) against the port's bf16 world of one, the loss and every
    parameter after one Adam step against dino_tpu's bf16 step, at the
    bf16 bounds above; every rank the same, and the confusion matrix
    counts every patch."""
    want = setup["refs"][("b8", "bf16")]
    results = _world(ranks, case)
    for r in results:
        got, plain = (_leaves(r, case + ".grad."),
                      _leaves(r, "plain_bf16.grad."))
        assert set(got) == set(plain) == set(want["grads"])
        for k, g in plain.items():
            err = np.abs(got[k] - g).max()
            assert err <= BF16_GRAD_REL * np.abs(g).max(), (k, err)
        np.testing.assert_allclose(float(r[case + ".loss"]), want["loss"],
                                   **BF16_LOSS_TOL)
        assert int(r[case + ".cm"].sum()) == 8 * N_PATCH
        got = _leaves(r, case + ".param.")
        for k, v in want["params"].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **BF16_PARAM_TOL)
            np.testing.assert_array_equal(got[k], _leaves(
                results[0], case + ".param.")[k], k)


@pytest.mark.parametrize("case", ["1f1b_mask", "i1f1b_mask"])
def test_ragged_mask_counts_only_real_samples(ranks, case):
    for r in _world(ranks, case):
        assert int(r[case + ".cm"].sum()) == N_REAL * N_PATCH


@pytest.mark.parametrize("case", sorted(
    [c for c in CASES if c[:3] != "dpp"] + list(BF16_CASES)))
def test_stage_holds_only_its_blocks(ranks, case):
    """A rank's stage module holds only its own blocks (contiguous, or
    chunk v*S + s of the interleaved placement) and its optimizer only
    their moments, beside the embeddings', the norm's and the head's."""
    world = CASES.get(case, (2,))[0]
    chunks = 2 if case[0] == "i" or case == "waves" else 1
    for s, r in enumerate(_world(ranks, case)):
        per = DEPTH // (world * chunks)
        want = [(v * world + s) * per + i for v in range(chunks)
                for i in range(per)]
        assert r[case + ".held"].tolist() == want
        assert r[case + ".moments"].tolist() == [True, True]


def test_grid_layout(ranks):
    """Rank r = (d*S + s)*T + t on the (data, stage, model) grid, as
    np.array(devices).reshape(2, 2, 2) with dino_tpu's axis names."""
    want = np.arange(8).reshape(2, 2, 2)
    for r, res in enumerate(ranks["grid"]):
        d, s, t = np.unravel_index(r, (2, 2, 2))
        grid = res["grid"]
        assert grid[0].tolist() == want[:, s, t].tolist()
        assert grid[1].tolist() == want[d, :, t].tolist()
        assert grid[2].tolist() == want[d, s, :].tolist()


def _dino_tpu_1f1b_scan(vit_p, head_p, data):
    """dino_tpu's own 1F1B step (scan form, 2 stages, M = 4) on the 8-batch:
    its loss and confusion matrix."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("stage",))
    stages = jax.device_put(jpp.stack_block_stages(vit_p["blocks"], 2),
                            NamedSharding(mesh, P("stage")))
    rest = {k: v for k, v in vit_p.items() if k != "blocks"}
    opt = jloop.make_optimizer("adam", LR)
    step = jpp.make_pp_1f1b_train_step(_jcfg(DEPTH), "mlp", N_CLASSES, opt,
                                       mesh, n_microbatches=4, scan=True,
                                       use_flash=False)
    *_, loss, cm = step(stages, rest, head_p,
                        jpp.init_pp_train_state(opt, stages, rest, head_p),
                        data["imgs8"], data["labels8"])
    return float(loss), np.asarray(cm)


def test_dino_tpu_1f1b_scan_step_loss_and_cm(setup, ranks):
    """dino_tpu's own 1F1B step (scan form, 2 stages, M = 4) gives the loss
    and the confusion matrix the port's 1F1B ranks give."""
    loss, cm = setup["scan"]
    for r in ranks["s2"]:
        np.testing.assert_allclose(float(r["1f1b.loss"]), loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(r["1f1b.cm"], cm)


def test_errors_are_dino_tpu_s():
    """The step makers and the placement raise dino_tpu's errors."""
    cfg = ViTConfig(patch_size=8, embed_dim=D, num_heads=HEADS)
    jcfg = _jcfg(DEPTH)
    mesh = Mesh(np.array(jax.devices()[:1]), ("stage",))
    for maker, kw, match in (
            ("make_pp_interleaved_train_step", dict(n_microbatches=8),
             "accumulate gradients"),
            ("make_pp_interleaved_train_step",
             dict(n_microbatches=1, waves=0), "waves"),
            ("make_pp_1f1b_train_step", {}, "mlp/linear"),
            ("make_pp_interleaved_1f1b_train_step", {}, "mlp/linear"),
            ("make_pp_interleaved_train_step", {}, "mlp/linear")):
        head = "moe" if match == "mlp/linear" else "mlp"
        with pytest.raises(ValueError, match=match):
            getattr(jpp, maker)(jcfg, head, N_CLASSES, None, mesh, **kw)
        with pytest.raises(ValueError, match=match):
            getattr(tpp, maker)(cfg, head, N_CLASSES, None, **kw)
    for pkg, c in ((jpp, jcfg), (tpp, cfg)):
        with pytest.raises(ValueError, match="dense dispatch"):
            pkg.make_pp_train_step(c, "moe", N_CLASSES, None,
                                   *([mesh] if pkg is jpp else []),
                                   moe_dispatch="sparse")
    with pytest.raises(ValueError, match="not divisible"):
        tpp.stage_block_ids(6, 4, 0)
    with pytest.raises(ValueError, match="not divisible"):
        tpp.stage_block_ids(6, 4, 0, n_chunks=2)
    with pytest.raises(ValueError, match="microbatches"):
        from dino_tpu_torch.models.vit import VisionTransformer
        import torch
        tpp.vit_forward_pipelined(
            tpp.pp_shard_vit(VisionTransformer(cfg, depth=2)),
            torch.zeros(3, RES, RES, 3), cfg, n_microbatches=2)
