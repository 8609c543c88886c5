"""SP x TP and DP x TP (with ZeRO-1) of the port on a 2 x 2 grid of gloo
ranks against dino_tpu on its virtual mesh, on the CPU.

dino_tpu's test config (tests/test_ring_attention.py, test_sharding.py):
ViT with D 64, 2 heads, 2 blocks, MLP head, 5 classes, 48px, Adam 1e-3.
One module-scoped world of four rank processes (parallel/mesh.py:make_grid
(2): data 2 x model 2; tests/test_torch_port_multiprocess.py:spawn_ranks;
they import neither jax nor dino_tpu) runs:

  * ``vit_forward_sp_tp`` against dino_tpu's on ``make_mesh(4,
    model_axis=2)``;
  * one ``make_sp_tp_train_step`` step (batch 3, a ragged mask) against
    dino_tpu's: loss, confusion matrix, the parameters after the update,
    and every gradient against the port's world-of-one step, before the
    update (a gradient summed where it should not be is off by a factor);
  * one DP x TP step (``make_train_step(tp_group=..., dp_group=...)`` on
    each rank's shard, global batch 4) without and with ZeRO-1, against
    dino_tpu's ``make_train_step(zero_param_spec=...)``: the same bits with
    and without ZeRO, the gradients as above, each moment shard ceil(n/2)
    elements of the rank's slice, and a second step on the sharded state.
"""
import json
import math
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from dino_tpu.models.heads import init_head as jax_init_head
from dino_tpu.models.vit import ViTConfig as JaxViTConfig
from dino_tpu.models.vit import init_vit_params as jax_init_vit
from dino_tpu.parallel import ring_attention as jring
from dino_tpu.parallel.mesh import (head_param_spec, make_mesh, shard_params,
                                    vit_param_spec)
from dino_tpu.train import loop as jloop
from dino_tpu_torch.checkpointing.convert import from_jax_params
from dino_tpu_torch.parallel import ring_attention as tring
from dino_tpu_torch.models.vit import ViTConfig
from tests.test_torch_port_multiprocess import spawn_ranks

D, HEADS, DEPTH, RES, N_CLASSES, LR = 64, 2, 2, 48, 5, 1e-3
N_PATCH = (RES // 8) ** 2
FWD_TOL = dict(atol=5e-5, rtol=1e-4)    # tests/test_ring_attention.py:72
PARAM_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_sharding.py:188
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5  # each gradient leaf against its max, world of one

_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    cfg = json.loads(sys.argv[1])
    from dino_tpu_torch.checkpointing.convert import strip_prefix
    from dino_tpu_torch.models.heads import MLPHead
    from dino_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from dino_tpu_torch.parallel import dist as pd
    from dino_tpu_torch.parallel.mesh import make_grid
    from dino_tpu_torch.parallel.ring_attention import (
        make_sp_tp_train_step, vit_forward_sp_tp)
    from dino_tpu_torch.parallel.tp import tp_gather_state, tp_shard_vit
    from dino_tpu_torch.train.loop import (init_opt_state, make_optimizer,
                                           make_train_step)
    assert not any(m in ("jax", "dino_tpu")
                   or m.startswith(("jax.", "dino_tpu."))
                   for m in sys.modules)

    torch.set_num_threads(1)  # the ranks share the host's cores
    pd.init_distributed_mode("gloo", cfg["init"], cfg["world"], cfg["rank"])
    z = {k: torch.from_numpy(v) for k, v in np.load(cfg["inputs"]).items()}
    tcfg = ViTConfig(patch_size=8, embed_dim=cfg["d"], num_heads=cfg["heads"])
    dg, mg = make_grid(2)
    out = {"grid": np.array([dist.get_process_group_ranks(dg),
                             dist.get_process_group_ranks(mg)])}

    def fresh():
        vit = VisionTransformer(tcfg, depth=cfg["depth"])
        vit.load_state_dict(strip_prefix(z, "dino."))
        head = MLPHead(5, cfg["d"])
        head.load_state_dict(strip_prefix(z, "clf."))
        return vit, head

    def save(prefix, named):
        for k, v in named.items():
            out[prefix + k] = v.detach().numpy().copy()

    vit, head = fresh()
    with torch.no_grad():
        out["fwd"] = vit_forward_sp_tp(vit, z["x"], tcfg, dg, mg).numpy()

    opt = make_optimizer("adam", cfg["lr"])
    step = make_sp_tp_train_step(tcfg, "mlp", 5, opt, dg, mg)
    loss, cm = step(vit, head, init_opt_state(opt, vit, head, False),
                    z["imgs3"], z["labels3"], z["mask3"])
    out["sptp.loss"], out["sptp.cm"] = loss.numpy(), cm.numpy()
    save("sptp.grad.dino.", {k: p.grad for k, p in vit.named_parameters()})
    save("sptp.grad.clf.", {k: p.grad for k, p in head.named_parameters()})
    save("sptp.param.dino.", dict(vit.named_parameters()))
    save("sptp.param.clf.", dict(head.named_parameters()))

    d = dist.get_rank(dg)
    slab = slice(2 * d, 2 * d + 2)
    for mode in ("plain", "zero"):
        vit, head = fresh()
        tvit = tp_shard_vit(vit, mg)
        zm = dg if mode == "zero" else None
        opt_state = init_opt_state(opt, tvit, head, False, zero_mesh=zm)
        step = make_train_step(tcfg, "mlp", 5, opt, False, dp_group=dg,
                               tp_group=mg, zero_mesh=zm)
        if mode == "zero":
            shards = opt_state.shards
            seen = {}
            real = opt_state.inner.step

            def gathered_step():
                # the shard gradients, gathered back whole before the update
                full = shards._gather_flat([s.grad for s in shards.shards])
                seen.update({id(p): g.view(s) for p, g, s in
                             zip(opt_state.params, full, shards.shapes)})
                real()
            opt_state.inner.step = gathered_step
        loss, cm = step(tvit, head, opt_state, z["imgs4"][slab],
                        z["labels4"][slab])
        out[mode + ".loss"], out[mode + ".cm"] = loss.numpy(), cm.numpy()
        if mode == "zero":
            for p in list(tvit.parameters()) + list(head.parameters()):
                p.grad = seen[id(p)]
            names = {id(p): n for n, p in
                     list(tvit.named_parameters())
                     + [("head." + n, p) for n, p in head.named_parameters()]}
            out["zero.moments"] = np.array(json.dumps([
                [names[id(p)], n, int(opt_state.inner.state[sh][
                    "exp_avg"].numel())]
                for p, sh, n in zip(opt_state.params, shards.shards,
                                    shards.numels)]))
            out["zero.moment_bytes"] = np.array(
                opt_state.resident_bytes()["moments"])
        save(mode + ".grad.dino.", tp_gather_state(tvit, mg, grads=True))
        save(mode + ".grad.clf.", {k: p.grad for k, p in
                                   head.named_parameters()})
        save(mode + ".param.dino.", tp_gather_state(tvit, mg))
        save(mode + ".param.clf.", dict(head.named_parameters()))
        if mode == "zero":
            loss2, _ = step(tvit, head, opt_state, z["imgs4"][slab],
                            z["labels4"][slab])
            out["zero.loss2"] = loss2.numpy()
            save("zero.param2.dino.", tp_gather_state(tvit, mg))

    try:  # 3 heads do not split over the model group of 2
        vit_forward_sp_tp(VisionTransformer(
            ViTConfig(patch_size=8, embed_dim=192, num_heads=3), depth=1),
            z["x"], ViTConfig(patch_size=8, embed_dim=192, num_heads=3),
            dg, mg)
        out["heads_error"] = np.array("none")
    except Exception as e:  # the type is the result
        out["heads_error"] = np.array(type(e).__name__)
    with open(cfg["out"], "wb") as fh:
        np.savez(fh, **out)
""")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(vit_p, head_p):
    """dino_tpu pytrees -> {'dino.<torch name>': array, 'clf.<...>'}"""
    return {k: v.numpy() for k, v in from_jax_params(_np(vit_p),
                                                     _np(head_p)).items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """dino_tpu's weights, batches and results; the rank world starts in
    the background before dino_tpu's steps run."""
    from concurrent.futures import ThreadPoolExecutor
    jcfg = JaxViTConfig(patch_size=8, embed_dim=D, depth=DEPTH,
                        num_heads=HEADS)
    vit_p = _np(jax_init_vit(jax.random.PRNGKey(6), jcfg, depth=DEPTH))
    head_p = _np(jax_init_head(jax.random.PRNGKey(7), "mlp", N_CLASSES, D))
    rs = np.random.RandomState(3)
    data = dict(
        x=rs.randn(2, RES, RES, 3).astype(np.float32),
        imgs3=rs.randint(0, 255, (3, RES, RES, 3)).astype(np.uint8),
        labels3=rs.randint(0, N_CLASSES, (3, N_PATCH)).astype(np.int32),
        mask3=np.array([1, 1, 0], np.float32),
        imgs4=rs.randint(0, 255, (4, RES, RES, 3)).astype(np.uint8),
        labels4=rs.randint(0, N_CLASSES, (4, N_PATCH)).astype(np.int32))
    tmp = tmp_path_factory.mktemp("sptp")
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **data, **_flat(vit_p, head_p))
    pool = ThreadPoolExecutor(1)
    ranks = pool.submit(spawn_ranks, tmp, 4, _RANK, dict(
        inputs=inputs, d=D, heads=HEADS, depth=DEPTH, lr=LR), "sptp")
    pool.shutdown(wait=False)

    mesh = make_mesh(4, model_axis=2)
    opt = jloop.make_optimizer("adam", LR)
    fwd = np.asarray(jax.jit(lambda p, x: jring.vit_forward_sp_tp(
        p, x, jcfg, mesh))(vit_p, jnp.asarray(data["x"])))
    sv, sh, _, s_loss, s_cm = jring.make_sp_tp_train_step(
        jcfg, "mlp", N_CLASSES, opt, mesh)(
        vit_p, head_p, jloop.init_opt_state(opt, vit_p, head_p, False),
        data["imgs3"], data["labels3"], data["mask3"])
    vit_s = shard_params(vit_p, vit_param_spec(DEPTH), mesh)
    head_s = shard_params(head_p, head_param_spec("mlp"), mesh)
    zstep = jloop.make_train_step(
        jcfg, "mlp", N_CLASSES, opt, freeze_backbone=False, donate=False,
        zero_mesh=mesh, zero_param_spec={"head": head_param_spec("mlp"),
                                         "vit": vit_param_spec(DEPTH)})
    zv, zh, _, z_loss, z_cm = zstep(
        vit_s, head_s, jloop.init_opt_state(opt, vit_s, head_s, False),
        jax.device_put(jnp.asarray(data["imgs4"]),
                       NamedSharding(mesh, P("data"))),
        jnp.asarray(data["labels4"]))
    return dict(
        data=data, vit=vit_p, head=head_p, fwd=fwd,
        sptp=dict(params=_flat(sv, sh), loss=float(s_loss),
                  cm=np.asarray(s_cm)),
        dptp=dict(params=_flat(zv, zh), loss=float(z_loss),
                  cm=np.asarray(z_cm)),
        ranks=ranks)


@pytest.fixture(scope="module")
def ranks(setup):
    return [dict(np.load(o)) for o in setup["ranks"].result()]


def _world_of_one(setup, imgs, labels, mask=None):
    """The port's single-process unfrozen step on the same weights and
    batch: {'dino.<name>' / 'clf.<name>': gradient}, loss."""
    import torch
    from dino_tpu_torch.models.heads import MLPHead
    from dino_tpu_torch.models.vit import VisionTransformer
    from dino_tpu_torch.train.loop import (init_opt_state, make_optimizer,
                                           make_train_step)
    sd = from_jax_params(setup["vit"], setup["head"])
    cfg = ViTConfig(patch_size=8, embed_dim=D, num_heads=HEADS)
    vit = VisionTransformer(cfg, depth=DEPTH)
    vit.load_state_dict({k[5:]: v for k, v in sd.items()
                         if k.startswith("dino.")})
    head = MLPHead(N_CLASSES, D)
    head.load_state_dict({k[4:]: v for k, v in sd.items()
                          if k.startswith("clf.")})
    opt = make_optimizer("adam", LR)
    loss, _ = make_train_step(cfg, "mlp", N_CLASSES, opt, False)(
        vit, head, init_opt_state(opt, vit, head, False),
        torch.from_numpy(imgs), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    grads = {"dino." + k: p.grad.numpy() for k, p in vit.named_parameters()}
    grads.update({"clf." + k: p.grad.numpy()
                  for k, p in head.named_parameters()})
    return grads, loss.item()


def _leaves(rank, prefix):
    return {k[len(prefix):]: v for k, v in rank.items()
            if k.startswith(prefix)}


def test_make_grid_layout(ranks):
    """Rank r at data index r // 2 and model index r % 2, as dino_tpu's
    make_mesh(4, model_axis=2) lays out its devices."""
    assert [r["grid"].tolist() for r in ranks] == [
        [[0, 2], [0, 1]], [[1, 3], [0, 1]], [[0, 2], [2, 3]],
        [[1, 3], [2, 3]]]


def test_sp_tp_forward_matches_dino_tpu(setup, ranks):
    for r in ranks:
        np.testing.assert_allclose(r["fwd"], setup["fwd"], **FWD_TOL)


@pytest.mark.parametrize("mode", ["sptp", "plain", "zero"])
def test_step_matches_dino_tpu(setup, ranks, mode):
    """Loss, confusion matrix and the parameters after one Adam step against
    dino_tpu's make_sp_tp_train_step (SP x TP) or make_train_step with
    zero_param_spec (DP x TP, without and with ZeRO-1); every rank holds
    the same bits."""
    want = setup["sptp" if mode == "sptp" else "dptp"]
    for r in ranks:
        np.testing.assert_allclose(float(r[mode + ".loss"]), want["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(r[mode + ".cm"], want["cm"])
        got = _leaves(r, mode + ".param.")
        assert set(got) == set(want["params"])
        for k, v in want["params"].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL)
            np.testing.assert_array_equal(got[k], _leaves(
                ranks[0], mode + ".param.")[k], k)


@pytest.fixture(scope="module")
def world_of_one(setup):
    """The port's world-of-one gradients on the SP x TP batch and on the
    DP x TP one."""
    data = setup["data"]
    return {"sptp": _world_of_one(setup, data["imgs3"], data["labels3"],
                                  data["mask3"])[0],
            "dptp": _world_of_one(setup, data["imgs4"],
                                  data["labels4"])[0]}


@pytest.mark.parametrize("mode", ["sptp", "plain", "zero"])
def test_step_gradients_are_the_world_of_one_s(world_of_one, ranks, mode):
    """Every gradient leaf, before the update, within GRAD_REL of its max of
    the port's world-of-one step: a leaf summed over the model group where
    it is whole on each rank, or left unsummed where it is split, is off
    by a factor."""
    want = world_of_one["sptp" if mode == "sptp" else "dptp"]
    for r in ranks:
        got = _leaves(r, mode + ".grad.")
        assert set(got) == set(want)
        for k, g in want.items():
            err = np.abs(got[k] - g).max()
            assert err <= GRAD_REL * np.abs(g).max(), (k, err)


def test_dp_tp_zero_keeps_the_plain_bits(ranks):
    for r in ranks:
        plain, zero = _leaves(r, "plain.param."), _leaves(r, "zero.param.")
        for k, v in plain.items():
            np.testing.assert_array_equal(zero[k], v, k)


def test_dp_tp_zero_moment_shards(ranks):
    """Each moment shard holds ceil(n/2) elements of the rank's slice (a
    block's split weights hold half their heads' and columns' elements),
    and resident_bytes counts two such moments."""
    for r in ranks:
        rows = json.loads(str(r["zero.moments"]))
        by_name = {name: (n, m) for name, n, m in rows}
        assert all(m == math.ceil(n / 2) for n, m in by_name.values())
        assert by_name["blocks.0.qkv_w"][0] == 3 * D * D // 2
        assert by_name["blocks.0.fc1_w"][0] == 4 * D * D // 2
        assert by_name["blocks.0.proj_b"][0] == D
        assert int(r["zero.moment_bytes"]) == 2 * 4 * sum(
            m for _, m in by_name.values())


def test_dp_tp_second_step_on_the_sharded_state(ranks):
    for r in ranks:
        assert np.isfinite(float(r["zero.loss2"]))
        moved = max(np.abs(v - r["zero.param.dino." + k]).max() for k, v in
                    _leaves(r, "zero.param2.dino.").items())
        assert moved > 0
        np.testing.assert_array_equal(r["zero.loss2"], ranks[0]["zero.loss2"])


def test_sp_tp_errors_are_dino_tpu_s(ranks):
    """A model group that does not divide the heads raises ValueError, as
    dino_tpu's vit_forward_sp_tp does; so do heads other than mlp/linear."""
    jcfg = JaxViTConfig(patch_size=8, embed_dim=192, depth=1, num_heads=3)
    with pytest.raises(ValueError, match="num_heads"):  # before any weight
        jring.vit_forward_sp_tp({}, jnp.zeros((1, RES, RES, 3)), jcfg,
                                make_mesh(4, model_axis=2))
    assert all(str(r["heads_error"]) == "ValueError" for r in ranks)
    with pytest.raises(ValueError, match="mlp/linear"):
        jring.make_sp_tp_train_step(jcfg, "moe", N_CLASSES, None,
                                    make_mesh(4, model_axis=2))
    with pytest.raises(ValueError, match="mlp/linear"):
        tring.make_sp_tp_train_step(ViTConfig(), "moe", N_CLASSES, None)
