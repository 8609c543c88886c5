"""Training over ranks: DINOSeg.fit and evaluate of the port in a world of
two gloo processes against dino_tpu's single-process fit, on the CPU.

The synthetic VOC split of tests/test_train_smoke.py at 64px (3 classes;
12 train, 4 val, 4 test frames and a split of one frame), one block of
ViT-S/8 with the MLP head, batch 4, fp32, the JAX model's random init
carried to the port.  One module-scoped world of two rank processes (a
FileStore under the test's temporary directory, a timeout of its own per
rank; neither imports jax nor dino_tpu) runs every scenario in turn:

  * data parallelism, unfrozen and frozen, against dino_tpu's fit (params
    rtol 1e-4 / atol 1e-5, test_acc atol 1e-6: tests/test_multihost.py's
    gates), every rank's parameters the same bits after every step, only
    rank 0 writing files, early stopping at the same epoch on both;
  * ZeRO-1 with DP's bits, and its resumed run with the uninterrupted
    run's bits; FSDP with DP's bits too (two ranks' sums are order-free),
    its resumed run the uninterrupted one's, and with two microbatches
    the accumulated DP run's bits and dino_tpu's gates; each FSDP rank
    holding ceil(n/2) elements of each unit (a block, the embeddings with
    the final norm, the head) of parameters, gradients and each moment
    between steps, and inside a step at most two units' full parameters
    and one unit's full gradient;
  * fit(parallelism='sp') and SP + ZeRO against dino_tpu's SP fit;
  * evaluate's confusion matrix equal to the world of one's, also with
    fewer samples than ranks; the agreement helpers; one data-parallel
    train step of cnn1 (global BatchNorm statistics) and of the MoE head
    (the routing sums over the ranks) against the world of one's.

In this process: the augmented slabs of every rank, byte for byte
dino_tpu's per rung, and fit's option errors.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from dino_tpu import DINOSeg as JaxDINOSeg
from dino_tpu.data import native_loader as jax_native
from dino_tpu.data.dataset import DuckieSegDataset as JaxDS
from dino_tpu.data.dataset import batched_loader as jax_batched_loader
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.checkpointing.convert import from_jax_params
from dino_tpu_torch.checkpointing.io import flatten_params
from dino_tpu_torch.data import native_loader as port_native
from dino_tpu_torch.data.dataset import (DuckieSegDataset, batched_loader,
                                         epoch_indices)
from dino_tpu_torch.train import loop as tloop
from tests.test_torch_port_multiprocess import spawn_ranks
from tests.test_train_smoke import _make_split

RES, N_CLASSES, BATCH, SAMPLES = 64, 3, 4, 10
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_multihost.py:228-231
ACC_ATOL = 1e-6
# head lr 1e-4, backbone 1e-5: tests/test_torch_port_fit.py's parity rates
LR = {"frozen": 1e-4, "unfrozen": 1e-5}
WORLD = 2


def _kwargs(root, kind, **over):
    kw = dict(data_path=root, head="mlp", n_blocks=1, n_classes=N_CLASSES,
              batch_size=BATCH, lr=LR[kind], optimizer="adam",
              freeze_backbone=kind == "frozen", max_epochs=2,
              random_init=True, augmented=False, train_resolution=RES,
              seed=0, precision="fp32")
    kw.update(over)
    return kw


def _tree(vit, head):
    return {k: np.asarray(v) for k, v in
            flatten_params({"vit": vit, "head": head}).items()}


def _jax_tree(jm):
    return _tree(jax.tree.map(np.asarray, jm.vit_params),
                 jax.tree.map(np.asarray, jm.head_params))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc_dp"))
    _make_split(root, "train", 12, 0)
    _make_split(root, "val", 4, 1)
    _make_split(root, "test", 4, 2)
    one = os.path.join(root, "one")  # fewer samples than ranks
    _make_split(one, "test", 1, 3)
    return root


@pytest.fixture(scope="module")
def jax_runs(root, tmp_path_factory):
    """dino_tpu's single-process fits: unfrozen, frozen and SP (the test
    process's 8 virtual devices: batch 4 does not divide 8, so the DP
    references run one device's math; SP rings over all 8), each with its
    initial weights."""
    tmp = tmp_path_factory.mktemp("jax_dp")
    out = {}
    for name, kind, fit_kw, over in (
            ("unfrozen", "unfrozen", {}, {}),
            ("frozen", "frozen", {}, {}),
            ("sp", "unfrozen", dict(parallelism="sp"), dict(max_epochs=1))):
        jm = JaxDINOSeg(write_path=str(tmp / name),
                        **_kwargs(root, kind, **over))
        init = _jax_tree(jm)
        metrics = jm.fit(samples_per_epoch=SAMPLES, cache_features=False,
                         **fit_kw)
        out[name] = dict(init=init, final=_jax_tree(jm),
                         test_acc=metrics["test_acc"])
    return out


_RANK = """
import hashlib, json, sys
import numpy as np
import torch
cfg = json.loads(sys.argv[1])
torch.set_num_threads(2)
from dino_tpu_torch import DINOSeg
import dino_tpu_torch.api as api
from dino_tpu_torch.checkpointing.async_writer import AsyncCheckpointer
from dino_tpu_torch.checkpointing.convert import to_jax_params
from dino_tpu_torch.checkpointing.io import flatten_params
from dino_tpu_torch.models.heads import init_head
from dino_tpu_torch.models.resnet import build_backbone
from dino_tpu_torch.parallel import dist as pd
from dino_tpu_torch.parallel.mesh import FSDPOptimizer
from dino_tpu_torch.train import loop as tloop
assert not any(m in ("jax", "dino_tpu") or m.startswith(("jax.", "dino_tpu."))
               for m in sys.modules)
pd.init_distributed_mode("gloo", cfg["init"], cfg["world"], cfg["rank"])
rank = cfg["rank"]
inits = {k: {n[len(k) + 1:]: torch.from_numpy(v) for n, v in
             np.load(cfg["inputs"]).items() if n.startswith(k + "/")}
         for k in ("unfrozen", "frozen", "sp")}
log = {"digests": [], "resident": [], "saves": [], "book": [], "units": []}
out, arrays = {}, {}


def digest(vit, head):
    h = hashlib.sha1()
    for p in list(vit.parameters()) + list(head.parameters()):
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def instrument(make):
    def made(*a, **k):
        step = make(*a, **k)

        def wrapped(vit, head, opt_state, *rest):
            fsdp = isinstance(opt_state, FSDPOptimizer)
            if fsdp:
                opt_state.book.reset()
            got = step(vit, head, opt_state, *rest)
            if fsdp:
                log["resident"].append(opt_state.resident_bytes())
                log["book"].append(opt_state.book.as_dict())
                log["units"] = [u.full_bytes for u in opt_state.units]
            else:
                log["digests"].append(digest(vit, head))
            return got
        return wrapped
    return made


api.make_train_step = instrument(api.make_train_step)
api.make_sp_train_step = instrument(api.make_sp_train_step)
real_save, real_resume = api.save_checkpoint, AsyncCheckpointer.save_train_state
api.save_checkpoint = lambda *a, **k: (log["saves"].append("ckpt"),
                                       real_save(*a, **k))
AsyncCheckpointer.save_train_state = lambda self, *a, **k: (
    log["saves"].append("resume"), real_resume(self, *a, **k))


def model(kind, name, **over):
    kw = dict(cfg["kwargs"][kind], write_path=cfg["tmp"] + "/" + name,
              device="cpu")
    kw.update(over)
    m = DINOSeg(**kw)
    m.load_state_dict(inits["sp" if kind == "sp" else kind])
    return m


def scenario(name, kind, fit_kw=None, over=None, runs=1):
    for k in log:
        log[k] = []
    for i in range(runs):  # runs > 1: a stopped run and its resumption
        m = model(kind, name, **dict(over or {}, **(
            {"max_epochs": i + 1} if runs > 1 else {})))
        metrics = m.fit(samples_per_epoch=cfg["samples"],
                        **dict(dict(cache_features=False), **(fit_kw or {})))
    vit, head = to_jax_params(m.model.state_dict())
    for k, v in flatten_params({"vit": vit, "head": head}).items():
        arrays[name + "/" + k] = np.asarray(v)
    out[name] = dict(test_acc=metrics["test_acc"], **{k: list(v) for k, v
                                                      in log.items()})


scenario("dp_unfrozen", "unfrozen")
# the feature cache would train every rank on the whole data: it is off
scenario("dp_frozen", "frozen", dict(cache_features="auto"))
scenario("zero", "unfrozen", dict(zero=True))
scenario("zero_resumed", "unfrozen", dict(zero=True, resume=True), runs=2)
scenario("fsdp", "unfrozen", dict(fsdp=True))
scenario("fsdp_resumed", "unfrozen", dict(fsdp=True, resume=True), runs=2)
scenario("dp_accum", "unfrozen", dict(accum_steps=2))
scenario("fsdp_accum", "unfrozen", dict(fsdp=True, accum_steps=2))
scenario("sp", "sp", dict(parallelism="sp"), dict(max_epochs=1))
scenario("sp_zero", "sp", dict(parallelism="sp", zero=True),
         dict(max_epochs=1))
# lr 0 keeps val_acc flat: both ranks stop after epoch 1, together
scenario("early_stop", "frozen", dict(early_stopping=True),
         dict(lr=0.0, max_epochs=4, patience=1))

m = model("frozen", "eval")
for split in ("test", "one"):
    path = cfg["root"] + ("/dt_real_voc_test" if split == "test"
                          else "/one/dt_real_voc_test")
    ev = m.evaluate(path, per_class=True)
    out["evaluate_" + split] = [r for r in ev[f"test_per_class"]]
    out["evaluate_" + split + "_support"] = ev["test_support"]

try:
    pd.agree_across_hosts("probe", rank)
    out["agree_raised"] = None
except RuntimeError as e:
    out["agree_raised"] = str(e)
out["agree_same"] = pd.agree_across_hosts("same", [1.5, 2]).tolist()
out["any"] = [pd.any_across_hosts(rank == 1), pd.any_across_hosts(False)]
out["reduce"] = [pd.reduce_dict({"a": rank, "b": 2.0}),
                 pd.reduce_dict({"a": rank}, average=False)]

# one data-parallel step of cnn1 and of the MoE head on this rank's slab
z = np.load(cfg["inputs"])
b_loc = cfg["batch"] // cfg["world"]
rows = slice(rank * b_loc, (rank + 1) * b_loc)
for kind in ("cnn1", "moe"):
    gen = torch.Generator().manual_seed(3)
    if kind == "cnn1":
        vit = build_backbone("cnn1", gen, True, None)
        head_type, dim = "linear", 512
    else:
        vit = DINOSeg(head="moe", n_blocks=1, n_classes=3, random_init=True,
                      seed=3, device="cpu").model.dino.requires_grad_(True)
        head_type, dim = "moe", 384
    head = init_head(head_type, 3, dim, generator=gen, n_experts=4)
    opt = tloop.make_optimizer("sgd", 0.1)
    step = tloop.make_train_step(
        api.ViTConfig(patch_size=8), head_type, 3, opt, False,
        backbone="cnn1" if kind == "cnn1" else "vit",
        dp_group=torch.distributed.group.WORLD)
    imgs = torch.from_numpy(z["step_images"][rows])
    labels = torch.from_numpy(z["step_labels_" + kind][rows])
    mask = torch.from_numpy(z["step_mask"][rows])
    loss, cm = step(vit, head, tloop.init_opt_state(opt, vit, head, False),
                    imgs, labels, mask)
    out["step_" + kind] = dict(loss=float(loss), cm=cm.tolist())
    for k, v in list(vit.state_dict().items()) + [
            ("head." + k, v) for k, v in head.state_dict().items()]:
        arrays[f"step_{kind}/{k}"] = v.numpy()

np.savez(cfg["out"] + ".npz", **arrays)
with open(cfg["out"], "w") as fh:
    json.dump(out, fh)
"""


@pytest.fixture(scope="module")
def world(root, jax_runs, tmp_path_factory):
    """Every scenario in one world of two ranks: (per-rank json results,
    per-rank arrays)."""
    tmp = tmp_path_factory.mktemp("dp_world")
    arrays = {}
    for name in ("unfrozen", "frozen", "sp"):
        vit, head = _unflatten(jax_runs[name]["init"])
        for k, v in from_jax_params(vit, head).items():
            arrays[f"{name}/{k}"] = v.numpy()
    rs = np.random.RandomState(7)
    arrays["step_images"] = rs.randint(0, 256, (BATCH, RES, RES, 3)).astype(
        np.uint8)
    arrays["step_labels_cnn1"] = rs.randint(
        0, 3, (BATCH, (RES // 8) ** 2)).astype(np.int32)
    arrays["step_labels_moe"] = arrays["step_labels_cnn1"]
    arrays["step_mask"] = np.array([1, 1, 1, 0], np.float32)
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **arrays)
    kwargs = {k: _kwargs(root, k) for k in ("unfrozen", "frozen")}
    kwargs["sp"] = kwargs["unfrozen"]
    outs = spawn_ranks(tmp, WORLD, _RANK, dict(
        inputs=inputs, root=root, kwargs=kwargs, samples=SAMPLES,
        batch=BATCH))
    return ([json.load(open(o)) for o in outs],
            [dict(np.load(o + ".npz")) for o in outs], inputs)


def _unflatten(flat):
    from dino_tpu_torch.checkpointing.io import unflatten_params
    tree = unflatten_params(dict(flat))
    return tree["vit"], tree["head"]


def _close(got, want, prefix):
    assert set(want) == {k[len(prefix):] for k in got if
                         k.startswith(prefix)}
    for k, w in want.items():
        np.testing.assert_allclose(got[prefix + k], w, **PARAM_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["unfrozen", "frozen"])
def test_dp_fit_matches_dino_tpu(world, jax_runs, kind):
    results, arrays, _ = world
    ref = jax_runs[kind]
    for r in range(WORLD):
        _close(arrays[r], ref["final"], f"dp_{kind}/")
        np.testing.assert_allclose(results[r][f"dp_{kind}"]["test_acc"],
                                   ref["test_acc"], atol=ACC_ATOL)


@pytest.mark.parametrize("name", ["dp_unfrozen", "dp_frozen", "zero", "sp",
                                  "early_stop"])
def test_replicas_hold_the_same_bits_after_every_step(world, name):
    results, _, _ = world
    steps = -(-SAMPLES // BATCH) * (1 if name == "sp" else 2)
    d0, d1 = (results[r][name]["digests"] for r in range(WORLD))
    assert len(d0) == steps and d0 == d1


def test_only_rank_zero_writes(world):
    results, _, _ = world
    for name in ("dp_unfrozen", "zero_resumed"):
        assert "ckpt" in results[0][name]["saves"]
        assert results[1][name]["saves"] == []
    assert results[0]["zero_resumed"]["saves"].count("resume") == 2


def test_zero_has_dp_bits_and_resumes_to_them(world):
    _, arrays, _ = world
    for r in range(WORLD):
        for key in [k for k in arrays[r] if k.startswith("dp_unfrozen/")]:
            leaf = key[len("dp_unfrozen/"):]
            np.testing.assert_array_equal(arrays[r]["zero/" + leaf],
                                          arrays[r][key], err_msg=leaf)
            np.testing.assert_array_equal(arrays[r]["zero_resumed/" + leaf],
                                          arrays[r][key], err_msg=leaf)


def test_fsdp_fit_within_dp_bounds_resumes_and_shard_bytes(world, jax_runs):
    """FSDP at one microbatch: DP's bits (a sum of two ranks' gradients is
    the same in any order), so dino_tpu's gates; the resumed run the
    uninterrupted one's bits; between steps each rank holds ceil(n/2)
    elements of each unit's n."""
    results, arrays, _ = world
    for r in range(WORLD):
        _close(arrays[r], jax_runs["unfrozen"]["final"], "fsdp/")
        for k in [k for k in arrays[r] if k.startswith("dp_unfrozen/")]:
            np.testing.assert_array_equal(arrays[r]["fsdp/" + k[12:]],
                                          arrays[r][k], err_msg=k)
        for k in [k for k in arrays[r] if k.startswith("fsdp/")]:
            np.testing.assert_array_equal(  # a resumed run re-shards
                arrays[r]["fsdp_resumed/" + k[5:]], arrays[r][k])
    shard_bytes = sum(-(-n // WORLD) for n in _unit_numels(jax_runs)) * 4
    for r in range(WORLD):
        resident = results[r]["fsdp"]["resident"]
        assert len(resident) == 2 * -(-SAMPLES // BATCH)
        for got in resident:
            assert got["params"] == shard_bytes
            assert got["grads"] <= shard_bytes
            assert got["moments"] <= 2 * shard_bytes  # Adam's two moments


def _unit_numels(jax_runs):
    """Elements of each FSDP unit of the 1-block model: the embeddings with
    the final norm, the block, the head."""
    vit, head = _unflatten(jax_runs["unfrozen"]["init"])
    units = {}
    for k, v in from_jax_params(vit, head).items():
        unit = ("head" if k.startswith("clf.") else
                k.split(".")[2] if k.startswith("dino.blocks.") else "root")
        units[unit] = units.get(unit, 0) + v.numel()
    return list(units.values())


def test_fsdp_accum_fit_matches_dino_tpu(world, jax_runs):
    """Two microbatches a rank: each unit's backward adds them up in the
    microbatch loop's order and reduces once, so DP's accumulated run's
    bits, and dino_tpu's gates."""
    results, arrays, _ = world
    for r in range(WORLD):
        _close(arrays[r], jax_runs["unfrozen"]["final"], "fsdp_accum/")
        np.testing.assert_allclose(results[r]["fsdp_accum"]["test_acc"],
                                   jax_runs["unfrozen"]["test_acc"],
                                   atol=ACC_ATOL)
        for k in [k for k in arrays[r] if k.startswith("dp_accum/")]:
            np.testing.assert_array_equal(
                arrays[r]["fsdp_accum/" + k[len("dp_accum/"):]],
                arrays[r][k], err_msg=k)
    d0, d1 = (results[r]["fsdp_accum"]["resident"] for r in range(WORLD))
    assert len(d0) == len(d1) == 2 * -(-SAMPLES // BATCH)


@pytest.mark.parametrize("name", ["fsdp", "fsdp_resumed", "fsdp_accum"])
def test_fsdp_gathers_at_most_two_units_and_one_gradient(world, jax_runs,
                                                         name):
    """Inside each step the full parameters gathered at once are at most
    the two largest units' (one unit and one prefetched) and at most one
    unit's full gradient is alive."""
    results, _, _ = world
    full = sorted(WORLD * -(-n // WORLD) * 4 for n in _unit_numels(jax_runs))
    for r in range(WORLD):
        res = results[r][name]
        assert sorted(res["units"]) == full
        assert res["book"]
        for book in res["book"]:
            assert 0 < book["peak_gathered_bytes"] <= full[-1] + full[-2]
            assert 0 < book["peak_grad_bytes"] <= full[-1]
            assert book["reduces"] > 0


@pytest.mark.parametrize("name", ["sp", "sp_zero"])
def test_sp_fit_matches_dino_tpu(world, jax_runs, name):
    results, arrays, _ = world
    for r in range(WORLD):
        _close(arrays[r], jax_runs["sp"]["final"], name + "/")
        np.testing.assert_allclose(results[r][name]["test_acc"],
                                   jax_runs["sp"]["test_acc"], atol=ACC_ATOL)
        if name == "sp_zero":  # ZeRO over the SP ranks: SP's bits
            for k in [k for k in arrays[r] if k.startswith("sp/")]:
                np.testing.assert_array_equal(arrays[r]["sp_zero/" + k[3:]],
                                              arrays[r][k])


@pytest.mark.parametrize("split", ["test", "one"])
def test_evaluate_over_ranks_is_exact(world, root, jax_runs, split):
    results, _, _ = world
    pm = DINOSeg(write_path=None, device="cpu", **_kwargs(root, "frozen"))
    pm.load_state_dict(from_jax_params(*_unflatten(
        jax_runs["frozen"]["init"])))
    path = os.path.join(root, "" if split == "test" else "one",
                        "dt_real_voc_test")
    want = pm.evaluate(path, per_class=True)
    for r in range(WORLD):
        assert results[r][f"evaluate_{split}_support"] == want["test_support"]
        assert results[r][f"evaluate_{split}"] == json.loads(json.dumps(
            want["test_per_class"]))


def test_agreement_helpers(world):
    results, _, _ = world
    for r in range(WORLD):
        msg = results[r]["agree_raised"]
        assert msg is not None and f"this is rank {r}" in msg
        assert "ranks [1] differ from rank 0" in msg
        assert results[r]["agree_same"] == [1.5, 2.0]
        assert results[r]["any"] == [True, False]
        assert results[r]["reduce"] == [{"a": 0.5, "b": 2.0}, {"a": 1.0}]


@pytest.mark.parametrize("kind", ["cnn1", "moe"])
def test_dp_step_matches_world_of_one(world, kind):
    """cnn1: BatchNorm's batch statistics over the global batch (the
    running stats too); MoE: the routing fractions over every rank's
    slab.  Against the world of one's step on the whole batch.  SGD at lr
    0.1, so the parameters carry the gradients (Adam's first step is lr x
    sign(g), which turns a gradient at 0 within rounding into 2 lr)."""
    from dino_tpu_torch.models.heads import init_head
    from dino_tpu_torch.models.resnet import build_backbone
    results, arrays, inputs = world
    z = np.load(inputs)
    gen = torch.Generator().manual_seed(3)
    if kind == "cnn1":
        vit = build_backbone("cnn1", gen, True, None)
        head_type, dim = "linear", 512
    else:
        vit = DINOSeg(head="moe", n_blocks=1, n_classes=3, random_init=True,
                      seed=3, device="cpu").model.dino.requires_grad_(True)
        head_type, dim = "moe", 384
    cfg = tloop.ViTConfig(patch_size=8)
    head = init_head(head_type, 3, dim, generator=gen, n_experts=4)
    opt = tloop.make_optimizer("sgd", 0.1)
    step = tloop.make_train_step(cfg, head_type, 3, opt, False,
                                 backbone="cnn1" if kind == "cnn1" else "vit")
    loss, cm = step(vit, head, tloop.init_opt_state(opt, vit, head, False),
                    torch.from_numpy(z["step_images"]),
                    torch.from_numpy(z["step_labels_" + kind]),
                    torch.from_numpy(z["step_mask"]))
    want = {k: v.numpy() for k, v in list(vit.state_dict().items()) + [
        ("head." + k, v) for k, v in head.state_dict().items()]}
    for r in range(WORLD):
        got = results[r]["step_" + kind]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        assert got["cm"] == cm.tolist()
        for k, w in want.items():
            np.testing.assert_allclose(arrays[r][f"step_{kind}/{k}"], w,
                                       **PARAM_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# In this process
# ---------------------------------------------------------------------------

def _jax_slab_batches(ds, idx, seed, epoch, rank):
    """dino_tpu/api.py:1398-1414: process ``rank``'s slabs and loader."""
    b_loc = BATCH // WORLD
    slabs = []
    for start in range(0, len(idx), BATCH):
        window = idx[start:start + BATCH]
        window = np.concatenate([window, np.repeat(window[-1:],
                                                   BATCH - len(window))])
        slabs.append(window[rank * b_loc:(rank + 1) * b_loc])
    return list(jax_batched_loader(ds, np.concatenate(slabs), b_loc,
                                   rng=np.random.default_rng(
                                       [seed, epoch, 1 + rank])))


@pytest.mark.parametrize("rung", ["numpy", "native", "device"])
def test_augmented_slabs_are_dino_tpus_per_rung(root, monkeypatch, rung):
    if rung == "numpy":
        monkeypatch.setattr(jax_native, "get_lib", lambda: None)
        monkeypatch.setattr(port_native, "get_lib", lambda: None)
    elif port_native.get_lib() is None or jax_native.get_lib() is None:
        pytest.skip("the native loader does not build here")
    backend = "device" if rung == "device" else "auto"
    path = os.path.join(root, "dt_real_voc_train")
    pm = DINOSeg(write_path=None, device="cpu", **_kwargs(
        root, "frozen", augmented=True))
    ds = DuckieSegDataset(path, augmented=True, resolution=RES,
                          backend=backend)
    jds = JaxDS(path, augmented=True, resolution=RES, backend=backend)
    seed, epoch = 0, 1
    for rank in range(WORLD):
        rng = np.random.default_rng([seed, epoch])
        idx = epoch_indices(rng, len(ds), SAMPLES)
        loader, masks = pm._dp_batches(ds, idx, rng, seed, epoch, rank,
                                       WORLD)
        got = list(loader)
        want = _jax_slab_batches(jds, idx, seed, epoch, rank)
        assert len(got) == len(want) == len(masks) == -(-SAMPLES // BATCH)
        assert [list(m) for m in masks][-1] == ([1.0, 1.0] if rank == 0
                                                else [0.0, 0.0])
        for (gx, gy, *_), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gy, np.asarray(wy))
            if rung != "device":
                np.testing.assert_array_equal(np.asarray(gx), np.asarray(wx))
        if rung == "device":  # the frames: the port's device route on the
            # slab, from the same rng (tests/test_torch_port_device_augment
            # holds that route to dino_tpu's)
            slab_idx = np.concatenate([
                np.concatenate([w, np.repeat(w[-1:], BATCH - len(w))])[
                    rank * 2:(rank + 1) * 2]
                for w in (idx[s:s + BATCH] for s in range(0, len(idx),
                                                            BATCH))])
            plain = list(batched_loader(ds, slab_idx, 2, rng=np.random.
                                        default_rng([seed, epoch, 1 + rank]),
                                        device="cpu"))
            for (gx, *_), (px, *_) in zip(got, plain):
                np.testing.assert_array_equal(gx.numpy(), px.numpy())


def test_fit_option_errors(root, tmp_path):
    pm = DINOSeg(write_path=str(tmp_path), device="cpu",
                 **_kwargs(root, "unfrozen"))
    with pytest.raises(ValueError, match="drop zero=True"):
        pm.fit(zero=True, fsdp=True)
    with pytest.raises(ValueError, match="zero=True"):
        pm.fit(fsdp=True, parallelism="sp")
    # pipeline parallelism shards the block state itself (dino_tpu's error)
    with pytest.raises(ValueError, match="drop zero/fsdp"):
        pm.fit(parallelism="pp", zero=True)
    with pytest.raises(RuntimeError, match="init_distributed_mode"):
        pm.fit(parallelism="sp")  # SP needs a process group
    assert not os.listdir(tmp_path)
