"""DINO pretraining over ranks: ``python -m dino_tpu_torch.cli.pretrain_dino``
in a world of two gloo processes against dino_tpu's single-process CLI, on
the CPU.

8 JPEGs of 64x80, ViT-S/8 at depth 1, out_dim 16, 2 local crops, global 32
and local 16 px, batch 4, one epoch: the arguments of
tests/test_multihost.py:108-123.  Crop randomness is keyed by (seed,
epoch, image index), so every rank's slab holds the single process's
pixels.  With and without ``--fsdp`` (and with it at two microbatches):

* the teacher backbones agree with dino_tpu's by its own gate (every leaf
  rtol 1e-4, atol 1e-5, tests/test_multihost.py:150-155);
* that gate cannot see the update (at momentum 0.996 the teacher moves
  less than its atol in two steps), so a second run sets the teacher's
  momentum to 0, and its student and teacher are held to dino_tpu's by the
  single-process step's rule (tests/test_torch_port_dino_step.py): Adam
  turns a gradient within float32 noise of 0 (the key bias's, for one)
  into a step of up to lr, so no entry may part by more than 2.1 lr and at
  most PARAM_FLIP_SHARE of them by more than PARAM_LR_SHARE lr, while more
  than half of dino_tpu's entries moved further than that from the
  initial student;
* the two ranks end with the same bits;
* under FSDP a rank gathers at most two units' full parameters at once
  and holds at most one unit's full gradient.

The ranks start from dino_tpu's initial student (``init_dino_params``
swapped for one that loads it), as the two packages draw weights
differently.  The same world also checks that a batch that does not divide the world raises
on every rank, and that a SIGTERM to one rank stops both at the same step.
The ranks import neither jax nor dino_tpu; each has a timeout of its own.
"""
import json
import os

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_port_dino_step import PARAM_FLIP_SHARE, PARAM_LR_SHARE
from tests.test_torch_port_multiprocess import spawn_ranks

ARGS = ["--arch", "vit_small", "--depth", "1", "--out_dim", "16",
        "--epochs", "1", "--warmup_epochs", "0", "--batch_size", "4",
        "--n_local_crops", "2", "--global_size", "32", "--local_size", "16"]
MOMENTUM_0 = ["--momentum_teacher", "0"]
TOL = dict(rtol=1e-4, atol=1e-5)
LR_TOTAL = 2 * 5e-4  # two steps, each at most the base lr
STOP_AT = 3  # rank 1 signals itself during its third step


def _assert_adam_close(got, want):
    assert set(got) == set(want)
    n_far = n_all = 0
    for k in want:
        err = np.abs(got[k] - want[k])
        assert err.max() <= 2.1 * LR_TOTAL, (k, err.max())
        n_far += int((err > PARAM_LR_SHARE * LR_TOTAL).sum())
        n_all += err.size
    assert n_far <= PARAM_FLIP_SHARE * n_all, (n_far, n_all)


def _backbone(write):
    with np.load(os.path.join(write, "dino_pretrained_backbone.npz")) as z:
        return {k: z[k] for k in z.files}


def _student(write):
    """The student of the run's last resume file, flat in dino_tpu's
    layout (the head's configuration left out)."""
    pre = "state/student/"
    with np.load(os.path.join(write, "pretrain_resume.npz")) as z:
        return {k[len(pre):]: z[k] for k in z.files
                if k.startswith(pre) and "_meta" not in k}


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    data = tmp_path_factory.mktemp("imgs_dp")
    rs = np.random.RandomState(0)
    for i in range(8):
        Image.fromarray(rs.randint(0, 255, (64, 80, 3), np.uint8)).save(
            data / f"{i}.jpg")
    return str(data)


@pytest.fixture(scope="module")
def jax_runs(images, tmp_path_factory):
    """dino_tpu's single-process runs, at the teacher's default momentum
    and at 0: {"m996": teacher backbone, "m0": (teacher backbone,
    student)}."""
    from dino_tpu.cli.pretrain_dino import main as jax_main
    out = {}
    for name, extra in (("m996", []), ("m0", MOMENTUM_0)):
        write = str(tmp_path_factory.mktemp("jax_pretrain_" + name))
        jax_main(["--data_path", images, "--write_path", write] + ARGS
                 + extra)
        out[name] = _backbone(write)
    out["m0"] = (out["m0"], _student(write))
    return out


def _jax_init(path):
    """dino_tpu's CLI's initial student (seed 0) as the port's state dict,
    written to ``path``; returns it flat in dino_tpu's layout."""
    import jax

    from dino_tpu.models import vit as jvit
    from dino_tpu.train import dino_pretrain as jdp
    from dino_tpu_torch.checkpointing.convert import from_jax_dino
    from dino_tpu_torch.checkpointing.io import flatten_params
    cfg = jdp.DinoConfig(out_dim=16, n_local_crops=2, global_size=32,
                         local_size=16)
    student, _ = jdp.init_dino_params(jax.random.PRNGKey(0),
                                      jvit.vit_small(patch_size=8), cfg,
                                      depth=1)
    student = jax.tree.map(np.asarray, student)
    sd = from_jax_dino(student)
    np.savez(path, **{k: np.asarray(v) for k, v in sd.items()})
    return {k: v for k, v in flatten_params(student).items()
            if "_meta" not in k}


_RANK = """
import hashlib, json, os, signal, sys
import numpy as np
import torch
cfg = json.loads(sys.argv[1])
torch.set_num_threads(2)
from dino_tpu_torch.parallel import dist as pd
from dino_tpu_torch.train import dino_pretrain
from dino_tpu_torch.cli.pretrain_dino import main
assert not any(m in ("jax", "dino_tpu") or m.startswith(("jax.", "dino_tpu."))
               for m in sys.modules)
pd.init_distributed_mode("gloo", cfg["init"], cfg["world"], cfg["rank"])
rank = cfg["rank"]
out = {"digests": {}}
init = {k: torch.from_numpy(v) for k, v in np.load(cfg["init_npz"]).items()}


models = []


def init_from_jax(generator, vit_cfg, dino_cfg, depth=None, device=None):
    student = dino_pretrain.DinoModel(vit_cfg, dino_cfg, depth)
    student.load_state_dict(init, strict=True)
    models[:] = dino_pretrain.dino_pair(student, device)
    return tuple(models)


dino_pretrain.init_dino_params = init_from_jax


books = {}
real_shard = dino_pretrain.shard_dino_state


def shard_and_log(*a, **k):
    opt = real_shard(*a, **k)
    books[len(books)] = opt
    return opt


dino_pretrain.shard_dino_state = shard_and_log


def digest(model):
    h = hashlib.sha1()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode() + v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def run(name, *extra):
    books.clear()
    path = main(["--data_path", cfg["images"], "--write_path",
                 cfg["tmp"] + "/" + name, "--device", "cpu"] + cfg["args"]
                + list(extra))
    # the end of a run leaves both models whole on every rank
    out["digests"][name] = [digest(m) for m in models]
    if books:
        opt = books[0]
        out.setdefault("books", {})[name] = dict(
            opt.book.as_dict(), units=[u.full_bytes for u in opt.units])
    return path



for m, extra in (("", []), ("_m0", cfg["momentum_0"])):
    run("dp" + m, *extra)
    run("fsdp" + m, "--fsdp", *extra)
run("fsdp_accum", "--fsdp", "--accum_steps", "2")
try:
    run("bad_batch", "--batch_size", "3")
    out["bad_batch"] = None
except ValueError as e:
    out["bad_batch"] = str(e)

# a SIGTERM that reaches rank 1 alone, during its STOP_AT-th step
steps = []
real = dino_pretrain.make_dino_train_step


def counting(*a, **k):
    step = real(*a, **k)

    def wrapped(*args):
        steps.append(1)
        if rank == 1 and len(steps) == cfg["stop_at"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*args)
    return wrapped


dino_pretrain.make_dino_train_step = counting
out["stop_returned"] = run("stop", "--epochs", "3")
out["stop_steps"] = len(steps)
with open(cfg["out"], "w") as fh:
    json.dump(out, fh)
"""


@pytest.fixture(scope="module")
def world(images, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_pretrain")
    init = str(tmp / "init.npz")
    start = _jax_init(init)
    outs = spawn_ranks(tmp, 2, _RANK, dict(images=images, args=ARGS,
                                           stop_at=STOP_AT, init_npz=init,
                                           momentum_0=MOMENTUM_0))
    return str(tmp), [json.load(open(o)) for o in outs], start


@pytest.mark.parametrize("name", ["dp", "fsdp", "fsdp_accum"])
def test_pretrain_cli_over_ranks_matches_dino_tpu(world, jax_runs, name):
    tmp, results, _ = world
    got = _backbone(os.path.join(tmp, name))
    assert set(got) == set(jax_runs["m996"])
    for k, want in jax_runs["m996"].items():
        np.testing.assert_allclose(got[k], want, **TOL, err_msg=k)
    assert results[0]["digests"][name] == results[1]["digests"][name]


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_pretrain_cli_over_ranks_updates_as_dino_tpu(world, jax_runs, name):
    tmp, results, start = world
    want_backbone, want_student = jax_runs["m0"]
    name += "_m0"
    # most of dino_tpu's student moved past the tolerance, so a missing
    # or partial update over the ranks cannot pass
    assert set(want_student) == set(start)
    moved = sum(int((np.abs(want_student[k] - start[k])
                     > PARAM_LR_SHARE * LR_TOTAL).sum()) for k in start)
    assert moved > 0.5 * sum(v.size for v in start.values()), moved
    _assert_adam_close(_student(os.path.join(tmp, name)), want_student)
    _assert_adam_close(_backbone(os.path.join(tmp, name)), want_backbone)
    # the ranks' students and teachers: the same bits
    assert results[0]["digests"][name] == results[1]["digests"][name]


@pytest.mark.parametrize("name", ["fsdp", "fsdp_m0", "fsdp_accum"])
def test_pretrain_fsdp_gathers_at_most_two_units_and_one_gradient(world,
                                                                  name):
    """Over the CLI run, the full parameters gathered at once are at most
    the two largest units' and at most one unit's full gradient is alive;
    every unit reduced its gradient once a step and use."""
    _, results, _ = world
    for r in range(2):
        book = results[r]["books"][name]
        full = sorted(book["units"])
        assert len(full) == 4  # root, 1 block, the head's MLP, last layer
        assert 0 < book["peak_gathered_bytes"] <= full[-1] + full[-2]
        assert 0 < book["peak_grad_bytes"] <= full[-1]
        # two steps; a step reduces the root twice (its two uses), every
        # other unit once, whatever the microbatches
        assert book["reduces"] == 2 * 5


def test_pretrain_batch_must_divide_the_world(world):
    _, results, _ = world
    for r, res in enumerate(results):
        assert res["bad_batch"] is not None, f"rank {r} trained"
        assert "divisible by the world size (2)" in res["bad_batch"]


def test_signal_to_one_rank_stops_both_at_the_same_step(world):
    from dino_tpu_torch.checkpointing.resume import restart_from_checkpoint
    tmp, results, _ = world
    assert [r["stop_steps"] for r in results] == [STOP_AT, STOP_AT]
    assert [r["stop_returned"] for r in results] == [None, None]
    run_vars = {"epoch": None, "step": None}
    restart_from_checkpoint(os.path.join(tmp, "stop", "pretrain_resume.npz"),
                            run_vars)
    # 2 steps an epoch: the third is step 0 of epoch 1
    assert (run_vars["epoch"], run_vars["step"]) == (1, 0)
    assert not os.path.exists(os.path.join(tmp, "stop",
                                           "dino_pretrained_backbone.npz"))
