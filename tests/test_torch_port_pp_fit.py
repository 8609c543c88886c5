"""DINOSeg.fit(parallelism='pp') of the port on the CPU: in a world of one
and over two gloo ranks, against the port's plain fit on the same batches,
a resumed run against the uninterrupted one, and dino_tpu's refusals.

The model: 4 blocks of ViT-S/8's width, MLP head, 3 classes, unfrozen,
fp32, 64px, batch 2, Adam 1e-3, 3 samples an epoch (a ragged tail of one
sample, padded and masked), 2 epochs, on the in-memory split of
tests/test_torch_port_multiprocess.py.  The two ranks are real gloo
processes (``spawn_ranks``) that import neither jax nor dino_tpu; they run
the 1F1B fit (2 stages, M = 2), the interleaved 1F1B fit (V = 2, M = 1), a
fit with ``pp_stages=1`` (rank 1 holds no stage) and a resumed fit (one
epoch, then the second from the resume file).
"""
import json
import textwrap
import types

import numpy as np
import pytest
import torch

from dino_tpu.api import DINOSeg as JaxDINOSeg
from dino_tpu_torch import DINOSeg
from tests.test_torch_port_multiprocess import MemoryDINOSeg, spawn_ranks

KW = dict(data_path="in-memory", head="mlp", n_blocks=4, n_classes=3,
          batch_size=2, max_epochs=2, augmented=False, train_resolution=64,
          random_init=True, precision="fp32", device="cpu",
          freeze_backbone=False, lr=1e-3, seed=0)
SAMPLES = 3
METRIC_ATOL = 1e-6  # tests/test_train_smoke.py:193
LOSS_RTOL = 1e-4
PARAM_TOL = dict(atol=2e-4, rtol=1e-3)
TRAIN_KEYS = ("train_acc", "train_F1", "train_iou", "train_support")
# run -> fit's PP arguments (the resumed run is fit twice, see the script)
RUNS = {"1f1b": dict(pp_microbatches=2),
        "interleaved": dict(pp_schedule="interleaved_1f1b", pp_chunks=2,
                            pp_microbatches=1),
        "one_stage": dict(pp_stages=1, pp_microbatches=2),
        "resumed": dict(pp_microbatches=2)}

_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    cfg = json.loads(sys.argv[1])
    from dino_tpu_torch.parallel import dist as pd
    from tests.test_torch_port_multiprocess import MemoryDINOSeg
    assert not any(m in ("jax", "dino_tpu")
                   or m.startswith(("jax.", "dino_tpu."))
                   for m in sys.modules)
    torch.set_num_threads(1)  # the ranks share the host's cores
    pd.init_distributed_mode("gloo", cfg["init"], cfg["world"], cfg["rank"])
    out, arrays = {}, {}

    def fit(name, path, max_epochs, **kw):
        m = MemoryDINOSeg(**dict(cfg["kw"], write_path=path,
                                 max_epochs=max_epochs))
        logged = {}
        orig = m._log
        m._log = lambda met, step: (logged.__setitem__(str(step), met),
                                    orig(met, step))[1]
        test = m.fit(ck_file_name=name, samples_per_epoch=cfg["samples"],
                     parallelism="pp", **kw)
        out[name] = {"epochs": logged, "test": test}
        for k, v in m.model.state_dict().items():
            arrays[name + "." + k] = v.numpy()

    shared = cfg["tmp"] + "/shared_"
    for name, kw in cfg["runs"].items():
        if name == "resumed":
            fit(name, shared + name, 1, resume=True, **kw)
        fit(name, shared + name, 2, resume=name == "resumed", **kw)
    with open(cfg["out"], "w") as fh:
        json.dump(out, fh)
    np.savez(cfg["out"] + ".npz", **arrays)
""")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's fits run on one intra-op thread, as its rank processes
    do: they are small, and under a loaded host torch's thread pool makes
    them tens of times slower.  The count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fit(tmp, tag, **kw):
    """A world-of-one fit: (per-epoch logged metrics, test metrics,
    state dict)."""
    m = MemoryDINOSeg(write_path=str(tmp / tag), **KW)
    logged = {}
    orig = m._log
    m._log = lambda met, step: (logged.__setitem__(str(step), met),
                                orig(met, step))[1]
    test = m.fit(ck_file_name=tag, samples_per_epoch=SAMPLES,
                 cache_features=False, **kw)
    return logged, test, {k: v.numpy() for k, v in
                          m.model.state_dict().items()}


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    return _fit(tmp_path_factory.mktemp("plain"), "plain")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ppfit")
    outs = spawn_ranks(tmp, 2, _RANK, dict(kw=KW, samples=SAMPLES,
                                           runs=RUNS), tag="ppfit")
    return [(json.load(open(o)), dict(np.load(o + ".npz"))) for o in outs]


def _assert_fit_matches(got, want, tag):
    """Per-epoch train metrics (atol 1e-6), loss (rtol 1e-4), val and test
    accuracy against the plain fit's."""
    epochs, test = got
    w_epochs, w_test = want
    for e in ("0", "1"):
        for k in TRAIN_KEYS + ("val_acc",):
            np.testing.assert_allclose(epochs[e][k], w_epochs[e][k],
                                       atol=METRIC_ATOL, err_msg=(tag, e, k))
        np.testing.assert_allclose(epochs[e]["train_loss"],
                                   w_epochs[e]["train_loss"],
                                   rtol=LOSS_RTOL, err_msg=(tag, e))
    assert epochs["0"]["train_support"] == SAMPLES * 64  # pads excluded
    np.testing.assert_allclose(test["test_acc"], w_test["test_acc"],
                               atol=METRIC_ATOL)


def _assert_params_close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("schedule", ["1f1b", "interleaved_1f1b"])
def test_world_of_one_fit_matches_plain(tmp_path, plain, schedule):
    """One stage in a world of one: the plain fit's metrics and weights."""
    logged, test, state = _fit(tmp_path, schedule, parallelism="pp",
                               pp_schedule=schedule, pp_microbatches=1)
    _assert_fit_matches((logged, test), plain[:2], schedule)
    _assert_params_close(state, plain[2])


@pytest.mark.parametrize("run", ["1f1b", "interleaved", "one_stage"])
def test_two_rank_fit_matches_plain(plain, ranks, run):
    """Over two ranks (rank 1 without a stage in 'one_stage'), every rank
    logs the plain fit's metrics and ends with its weights, the same bits
    on both ranks."""
    for metrics, arrays in ranks:
        _assert_fit_matches((metrics[run]["epochs"], metrics[run]["test"]),
                            plain[:2], run)
        state = {k[len(run) + 1:]: v for k, v in arrays.items()
                 if k.startswith(run + ".")}
        _assert_params_close(state, plain[2])
        for k, v in state.items():
            np.testing.assert_array_equal(v, ranks[0][1][run + "." + k], k)


def test_two_rank_resume_matches_uninterrupted(ranks):
    """The second epoch from the resume file (the optimizer state in the
    plain layout, restacked over the stages) ends where the uninterrupted
    fit does."""
    for metrics, arrays in ranks:
        got = {k[len("resumed."):]: v for k, v in arrays.items()
               if k.startswith("resumed.")}
        want = {k[len("1f1b."):]: v for k, v in arrays.items()
                if k.startswith("1f1b.")}
        _assert_params_close(got, want)
        for k in TRAIN_KEYS:
            np.testing.assert_allclose(metrics["resumed"]["epochs"]["1"][k],
                                       metrics["1f1b"]["epochs"]["1"][k],
                                       atol=METRIC_ATOL)


def _error(fn):
    try:
        fn()
    except Exception as e:  # the type is the result
        return type(e).__name__
    return "none"


ERROR_CASES = {
    "schedule": dict(pp_schedule="gpipe"),
    "frozen": dict(freeze_backbone=True),
    "head": dict(head="moe"),
    "zero": dict(zero=True),
    "fsdp": dict(fsdp=True),
    "accum_steps": dict(accum_steps=2),
    "stages": dict(pp_stages=9),
    "microbatches": dict(pp_microbatches=3),
}
_MODEL_KEYS = ("freeze_backbone", "head")


@pytest.fixture(scope="module")
def models():
    """dino_tpu's and the port's unfrozen 1-block models (batch 2)."""
    return (JaxDINOSeg(head="mlp", n_blocks=1, batch_size=2,
                       freeze_backbone=False, random_init=True, seed=0),
            DINOSeg(head="mlp", n_blocks=1, batch_size=2,
                    freeze_backbone=False, random_init=True, seed=0,
                    device="cpu"))


@pytest.mark.parametrize("case", sorted(ERROR_CASES) + ["backbone"])
def test_fit_errors_are_dino_tpu_s(models, case):
    """fit(parallelism='pp') refuses what dino_tpu refuses, with its error
    types, before it reads any data.  The backbone check runs on a
    stand-in: it reads only the backbone's name."""
    if case == "backbone":
        ns = types.SimpleNamespace(backbone="cnn1")
        want = _error(lambda: JaxDINOSeg.fit(ns, parallelism="pp"))
        got = _error(lambda: DINOSeg._check_pp(ns, "1f1b", False, False, 1,
                                               None, None))
        assert got == want == "ValueError"
        return
    kw = dict(ERROR_CASES[case])
    attrs = {k: kw.pop(k) for k in _MODEL_KEYS if k in kw}
    results = []
    for m in models:
        saved = {k: getattr(m, k) for k in attrs}
        for k, v in attrs.items():
            setattr(m, k, v)
        try:
            results.append(_error(lambda: m.fit(parallelism="pp", **kw)))
        finally:
            for k, v in saved.items():
                setattr(m, k, v)
    assert results[0] == results[1] == "ValueError", results
    if case == "frozen":
        models[1].freeze_backbone = True
        try:
            with pytest.raises(ValueError, match="UNFROZEN"):
                models[1].fit(parallelism="pp")
        finally:
            models[1].freeze_backbone = False
