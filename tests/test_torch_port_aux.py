"""The port's small modules (ROADMAP item 12) against dino_tpu's gates, on
the CPU: utils/profiling.py, utils/misc.py, checkpointing/pretrained.py
(the ladder and its cache, shared with dino_tpu in both directions),
parallel/dist.py's save_on_master and setup_for_distributed, and the
cli/verify_port.py parity record against the committed goldens.

tests/test_viz_and_aux.py:47-200, tests/test_utils_parity.py:67-82 and
tests/test_pretrained.py:38-121, run against the port.  Every file is made
here; nothing reaches the network.
"""
import argparse
import builtins
import glob
import json
import os
import random
import shutil

import jax
import numpy as np
import pytest
import torch

from dino_tpu.checkpointing import pretrained as jpre
from dino_tpu.utils import misc as jmisc
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.checkpointing import pretrained as tpre
from dino_tpu_torch.checkpointing.convert import to_jax_params
from dino_tpu_torch.cli import verify_port
from dino_tpu_torch.models.resnet import ResNetBackbone
from dino_tpu_torch.models.vit import ViTConfig, VisionTransformer
from dino_tpu_torch.parallel import dist as tdist
from dino_tpu_torch.utils import misc as tmisc
from dino_tpu_torch.utils import profiling
from tests.test_pretrained import _tiny_resnet_sd, _tiny_vit_sd

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens")


@pytest.fixture
def home(tmp_path, monkeypatch):
    """An empty HOME (no hub cache) and $DINO_TPU_CACHE under tmp_path, no
    pretrained env vars: the ladder sees only what a test puts there."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("DINO_TPU_CACHE", str(tmp_path / "cache"))
    for var in ("DINO_TPU_PRETRAINED", "DINO_TPU_PRETRAINED_RESNET",
                "DINO_TPU_ALLOW_DOWNLOAD"):
        monkeypatch.delenv(var, raising=False)
    return tmp_path


# ---------------------------------------------------------------------------
# utils/profiling.py
# ---------------------------------------------------------------------------

def test_step_timer_and_trace(tmp_path):
    timer = profiling.StepTimer()
    timer.start()
    for _ in range(3):
        timer.mark({"out": [torch.ones(4) * 2]})
    s = timer.summary()
    assert s["steps"] == 3 and s["total_s"] > 0
    assert set(s) == {"steps", "mean_s", "p50_s", "p95_s", "total_s"}
    assert profiling.StepTimer().summary() == {}
    with profiling.device_trace(str(tmp_path / "tr")) as d:
        with profiling.annotate("unit-test-region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    traces = glob.glob(os.path.join(d, "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "unit-test-region" in names and "aten::mm" in names
    with pytest.raises(ValueError, match="Perfetto"):
        with profiling.device_trace(str(tmp_path / "tr"),
                                    create_perfetto_link=True):
            pass


def test_hbm_stats_is_none_off_the_card():
    assert profiling.hbm_stats("cpu") is None
    if not torch.cuda.is_available():
        assert profiling.hbm_stats() is None


# ---------------------------------------------------------------------------
# parallel/dist.py
# ---------------------------------------------------------------------------

def test_dist_helpers_single_process():
    assert tdist.get_world_size() == 1 and tdist.get_rank() == 0
    assert tdist.is_main_process()
    assert not tdist.is_dist_avail_and_initialized()
    assert tdist.reduce_dict({"a": 1.0, "b": 2.0}) == {"a": 1.0, "b": 2.0}
    assert tdist.save_on_master(lambda x: x + 1, 41) == 42


def test_setup_for_distributed_silences_other_ranks(monkeypatch, capsys):
    original = builtins.print
    monkeypatch.setattr(builtins, "print", original)
    tdist.setup_for_distributed(True)
    print("master")
    builtins.print = original
    tdist.setup_for_distributed(False)
    print("hidden")
    print("shown", force=True)
    assert capsys.readouterr().out == "master\nshown\n"


# ---------------------------------------------------------------------------
# utils/misc.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("logits", [
    [[0.1, 0.9, 0.0], [0.8, 0.15, 0.05], [0.2, 0.3, 0.5]],
    [[0.5, 0.5, 0.0], [0.2, 0.2, 0.2], [0.1, 0.3, 0.3]]])  # with ties
def test_accuracy_topk_matches_dino_tpu(logits):
    target = np.array([1, 1, 2])
    logits = np.asarray(logits, np.float32)
    got = tmisc.accuracy(logits, target, topk=(1, 2, 3))
    assert got == jmisc.accuracy(logits, target, topk=(1, 2, 3))
    assert tmisc.accuracy(torch.from_numpy(logits), torch.from_numpy(target),
                          topk=(1,)) == got[:1]


def test_misc_helpers():
    gen = tmisc.fix_random_seeds(3)
    draws = (torch.rand(2), np.random.rand(2), random.random(),
             torch.rand(2, generator=gen))
    gen = tmisc.fix_random_seeds(3)
    again = (torch.rand(2), np.random.rand(2), random.random(),
             torch.rand(2, generator=gen))
    assert isinstance(gen, torch.Generator)
    for a, b in zip(draws, again):
        np.testing.assert_array_equal(a, b)
    assert "sha:" in tmisc.get_sha()
    assert tmisc.bool_flag("true") and not tmisc.bool_flag("off")
    with pytest.raises(argparse.ArgumentTypeError):
        tmisc.bool_flag("maybe")


@pytest.mark.parametrize("backbone", ["vit", "cnn1", "cnn2"])
def test_has_batchnorms_matches_dino_tpu(backbone):
    """The module and its state dict give dino_tpu's answer for the same
    backbone's params in its layout."""
    mod = (VisionTransformer(ViTConfig(patch_size=8), depth=1)
           if backbone == "vit" else ResNetBackbone(backbone))
    sd = mod.state_dict()
    jparams, _ = to_jax_params({"dino." + k: v for k, v in sd.items()})
    want = jmisc.has_batchnorms(jparams)
    assert want == (backbone != "vit")
    assert tmisc.has_batchnorms(mod) == want
    assert tmisc.has_batchnorms(sd) == want


# ---------------------------------------------------------------------------
# checkpointing/pretrained.py
# ---------------------------------------------------------------------------

def test_load_pretrained_weights_teacher_key(tmp_path):
    rs = np.random.RandomState(0)
    src = _tiny_vit_sd(rs, prefix="module.backbone.")
    head = {"module.head.mlp.0.weight": torch.zeros(4, 384)}
    path = str(tmp_path / "dino_full.pth")
    torch.save({"teacher": dict(src, **head), "epoch": 300}, path)
    sd = tpre.load_pretrained_weights(path, checkpoint_key="teacher")
    assert len({k.split(".")[1] for k in sd if k.startswith("blocks.")}) == 1
    assert sd["patch_embed.proj.weight"].shape == (384, 3, 8, 8)
    assert not any(k.startswith("head.") for k in sd)
    torch.testing.assert_close(
        sd["blocks.0.attn.qkv.weight"],
        src["module.backbone.blocks.0.attn.qkv.weight"], rtol=0, atol=0)


def test_backbone_search_order_and_cache(home):
    raw = str(home / "raw.pth")
    src = _tiny_vit_sd(np.random.RandomState(1))
    torch.save(src, raw)
    sd = tpre.load_pretrained_backbone(pretrained_path=raw)
    assert sd is not None and sd.keys() == src.keys()
    cached = home / "cache" / "dino_deitsmall8_300ep_pretrain.npz"
    assert cached.exists()
    os.remove(raw)  # the second load takes the cache rung
    again = tpre.load_pretrained_backbone()
    for k in src:
        torch.testing.assert_close(again[k], src[k], rtol=0, atol=0)


@pytest.mark.parametrize("writer", ["dino_tpu", "port"])
def test_vit_cache_serves_the_other_package(home, writer):
    """A converted cache either package writes is the other's: the port
    reads dino_tpu's and dino_tpu reads the port's, the same values."""
    raw = str(home / "raw.pth")
    src = _tiny_vit_sd(np.random.RandomState(2))
    torch.save(src, raw)
    if writer == "dino_tpu":
        want = jpre.load_pretrained_backbone(pretrained_path=raw)
    else:
        tpre.load_pretrained_backbone(pretrained_path=raw)
        want = jpre.convert_vit_state_dict(
            {k: v.numpy() for k, v in src.items()})
    os.remove(raw)
    got_t = tpre.load_pretrained_backbone()
    got_j = jpre.load_pretrained_backbone()
    for k in src:
        torch.testing.assert_close(got_t[k], src[k], rtol=0, atol=0)
    for a, b in zip(jax.tree.leaves(got_j), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("writer", ["dino_tpu", "port"])
def test_resnet_ladder_hub_cache_then_npz(home, writer):
    """The hub-cache rung converts the torch file and caches it per
    variant; with the file gone the cache serves, either package's cache
    the other package too, and DINOSeg(backbone='cnn1') picks it up."""
    assert tpre.load_pretrained_resnet("cnn1") is None
    hub = home / "home" / ".cache" / "torch" / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    src = _tiny_resnet_sd(np.random.RandomState(2))
    torch.save(src, str(hub / "dino_resnet50_pretrain.pth"))
    load = (jpre.load_pretrained_resnet if writer == "dino_tpu"
            else tpre.load_pretrained_resnet)
    assert load("cnn1") is not None
    assert (home / "cache" / "dino_resnet50_pretrain_cnn1.npz").exists()
    os.remove(str(hub / "dino_resnet50_pretrain.pth"))
    sd = tpre.load_pretrained_resnet("cnn1")
    assert set(sd) == set(ResNetBackbone("cnn1").state_dict())
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, src[k], rtol=0, atol=0)
    jp = jpre.load_pretrained_resnet("cnn1")
    np.testing.assert_array_equal(
        np.asarray(jp["layers"][1][3]["conv2"]),
        src["layer2.3.conv2.weight"].numpy().transpose(2, 3, 1, 0))
    m = DINOSeg(backbone="cnn1", n_classes=3, head="linear", device="cpu")
    torch.testing.assert_close(m.model.dino.layer1[0].conv1.weight,
                               src["layer1.0.conv1.weight"], rtol=0, atol=0)


def test_dinoseg_takes_the_cached_backbone(home):
    """DINOSeg's ViT comes from the ladder: the cache's first n_blocks."""
    raw = str(home / "raw.pth")
    src = _tiny_vit_sd(np.random.RandomState(3))
    torch.save(src, raw)
    tpre.load_pretrained_backbone(pretrained_path=raw)
    m = DINOSeg(n_blocks=1, n_classes=3, device="cpu")
    torch.testing.assert_close(m.model.dino.blocks[0].mlp.fc2.weight,
                               src["blocks.0.mlp.fc2.weight"], rtol=0, atol=0)


def test_missing_returns_none_and_never_downloads(home, monkeypatch):
    assert tpre.load_pretrained_backbone() is None
    with pytest.raises(FileNotFoundError):
        tpre.load_pretrained_backbone(allow_missing=False)
    with pytest.warns(UserWarning, match="pretrained DINO weights"):
        DINOSeg(n_blocks=1, device="cpu")
    monkeypatch.setenv("DINO_TPU_ALLOW_DOWNLOAD", "1")
    with pytest.warns(UserWarning, match="does not download.*"
                                         "dino_deitsmall8_300ep_pretrain.pth"):
        assert tpre.load_pretrained_backbone() is None
    with pytest.warns(UserWarning, match="dino_resnet50_pretrain.pth"):
        assert tpre.load_pretrained_resnet("cnn2") is None


# ---------------------------------------------------------------------------
# cli/verify_port.py
# ---------------------------------------------------------------------------

def _verify(argv, capsys):
    with pytest.raises(SystemExit) as exit_:
        verify_port.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return exit_.value.code, out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A reference PL .ckpt, a dino_tpu .npz and a DINO teacher .pth of one
    port model."""
    tmp = tmp_path_factory.mktemp("ckpts")
    m = DINOSeg(head="mlp", n_blocks=1, n_classes=5, random_init=True,
                seed=0, precision="fp32", device="cpu")
    paths = {"task": str(tmp / "m.ckpt"), "task-npz": str(tmp / "m.ckpt.npz"),
             "backbone": str(tmp / "teacher.pth"),
             "bare": str(tmp / "backbone.pth")}
    m.save_torch_checkpoint(paths["task"])
    m.save(paths["task-npz"])
    torch.save({"teacher": {"module.backbone." + k: v for k, v in
                            m.model.dino.state_dict().items()}},
               paths["backbone"])
    torch.save(m.model.dino.state_dict(), paths["bare"])
    return paths


@pytest.mark.parametrize("kind", ["task", "task-npz", "backbone"])
def test_verify_port_cli(home, checkpoints, kind, tmp_path, capsys):
    """Each checkpoint kind: exact layout round trip, the golden forward
    and heads within tolerance, stage 3 skipped with its reason (no
    pretrained ViT-S/8 where the ladder looks); the verdict's last line
    and --json file agree."""
    vout = str(tmp_path / "verdict.json")
    rc, out = _verify([checkpoints[kind], "--cpu", "--json", vout], capsys)
    assert rc == 0 and "PASS" in out and f"kind={kind}" in "\n".join(out)
    verdict = json.loads(out[-1])
    with open(vout) as fh:
        assert json.load(fh) == verdict
    assert verdict["ok"] is True and verdict["device"] == "cpu"
    stages = {s["stage"]: s for s in verdict["stages"]}
    assert set(stages) == {"conversion", "layout_roundtrip",
                           "activation_parity", "head_parity",
                           "argmax_parity"}
    assert all(s["ok"] for s in verdict["stages"])
    assert sum(s["stage"] == "activation_parity"
               for s in verdict["stages"]) == 4
    assert "ladder" in stages["argmax_parity"]["skipped"]


def test_verify_port_fails_on_a_golden_it_does_not_meet(home, checkpoints,
                                                        tmp_path, capsys):
    goldens = tmp_path / "goldens"
    shutil.copytree(GOLDENS, goldens)
    with np.load(str(goldens / "heads.npz")) as z:
        g = {k: z[k] for k in z.files}
    g["lin_out"] = g["lin_out"] + 1e-3
    np.savez(str(goldens / "heads.npz"), **g)
    rc, out = _verify([checkpoints["task"], "--cpu", "--goldens",
                       str(goldens)], capsys)
    verdict = json.loads(out[-1])
    assert rc == 1 and "FAIL" in out and verdict["ok"] is False
    assert [s["head"] for s in verdict["stages"]
            if s["stage"] == "head_parity" and not s["ok"]] == ["linear"]


def test_verify_port_autodiscovery(home, checkpoints, capsys, monkeypatch):
    """No argument and no artifact: a JSON error and exit code 2; a
    backbone in $DINO_TPU_PRETRAINED is found and verified (stage 3 needs
    live960.npz's 3 blocks, and this one has 1)."""
    rc, out = _verify(["--cpu"], capsys)
    verdict = json.loads(out[-1])
    assert rc == 2 and verdict["ok"] is False and "error" in verdict
    monkeypatch.setenv("DINO_TPU_PRETRAINED", checkpoints["bare"])
    rc, out = _verify(["--cpu"], capsys)
    assert rc == 0 and "kind=backbone" in "\n".join(out)
    stage3 = json.loads(out[-1])["stages"][-1]
    assert stage3["stage"] == "argmax_parity"
    assert "3 blocks" in stage3["skipped"]
