"""The port's export (dino_tpu_torch/serving.py, cli/export.py,
cli/export_torch.py) and its fixed-shape predict program on the CPU: the
cases of tests/test_serving_export.py against the port's artifact, the
artifact and its contract against dino_tpu's on the same .npz weights, the
program's weight key, and the imports with jax, dino_tpu and Pillow
blocked."""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from dino_tpu import export_predict as jax_export_predict
from dino_tpu import load_exported_predict as jax_load_exported_predict
from dino_tpu.api import DINOSeg as JaxDINOSeg
from dino_tpu.cli.export_torch import main as jax_export_torch_main
from dino_tpu_torch import DINOSeg, export_predict, load_exported_predict
from dino_tpu_torch.cli.export import main as export_main
from dino_tpu_torch.serving import MAGIC, predict_program
from tests.test_torch_port_serve import (RES, assert_labels_agree,
                                         jax_log_probs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(n, seed, shape=(100, 120)):
    return np.random.RandomState(seed).randint(0, 255, (n,) + shape + (3,),
                                               np.uint8)


@pytest.fixture(scope="module")
def model():
    m = DINOSeg(head="mlp", n_blocks=1, n_classes=5, random_init=True,
                seed=0, precision="fp32", device="cpu")
    m.set_resolution(RES)
    return m


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """dino_tpu's model and the port's, loaded from the same .npz."""
    jm = JaxDINOSeg(head="mlp", n_blocks=1, n_classes=5, random_init=True,
                    seed=1, precision="fp32")
    jm.set_resolution(RES)
    path = str(tmp_path_factory.mktemp("pair") / "j.ckpt.npz")
    jm.save(path)
    pm = DINOSeg.load_from_checkpoint(path, device="cpu")
    pm.set_resolution(RES)
    return jm, pm, path


def test_export_roundtrip(model, tmp_path):
    path = str(tmp_path / "predict.dtts")
    assert export_predict(model, path, batch_size=3,
                          in_shape=(100, 120)) == path
    frames = _frames(3, 0)
    served = load_exported_predict(path, device="cpu")
    out = served(frames)
    assert out.shape == (3, 480, 480) and out.dtype == np.int32
    np.testing.assert_array_equal(out, model.predict_batch(frames))
    assert served.contract["magic"] == MAGIC
    assert served.contract["input"]["shape"] == [3, 100, 120, 3]
    assert served.contract["resolution"] == RES
    assert served.contract["precision"] == "fp32"
    with open(path + ".json") as fh:
        assert json.load(fh) == served.contract
    # non-uint8 input is clipped to uint8, as predict_batch does
    wide = frames.astype(np.int32) * 2 - 100
    np.testing.assert_array_equal(served(wide), model.predict_batch(wide))


def test_export_shape_bound(model, tmp_path):
    path = str(tmp_path / "predict.dtts")
    export_predict(model, path, batch_size=2, in_shape=(100, 120))
    served = load_exported_predict(path, device="cpu")
    with pytest.raises(ValueError, match="shape-bound"):
        served(np.zeros((4, 100, 120, 3), np.uint8))
    with pytest.raises(ValueError, match="shape-bound"):
        served.program(np.zeros((2, 64, 64, 3), np.uint8))


def test_export_contract_nondivisible_resolution(tmp_path):
    """72px: a 9x9 patch grid, kron factor 53, 477x477 maps."""
    m = DINOSeg(head="linear", n_blocks=1, n_classes=3, random_init=True,
                seed=2, precision="fp32", device="cpu")
    m.set_resolution(72)
    path = str(tmp_path / "odd.dtts")
    export_predict(m, path, batch_size=1, in_shape=(72, 72))
    served = load_exported_predict(path, device="cpu")
    assert served.contract["output"]["shape"] == [1, 477, 477]
    frames = _frames(1, 5, (72, 72))
    out = served(frames)
    assert out.shape == (1, 477, 477)
    np.testing.assert_array_equal(out, m.predict_batch(frames))


def test_export_cli(model, tmp_path):
    ckpt = str(tmp_path / "m.ckpt.npz")
    model.save(ckpt)
    out = str(tmp_path / "cli.dtts")
    buf = io.StringIO()
    with redirect_stdout(buf):
        export_main([ckpt, out, "--resolution", "64", "--batch-size", "2",
                     "--in-height", "100", "--in-width", "120",
                     "--precision", "fp32", "--cpu"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["artifact"] == out
    assert line["input"]["shape"] == [2, 100, 120, 3]
    assert line["precision"] == "fp32"
    frames = _frames(2, 3)
    np.testing.assert_array_equal(
        load_exported_predict(out, device="cpu")(frames),
        model.predict_batch(frames))
    # several cards and SP are not ported: the CLI says so
    with pytest.raises(NotImplementedError, match="item 11"):
        export_main([ckpt, str(tmp_path / "sp.dtts"), "--resolution", "64",
                     "--n-devices", "2", "--parallelism", "sp", "--cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            export_main([ckpt, str(tmp_path / "card.dtts")])


def test_export_unported_modes_raise(model, tmp_path):
    """dino_tpu's DP, SP and MoE/int8 exports: DP and SP name ROADMAP item
    11, int8 and the MoE head item 8."""
    path = str(tmp_path / "x.dtts")
    with pytest.raises(NotImplementedError, match="item 11"):
        export_predict(model, path, batch_size=8, in_shape=(100, 120),
                       n_devices=8)
    with pytest.raises(NotImplementedError, match="item 11"):
        export_predict(model, path, batch_size=2, in_shape=(100, 120),
                       n_devices=8, parallelism="sp")
    with pytest.raises(ValueError, match="parallelism"):
        export_predict(model, path, batch_size=1, in_shape=(100, 120),
                       parallelism="pp")
    with pytest.raises(NotImplementedError, match="item 8"):
        export_predict(model, path, batch_size=1, in_shape=(100, 120),
                       precision="int8")
    with pytest.raises(NotImplementedError, match="item 8"):
        DINOSeg(head="moe", n_blocks=1, n_classes=4, random_init=True,
                device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        export_predict(model, path, platforms=["tpu"])
    assert not os.path.exists(path)


def test_load_needs_the_card_unless_asked(model, tmp_path):
    path = str(tmp_path / "p.dtts")
    export_predict(model, path, batch_size=1, in_shape=(64, 64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_exported_predict(path)
    with open(path + ".json", "w") as fh:
        json.dump({"magic": "dino_tpu_serving_v1"}, fh)
    with pytest.raises(ValueError, match="contract"):
        load_exported_predict(path, device="cpu")
    torch.save({"magic": "something else"}, path)
    with pytest.raises(ValueError, match="not a dino_tpu_torch serving"):
        load_exported_predict(path, device="cpu")


def test_artifact_matches_dino_tpu_artifact(pair, tmp_path):
    """Both packages export the same .npz at one shape: the port's artifact
    gives dino_tpu's loaded artifact's labels (equal except near ties), and
    the contracts agree key by key but for magic and platforms."""
    jm, pm, _ = pair
    jpath, ppath = str(tmp_path / "j.shlo"), str(tmp_path / "p.dtts")
    jax_export_predict(jm, jpath, batch_size=3, in_shape=(100, 120))
    export_predict(pm, ppath, batch_size=3, in_shape=(100, 120))
    frames = _frames(3, 7)
    want = jax_load_exported_predict(jpath)(frames)
    got = load_exported_predict(ppath, device="cpu")(frames)
    differ = assert_labels_agree(got, want, jax_log_probs(jm, frames))
    print(f"port artifact vs dino_tpu artifact: {differ} near-tie patches "
          f"differ")
    with open(jpath + ".json") as fh:
        jc = json.load(fh)
    with open(ppath + ".json") as fh:
        pc = json.load(fh)
    assert jc.keys() == pc.keys()
    assert {k: jc[k] for k in jc if k not in ("magic", "platforms")} == \
        {k: pc[k] for k in pc if k not in ("magic", "platforms")}
    assert pc["platforms"] == ["cuda"]


def test_export_torch_cli_matches_dt_export_torch(pair, tmp_path):
    """python -m dino_tpu_torch.cli.export_torch and dt-export-torch on the
    same .npz write the same keys and equal tensors."""
    _, _, path = pair
    want, got = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    with redirect_stdout(io.StringIO()):
        jax_export_torch_main([path, want, "--epoch", "2",
                               "--global-step", "5"])
    run = subprocess.run(
        [sys.executable, "-m", "dino_tpu_torch.cli.export_torch", path, got,
         "--epoch", "2", "--global-step", "5", "--cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert run.returncode == 0, run.stderr
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line == {"output": got, "backbone": "vit", "head": "mlp",
                    "n_blocks": 1, "n_classes": 5}
    ref = torch.load(want, map_location="cpu", weights_only=False)
    out = torch.load(got, map_location="cpu", weights_only=False)
    assert out.keys() == ref.keys()
    assert out["state_dict"].keys() == ref["state_dict"].keys()
    for k, v in ref["state_dict"].items():
        torch.testing.assert_close(out["state_dict"][k], v, rtol=0, atol=0)
    assert out["hyper_parameters"].keys() == ref["hyper_parameters"].keys()
    assert (out["epoch"], out["global_step"]) == (ref["epoch"],
                                                  ref["global_step"])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_program_equals_predict_batch(precision):
    """The program on its bf16 weight copies gives predict_batch's bits."""
    m = DINOSeg(head="mlp", n_blocks=2, n_classes=7, random_init=True,
                seed=4, precision=precision, device="cpu")
    m.set_resolution(RES)
    frames = _frames(2, 11)
    prog = predict_program(m, 2, (100, 120))
    np.testing.assert_array_equal(prog(frames), m.predict_batch(frames))
    assert prog.builds == 1 and not prog.stale()
    if precision == "bf16":
        w = prog._weights
        assert w.dino.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
        assert w.dino.blocks[0].attn.qkv.bias.dtype == torch.float32
        assert w.dino.pos_embed.dtype == torch.float32


@pytest.mark.parametrize("change", ["load_state_dict", "adam", "fused_adam",
                                    "sgd"])
def test_program_rebuilds_when_the_weights_change(change):
    """The program's key changes after load_state_dict and after an
    optimizer step (fused Adam writes without bumping a version counter),
    and the rebuilt program follows the new weights."""
    m = DINOSeg(head="mlp", n_blocks=1, n_classes=5, random_init=True,
                seed=5, precision="bf16", device="cpu")
    m.set_resolution(RES)
    frames = _frames(2, 12, (64, 64))
    prog = predict_program(m, 2, (64, 64))
    before = prog(frames)
    key = prog._key
    if change == "load_state_dict":
        m.load_state_dict({k: v * 1.5 for k, v in
                           m.model.state_dict().items()})
    else:
        params = list(m.model.parameters())
        opt = {"adam": lambda: torch.optim.Adam(params, lr=0.05),
               "fused_adam": lambda: torch.optim.Adam(params, lr=0.05,
                                                      fused=True),
               "sgd": lambda: torch.optim.SGD(params, lr=0.5)}[change]()
        gen = torch.Generator().manual_seed(0)
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    assert prog.stale()
    after = prog(frames)
    assert prog._key != key and prog.builds == 2 and not prog.stale()
    np.testing.assert_array_equal(after, m.predict_batch(frames))
    assert (after != before).any()


def test_serving_imports_without_jax_dino_tpu_or_pil():
    blocked = ("jax", "dino_tpu", "PIL")
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in blocked)
            + "import dino_tpu_torch.serving\n"
            "import dino_tpu_torch.cli.serve\n"
            "import dino_tpu_torch.cli.export\n"
            "import dino_tpu_torch.cli.export_torch\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{blocked!r} and sys.modules[m] is not None)\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-I", "-c", code], check=True,
                   timeout=300, cwd=REPO)
