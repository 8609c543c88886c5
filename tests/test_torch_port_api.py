"""The predict slice end to end: dino_tpu_torch.DINOSeg vs dino_tpu.DINOSeg
on carried weights (CPU, fp32), checkpoint interop, package isolation, and
the no-silent-CPU-path contract."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tpu.api import DINOSeg as JaxDINOSeg
from dino_tpu.ops.preprocess import preprocess as jax_preprocess
from dino_tpu.train.loop import seg_forward as jax_seg_forward
from dino_tpu_torch import DINOSeg, export_predict
from dino_tpu_torch.api import resolve_device
from dino_tpu_torch.checkpointing.convert import from_jax_params
from dino_tpu_torch.models.vit import Mlp, ViTConfig
from dino_tpu_torch.ops import attention as tatt
from dino_tpu_torch.ops import fused_mlp as tfm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 240
MARGIN = 1e-4  # top-2 log-prob gap below which fp32 argmax may flip


def _frames(n, seed=0, shape=(240, 320)):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (n,) + shape + (3,)).astype(np.uint8)


@pytest.fixture(scope="module")
def pair():
    """JAX DINOSeg (random init, seed 0) and the port's DINOSeg holding its
    weights, both fp32, 1 block, MLP head, at 240px on the CPU."""
    jm = JaxDINOSeg(head="mlp", n_blocks=1, precision="fp32",
                    random_init=True, seed=0)
    jm.set_resolution(RES)
    pm = DINOSeg(head="mlp", n_blocks=1, precision="fp32", random_init=True,
                 device="cpu")
    pm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.vit_params),
                                       jax.tree.map(np.asarray, jm.head_params)))
    pm.set_resolution(RES)
    return jm, pm


def _jax_log_probs(jm, imgs):
    x = jax_preprocess(jnp.asarray(imgs), RES)
    return np.asarray(jax_seg_forward(jm.vit_params, jm.head_params, jm.cfg,
                                      "mlp", pre_normalized=x))


def _assert_labels_agree(port_map, jax_map, jax_logp):
    """Label maps equal except at patches where JAX's top-2 log-prob margin
    is < MARGIN; returns the number of patches that differ (all near ties)."""
    out = RES // 8
    f = 480 // out
    assert port_map.shape == jax_map.shape == (480, 480)
    assert port_map.dtype == np.int32
    top2 = np.sort(jax_logp, axis=-1)[:, -2:]
    near = ((top2[:, 1] - top2[:, 0]) < MARGIN).reshape(out, out)
    low_p, low_j = port_map[::f, ::f], jax_map[::f, ::f]
    np.testing.assert_array_equal(low_p[~near], low_j[~near])
    np.testing.assert_array_equal(port_map, np.kron(low_p, np.ones((f, f),
                                                                   np.int32)))
    return int((low_p != low_j).sum())


def test_predict_matches_jax(pair):
    jm, pm = pair
    img = _frames(1)[0]
    ref_logp = _jax_log_probs(jm, img[None])
    logp = pm.log_probs(torch.from_numpy(img[None])).numpy()
    np.testing.assert_allclose(logp, ref_logp, atol=1e-4, rtol=0)
    assert _assert_labels_agree(pm.predict(img), jm.predict(img),
                                ref_logp) == 0


def test_predict_batch_matches_jax(pair):
    jm, pm = pair
    imgs = _frames(2, seed=1)
    ref_logp = _jax_log_probs(jm, imgs).reshape(2, -1, 7)
    out, ref = pm.predict_batch(imgs), jm.predict_batch(imgs)
    assert out.shape == (2, 480, 480) and out.dtype == np.int32
    for i in range(2):
        assert _assert_labels_agree(out[i], ref[i], ref_logp[i]) == 0
        np.testing.assert_array_equal(out[i], pm.predict(imgs[i]))


def test_forward_matches_jax(pair):
    """DINOSeg.forward: uint8 frames already at the resolution -> log-probs."""
    jm, pm = pair
    imgs = _frames(2, seed=4, shape=(RES, RES))
    out = pm.forward(imgs)
    assert out.shape == (2 * (RES // 8) ** 2, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.forward(imgs)),
                               atol=1e-4, rtol=0)


def test_npz_checkpoint_from_jax_gives_same_labels(pair, tmp_path):
    jm, pm = pair
    path = str(tmp_path / "m.npz")
    jm.save(path)
    loaded = DINOSeg.load_from_checkpoint(path, device="cpu")
    assert loaded.precision == "fp32" and loaded.head == "mlp"
    loaded.set_resolution(RES)
    img = _frames(1, seed=2)[0]
    np.testing.assert_array_equal(loaded.predict(img), pm.predict(img))
    assert _assert_labels_agree(loaded.predict(img), jm.predict(img),
                                _jax_log_probs(jm, img[None])) == 0


def test_pretrained_npz_backbone_loads_truncated(tmp_path):
    """pretrained_path: a dino_tpu converted backbone npz (full depth) loads
    into the port's truncated ViT, block for block."""
    from dino_tpu.checkpointing.io import flatten_params
    from dino_tpu.models import vit as jvit
    vit = jax.tree.map(np.asarray, jvit.init_vit_params(
        jax.random.PRNGKey(3), jvit.ViTConfig(patch_size=8), depth=2))
    path = str(tmp_path / "backbone.npz")
    np.savez(path, **flatten_params(vit))
    pm = DINOSeg(n_blocks=1, pretrained_path=path, device="cpu")
    want = from_jax_params(vit)
    got = pm.model.state_dict()
    assert "dino.blocks.1.norm1.weight" not in got
    for k, v in got.items():
        if k.startswith("dino."):
            assert torch.equal(v, want[k]), k


def test_pl_ckpt_loads_strict_and_round_trips_npz(pair, tmp_path):
    """A reference-layout PL .ckpt (dino./clf. keys) loads strictly; the
    port's own npz save reloads to the same labels."""
    from dino_tpu.checkpointing.torch_convert import export_pl_checkpoint
    jm, pm = pair
    ckpt = str(tmp_path / "m.ckpt")
    export_pl_checkpoint(ckpt, jax.tree.map(np.asarray, jm.vit_params),
                         jax.tree.map(np.asarray, jm.head_params), "mlp")
    loaded = DINOSeg.load_from_checkpoint(ckpt, device="cpu",
                                          precision="fp32")
    loaded.set_resolution(RES)
    img = _frames(1, seed=3)[0]
    want = pm.predict(img)
    np.testing.assert_array_equal(loaded.predict(img), want)
    npz = str(tmp_path / "port.npz")
    loaded.save(npz)
    again = DINOSeg.load_from_checkpoint(npz, device="cpu")
    again.set_resolution(RES)
    np.testing.assert_array_equal(again.predict(img), want)
    back = JaxDINOSeg.load_from_checkpoint(npz)  # the JAX package reads it
    back.set_resolution(RES)
    assert _assert_labels_agree(want, back.predict(img),
                                _jax_log_probs(back, img[None])) == 0


def test_package_imports_neither_jax_nor_dino_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import dino_tpu_torch\n"
        "for m in pkgutil.walk_packages(dino_tpu_torch.__path__, "
        "'dino_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'dino_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-I", "-c", code], check=True,
                   timeout=300)


# ---------------------------------------------------------------------------
# (j) no silent CPU path; the kernels' argument checks run without a card
# ---------------------------------------------------------------------------

def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DINOSeg(random_init=True)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def _qkv(shape=(1, 2, 8, 64), dtype=torch.float32):
    return [torch.zeros(shape, dtype=dtype) for _ in range(3)]


@pytest.mark.parametrize("case", ["hd", "dtype", "mixed", "shape", "strided",
                                  "rank"])
def test_flash_arg_checks(case):
    q, k, v = _qkv()
    if case == "hd":
        q, k, v = _qkv((1, 2, 8, 32))
    elif case == "dtype":
        q, k, v = _qkv(dtype=torch.float16)
    elif case == "mixed":
        k = k.to(torch.bfloat16)
    elif case == "shape":
        v = torch.zeros(1, 2, 9, 64)
    elif case == "strided":
        q = torch.zeros(1, 2, 64, 8).transpose(-1, -2)
    elif case == "rank":
        q, k, v = (t[0] for t in (q, k, v))
    with pytest.raises(ValueError):
        tatt.check_flash_args(q, k, v)


def test_flash_arg_checks_accept_kernel_shapes():
    for dtype in (torch.bfloat16, torch.float32):
        tatt.check_flash_args(*_qkv((2, 3, 37, 64), dtype))


def _norm_mlp(d=384, h=1536):
    return torch.nn.LayerNorm(d), Mlp(ViTConfig(embed_dim=d, mlp_ratio=h / d))


@pytest.mark.parametrize("case", ["dtype", "width", "hidden", "strided"])
def test_fused_mlp_arg_checks(case):
    norm, mlp = _norm_mlp()
    x = torch.zeros(10, 384, dtype=torch.bfloat16)
    if case == "dtype":
        x = x.float()
    elif case == "width":
        norm, mlp = _norm_mlp(d=192, h=768)
        x = torch.zeros(10, 192, dtype=torch.bfloat16)
    elif case == "hidden":
        norm, mlp = _norm_mlp(h=1500)
    elif case == "strided":
        x = torch.zeros(384, 10, dtype=torch.bfloat16).t()
    with pytest.raises(ValueError):
        tfm.check_mlp_args(norm, mlp, x)
    tfm.check_mlp_args(*_norm_mlp(), torch.zeros(10, 384, dtype=torch.bfloat16))


def test_wrappers_raise_off_cpu_instead_of_taking_plain():
    """A tensor that is neither on the CPU nor on CUDA never reaches the
    plain version."""
    q, k, v = (t.to("meta") for t in _qkv())
    with pytest.raises(ValueError, match="device"):
        tatt.flash_attention(q, k, v, 0.125)
    norm, mlp = _norm_mlp()
    with pytest.raises(ValueError, match="device"):
        tfm.fused_ln_mlp_residual(norm, mlp, torch.zeros(
            4, 384, dtype=torch.bfloat16, device="meta"), 1e-6)


@pytest.mark.parametrize("kwargs", [
    dict(precision="int8", backbone="cnn1"), dict(head="moe",
                                                  moe_dispatch="topk"),
    dict(backbone="cnn3")])
def test_unported_options_raise(kwargs):
    """int8, the MoE head and the cnn backbones are ported (ROADMAP item
    8); what dino_tpu refuses of them the port refuses too."""
    with pytest.raises(ValueError):
        DINOSeg(random_init=True, device="cpu", **kwargs)


def test_unported_methods_raise(pair, tmp_path):
    """'tp' is ported (ROADMAP item 11.4) and, as 'sp', needs a process
    group; 'pp' training is ported (item 11.5) and refuses this frozen
    model as dino_tpu does; export over several cards is ported (item
    11.6) and refuses a batch that does not split over them, as dino_tpu
    does."""
    jm, pm = pair
    with pytest.raises(RuntimeError, match="init_distributed_mode"):
        pm.predict(_frames(1)[0], parallelism="tp")
    with pytest.raises(RuntimeError, match="init_distributed_mode"):
        pm.predict_stream(iter(_frames(2)), batch_size=2, parallelism="tp")
    for model in (jm, pm):
        with pytest.raises(ValueError, match="UNFROZEN"):
            model.fit(parallelism="pp")
    path = str(tmp_path / "two.dtts")
    with pytest.raises(ValueError, match="divide"):
        export_predict(pm, path, n_devices=2)
    assert export_predict(pm, path, batch_size=2, n_devices=2) == path
    with open(path + ".json") as fh:
        assert json.load(fh)["nr_devices"] == 2
