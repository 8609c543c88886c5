"""DINOv3 ViT-H+/16 on the port's segmentation path, on the CPU at a small
size, against the plain reference ``benchmark/reference/dinov3.py``
(float32, plain torch; the JAX package has no such model).

The port's factory is cut to D 128, 2 heads of 64, SwiGLU 2 x 256, with
its 4 storage tokens, patch 16 and RoPE base 100, 2 blocks, at 64 and
128px; the reference takes the same widths from the benchmark's
configuration and the same seeded weights (qkv's init std raised by
sqrt(1280 / 128), so that attention at D 128 peaks as it does at the
published width and the rotation moves the maps).  Also: the patch-16
label grid, the paths this backbone does not take and the fused MLP's
gate (ROADMAP F1)."""
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness.images import make_images
from benchmark.harness.weights import generator, make_weights
from benchmark.reference import dinov3 as ref_v3
from benchmark.reference import seg as ref_seg
from dino_tpu_torch.api import DINOSeg, label_maps
from dino_tpu_torch.models import vit as tvit
from dino_tpu_torch.ops import fused_mlp, qkv_rope, swiglu
from dino_tpu_torch.train.loop import seg_forward

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(embed_dim=128, num_heads=2, ffn_hidden=256)
DEPTH = 2


def small_cfg():
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "dinov3-vith16plus-seg.json").read_text())
    cfg.update(SMALL, depth=DEPTH, head_dims=[128, 200, 100, 7])
    assert cfg["init"][0][:2] == ["*.attn.qkv.weight", "trunc_normal"]
    cfg["init"][0][2] *= (1280 / 128) ** 0.5
    return cfg


@pytest.fixture
def small_v3(monkeypatch):
    monkeypatch.setitem(tvit.VIT_BACKBONES, "dinov3_vith16plus",
                        functools.partial(tvit.dinov3_vith16plus, **SMALL))


def model_and_weights(precision, seed=5, res=64):
    cfg = small_cfg()
    w = make_weights(ref_v3.param_shapes(cfg), cfg["init"], seed, "cpu")
    m = DINOSeg(backbone="dinov3_vith16plus", head="mlp", n_blocks=DEPTH,
                precision=precision, random_init=True, device="cpu")
    m.model.load_state_dict(w, strict=True)
    m.set_resolution(res)
    return m, cfg, w


def frames(n, h=48, w=64, seed=3):
    return make_images(generator(seed, "cpu", "frames"), n, h, w, "cpu")


def test_the_published_factory():
    cfg = tvit.dinov3_vith16plus()
    assert (cfg.patch_size, cfg.embed_dim, cfg.depth, cfg.num_heads,
            cfg.head_dim, cfg.mlp_hidden, cfg.n_storage_tokens,
            cfg.num_prefix, cfg.rope_base, cfg.ln_eps) == (
        16, 1280, 32, 20, 64, 5120, 4, 5, 100.0, 1e-5)
    assert tvit.swiglu_hidden(1280, 6.0) == 5120


@pytest.mark.parametrize("gh,gw", [(4, 4), (60, 60), (3, 5)])
def test_the_rope_table_is_the_references(gh, gw):
    """The same float32 bits as the reference's table, and the source's
    formula at the first patch: c = 2 (0.5 / g) - 1, angle 2 pi c."""
    cfg = tvit.dinov3_vith16plus()
    cos, sin = tvit.rope_table(gh, gw, cfg, torch.device("cpu"))
    rcos, rsin = ref_v3.rope_table(gh, gw, 64, 100.0, "cpu")
    assert cos.shape == (gh * gw, 64)
    assert torch.equal(cos, rcos) and torch.equal(sin, rsin)
    c_h = 2 * 0.5 / gh - 1
    assert abs(float(cos[0, 0]) - np.cos(2 * np.pi * c_h)) < 1e-5
    assert torch.equal(cos[:, :32], cos[:, 32:])  # tiled twice


def test_qkv_rope_plain_is_the_composition():
    """Bias with k's third at 0, RoPE on q and k of the patch rows, head-
    major; the same bits as the reference's per-tensor composition (both
    float32 on the CPU, the same operations), then one rounding."""
    g = torch.Generator().manual_seed(0)
    b, n, heads, prefix = 2, 21, 3, 5
    c = heads * 64
    y = torch.randn(b * n, 3 * c, generator=g)
    bias = torch.randn(3 * c, generator=g)
    cos, sin = ref_v3.rope_table(4, 4, 64, 100.0, "cpu")
    for dtype in (torch.float32, torch.bfloat16):
        got = qkv_rope.qkv_rope(y, bias, cos, sin, b, heads, prefix, dtype)
        masked = bias.clone()
        masked[c:2 * c] = 0
        t = (y + masked).reshape(b, n, 3, heads, 64).permute(2, 0, 3, 1, 4)
        want = [torch.cat([u[:, :, :prefix], ref_v3.rope_apply(
            u[:, :, prefix:], cos, sin)], dim=2) if i < 2 else u
                for i, u in enumerate(t)]
        assert got.shape == (3, b, heads, n, 64) and got.dtype == dtype
        assert torch.equal(got, torch.stack(want).to(dtype))


def test_swiglu_plain_is_the_composition():
    """silu(w1 x + b1) * (w2 x + b2) over the concatenated product: the
    reference's two products agree within float32 rounding (1e-6 of the
    scale: the sums run in another order), and the rounding to bf16 is
    one."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(37, 128, generator=g)
    w1, w2 = (torch.randn(256, 128, generator=g) * 0.1 for _ in range(2))
    b1, b2 = (torch.randn(256, generator=g) for _ in range(2))
    y = x @ torch.cat([w1, w2]).t()
    got = swiglu.swiglu(y, torch.cat([b1, b2]), torch.float32)
    want = F.silu(x @ w1.t() + b1) * (x @ w2.t() + b2)
    torch.testing.assert_close(got, want, atol=1e-6 * float(want.abs().max()),
                               rtol=0)
    assert torch.equal(swiglu.swiglu(y, torch.cat([b1, b2])),
                       got.to(torch.bfloat16))


@pytest.mark.parametrize("precision,tol,mean_tol", [("fp32", 2e-5, 2e-6),
                                                    ("bf16", 0.08, 0.005)])
def test_the_backbone_tokens_match_the_reference(small_v3, precision, tol,
                                                 mean_tol):
    """Every token after the final LayerNorm (CLS, 4 storage tokens, 16
    patches) at 64px, tokens of unit scale: float32 to float32 rounding
    across two blocks; bf16 to its rounding on the mean, and on the worst
    element to what a rounding of q or k carries through peaked
    attention (a few elements reach ~0.05)."""
    m, cfg, w = model_and_weights(precision)
    x = ref_v3.vit.normalize(ref_seg.resize(frames(2), 64))
    dt = torch.float32 if precision == "fp32" else torch.bfloat16
    with torch.no_grad():
        got = tvit.vit_forward(m.model.dino, x.to(dt), m.cfg).float()
        want = ref_v3.forward(w, x, cfg)
    assert got.shape == want.shape == (2, 5 + 16, 128)
    err = (got - want).abs()
    assert float(err.max()) <= tol and float(err.mean()) <= mean_tol


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_predict_paths_agree_and_match_the_reference(small_v3, precision):
    """predict, predict_batch, predict_stream and predict_program give the
    same maps; the log-probs match the reference's (float32: 1e-5; bf16:
    0.03, its rounding through two blocks); a label off the reference's
    best lies within that of it."""
    from dino_tpu_torch import serving
    m, cfg, w = model_and_weights(precision, res=128)
    f = frames(3, 96, 128)
    lp = m.log_probs(f).float().reshape(3, 8, 8, 7)
    want = ref_v3.log_probs(w, f, cfg, 128)
    tol = 1e-5 if precision == "fp32" else 0.03
    torch.testing.assert_close(lp, want, atol=tol, rtol=0)
    batch = m.predict_batch(f.numpy())
    assert batch.shape == (3, 480, 480) and batch.dtype == np.int32
    np.testing.assert_array_equal(m.predict(f[1].numpy()), batch[1])
    np.testing.assert_array_equal(
        np.stack(list(m.predict_stream(iter(f.numpy()), batch_size=2))),
        batch)
    program = serving.predict_program(m, 3, (96, 128))
    np.testing.assert_array_equal(program(f.numpy()), batch)
    gaps = (want.max(-1, keepdim=True).values
            - torch.gather(want, 3, torch.from_numpy(
                batch[:, ::60, ::60]).long()[..., None]))
    assert float(gaps.max()) <= 2 * tol


def test_the_label_grid_follows_the_patch_size(small_v3):
    m, _, _ = model_and_weights("fp32")
    with pytest.raises(ValueError, match="multiple of 16"):
        m.set_resolution(72)
    m.set_resolution(96)
    assert m.resolution == 96
    vits = DINOSeg(head="mlp", n_blocks=1, random_init=True, device="cpu")
    vits.set_resolution(72)  # patch 8
    lp = torch.randn(2, 36, 7).log_softmax(-1)  # a 6 x 6 grid at 96px
    maps = label_maps(lp, 96, 7)
    assert maps.shape == (2, 480, 480)
    np.testing.assert_array_equal(
        maps[:, ::80, ::80].numpy(),
        lp.argmax(-1).reshape(2, 6, 6).numpy())
    with pytest.raises(ValueError, match="square grid"):
        label_maps(lp.reshape(72, 7), 96, 7)


def test_seg_forward_drops_every_prefix_token(small_v3):
    m, _, _ = model_and_weights("fp32")
    x = ref_v3.vit.normalize(ref_seg.resize(frames(2), 64))
    with torch.no_grad():
        out = seg_forward(m.model.dino, m.model.clf, m.cfg, "mlp",
                          pre_normalized=x)
    assert out.shape == (2 * 16, 7)


def test_the_paths_it_does_not_take_raise(small_v3):
    m, _, _ = model_and_weights("bf16")
    f = frames(1).numpy()
    for call in (lambda: m.predict(f[0], precision="int8"),
                 lambda: m.predict(f[0], parallelism="sp"),
                 lambda: m.predict(f[0], parallelism="tp"),
                 lambda: m.fit(),
                 lambda: m.get_last_selfattention(f),
                 lambda: m.forward_mask(f[0], np.ones((1, 4, 4)))):
        with pytest.raises(ValueError, match="not supported for backbone"):
            call()
    with pytest.raises(ValueError, match="not supported for backbone"):
        DINOSeg(backbone="dinov3_vith16plus", n_blocks=1, precision="int8",
                random_init=True, device="cpu")
    blk = m.model.dino.blocks[0]
    with pytest.raises(ValueError, match="RoPE"):
        tvit.block_apply(blk, torch.zeros(1, 21, 128), m.cfg)


@pytest.mark.parametrize("dim,hidden,ok", [(384, 1536, True),
                                            (192, 768, False),
                                            (768, 3072, False),
                                            (384, 1000, False)])
def test_the_fused_mlp_takes_only_its_shapes(dim, hidden, ok):
    """ROADMAP F1: the gate in ``block_apply`` asks ``takes_widths``, which
    holds the kernel's widths (D 384, a hidden width that 64 divides);
    contiguity and the device stay the kernel's own check, which raises."""
    blk = tvit.Block(tvit.ViTConfig(embed_dim=dim, num_heads=dim // 64,
                                    mlp_ratio=hidden / dim))
    assert tuple(blk.mlp.fc1.weight.shape) == (hidden, dim)
    x = torch.zeros(2, 5, dim, dtype=torch.bfloat16)
    assert fused_mlp.takes_widths(blk.mlp, x) is ok


def test_an_exported_artifact_gives_the_programs_maps(small_v3, tmp_path):
    """``export_predict`` stores the serving copy (bf16 weights, storage
    tokens and LayerScale gammas) and the configuration; the loaded
    artifact (its ``VisionTransformer`` rebuilt from the DINOv3 fields)
    gives the maps of ``predict_batch``."""
    from dino_tpu_torch import serving
    m, _, _ = model_and_weights("bf16", res=128)
    f = frames(2, 96, 128).numpy()
    path = serving.export_predict(m, str(tmp_path / "v3.dtts"), 2, (96, 128))
    art = serving.load_exported_predict(path, device="cpu")
    assert art.contract["output"]["shape"] == [2, 480, 480]
    np.testing.assert_array_equal(art(f), m.predict_batch(f))
