"""Attention maps, the masked-CLS forward and intermediate layers of
dino_tpu_torch against the torch goldens and against dino_tpu (CPU, same
weights, same inputs from a numpy seed), with the O(N) memory of the CLS
row and the masks, dropout and drop-path by their definitions, the frame
and visualization utilities, the two visualization CLIs, and imports that
need neither Pillow nor matplotlib.

Tolerances:
  * goldens: tests/test_vit_parity.py's ATOL 2e-4 / RTOL 1e-4;
  * float32 against dino_tpu: probabilities PROB_ATOL 1e-7 + PROB_RTOL
    1e-5 (raw q/k's reach 0.13, where float32 sums in another order
    differ by 1.4e-7; the model's are ~2e-3 and differ by ~1e-9), tokens
    after the final LayerNorm TOKEN_ATOL 2e-5 (their largest magnitude is
    ~5; measured 2.6e-6);
  * bf16 intermediate layers: BF16_ULPS 2 bf16 ulps of the tensor's largest
    magnitude (measured 1: the port rounds the GELU's input once, after its
    float32 bias, as dino_tpu's fused kernel does, where dino_tpu's bf16
    composition rounds fc1's output before the GELU);
  * the visualization arrays: the label overlays exactly, the attention
    maps within PROB_ATOL / PROB_RTOL.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tpu.api import DINOSeg as JaxDINOSeg
from dino_tpu.models import vit as jvit
from dino_tpu.ops.attention import attention_probs_xla
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.checkpointing.convert import from_jax_params, strip_prefix
from dino_tpu_torch.models import vit as tvit
from dino_tpu_torch.ops import attention as tatt
from tests.conftest import golden_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 2e-4, 1e-4      # tests/test_vit_parity.py:17-18
PROB_ATOL = 1e-7
PROB_RTOL = 1e-5
TOKEN_ATOL = 2e-5
BF16_ULPS = 2
RES = 240
GRID = RES // 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# torch goldens (tests/goldens/vit_d2_w192_p8.npz), a strict load of the
# reference-named weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden(vit_golden):
    model = tvit.VisionTransformer(tvit.ViTConfig(
        patch_size=8, embed_dim=192, depth=2, num_heads=3))
    model.load_state_dict({k: _t(v) for k, v in
                           golden_state_dict(vit_golden).items()}, strict=True)
    g = {k: _t(np.transpose(vit_golden[k], (0, 2, 3, 1)))
         for k in ("x240", "x120")}
    g["cls_mask"] = _t(vit_golden["cls_mask"])
    return model, g


def _golden_outputs(model, g, key):
    """{name: array} of the port's outputs that golden ``key`` holds."""
    cfg = model.cfg
    glsa = tvit.get_last_selfattention
    if key == "attn240_cls":
        return {"full": glsa(model, g["x240"], cfg)[:, :, 0, :],
                "cls_only": glsa(model, g["x240"], cfg,
                                 cls_only=True)[:, :, 0]}
    if key == "attn120":
        return {"full": glsa(model, g["x120"], cfg)}
    if key == "attn_masked":
        return {m: glsa(model, g["x120"], cfg, cls_mask=g["cls_mask"],
                        cls_only=m == "cls_only")
                for m in ("full", "cls_only")}
    if key == "fm120":
        return {"forward_mask": tvit.forward_mask(model, g["x120"],
                                                  g["cls_mask"], cfg)}
    i = int(key[-1])
    return {"intermediate": tvit.get_intermediate_layers(
        model, g["x240"], cfg, n=2)[i]}


@pytest.mark.parametrize("key", ["attn240_cls", "attn120", "attn_masked",
                                 "fm120", "inter240_0", "inter240_1"])
def test_golden(vit_golden, golden, key):
    model, g = golden
    with torch.no_grad():
        outs = _golden_outputs(model, g, key)
    for name, out in outs.items():
        np.testing.assert_allclose(out.numpy(), vit_golden[key], atol=ATOL,
                                   rtol=RTOL, err_msg=name)


# ---------------------------------------------------------------------------
# equality with dino_tpu in float32: ViT-S/8 widths (D=384), depth 2, 240px
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jcfg = jvit.ViTConfig(patch_size=8)
    params = jax.tree.map(np.asarray, jvit.init_vit_params(
        jax.random.PRNGKey(0), jcfg, depth=2))
    model = tvit.VisionTransformer(tvit.ViTConfig(patch_size=8), depth=2)
    model.load_state_dict(strip_prefix(from_jax_params(params), "dino."),
                          strict=True)
    rs = np.random.RandomState(0)
    x = rs.randn(2, RES, RES, 3).astype(np.float32)
    mask = (rs.rand(4, GRID, GRID) > 0.5).astype(np.float32)
    return jcfg, params, model, x, mask


@pytest.mark.parametrize("masked", [False, True])
def test_attention_probs_matches_jax(masked):
    rs = np.random.RandomState(1)
    q, k = (rs.randn(2, 6, 901, 64).astype(np.float32) for _ in range(2))
    mask = (rs.rand(4, 30, 30) > 0.5).astype(np.float32) if masked else None
    out = tatt.attention_probs(_t(q), _t(k), 0.125,
                               None if mask is None else _t(mask))
    ref = np.asarray(attention_probs_xla(q, k, 0.125, mask))
    assert out.shape == ref.shape == ((2, 6, 4, 901) if masked
                                      else (2, 6, 901, 901))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=PROB_ATOL,
                               rtol=PROB_RTOL)


def test_block_apply_cls_mask_matches_jax(pair):
    jcfg, params, model, _, mask = pair
    x = np.random.RandomState(2).randn(1, 901, 384).astype(np.float32)
    with torch.no_grad():
        tokens, probs = tvit.block_apply(model.blocks[0], _t(x), model.cfg,
                                         cls_mask=_t(mask))
    ref_tokens, ref_probs = jvit.block_apply(params["blocks"][0], x, jcfg,
                                             cls_mask=mask)
    assert tokens.shape == (1, 4, 384) and probs.shape == (1, 6, 4, 901)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(ref_tokens),
                               atol=TOKEN_ATOL, rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs),
                               atol=PROB_ATOL, rtol=PROB_RTOL)


@pytest.mark.parametrize("cls_only", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_get_last_selfattention_matches_jax(pair, cls_only, masked):
    jcfg, params, model, x, mask = pair
    mask = mask if masked else None
    with torch.no_grad():
        out = tvit.get_last_selfattention(
            model, _t(x), model.cfg, None if mask is None else _t(mask),
            cls_only)
    ref = np.asarray(jvit.get_last_selfattention(params, x, jcfg, mask,
                                                 cls_only))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=PROB_ATOL,
                               rtol=PROB_RTOL)


def test_forward_mask_matches_jax(pair):
    jcfg, params, model, x, mask = pair
    with torch.no_grad():
        out = tvit.forward_mask(model, _t(x[:1]), _t(mask), model.cfg)
    ref = np.asarray(jvit.forward_mask(params, x[:1], mask, jcfg))
    assert out.shape == (4, 384)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOKEN_ATOL, rtol=0)


def test_get_intermediate_layers_matches_jax(pair):
    jcfg, params, model, x, _ = pair
    with torch.no_grad():
        outs = tvit.get_intermediate_layers(model, _t(x), model.cfg, n=2)
    refs = jvit.get_intermediate_layers(params, x, jcfg, n=2)
    assert len(outs) == len(refs) == 2
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=TOKEN_ATOL, rtol=0)


def _assert_bf16_close(out, ref):
    ref = np.asarray(ref, np.float32)
    top = np.abs(ref).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(np.asarray(out, np.float32) - ref).max() <= BF16_ULPS * ulp


# ---------------------------------------------------------------------------
# the four DINOSeg methods against dino_tpu's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seg_pair():
    """dino_tpu's DINOSeg (2 blocks, MLP head, seed 0) and the port's holding
    its weights, fp32, at 240px on the CPU."""
    jm = JaxDINOSeg(head="mlp", n_blocks=2, precision="fp32",
                    random_init=True, seed=0)
    pm = DINOSeg(head="mlp", n_blocks=2, precision="fp32", random_init=True,
                 device="cpu")
    pm.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, jm.vit_params),
        jax.tree.map(np.asarray, jm.head_params)))
    for m in (jm, pm):
        m.set_resolution(RES)
    rs = np.random.RandomState(3)
    frames = rs.randint(0, 256, (2, 240, 320, 3)).astype(np.uint8)
    mask = (rs.rand(3, GRID, GRID) > 0.5).astype(np.float32)
    return jm, pm, frames, mask


def test_dinoseg_get_intermediate_layers_matches_jax(seg_pair):
    jm, pm, frames, _ = seg_pair
    outs, refs = pm.get_intermediate_layers(frames, n=2), \
        jm.get_intermediate_layers(frames, n=2)
    for out, ref in zip(outs, refs):
        assert out.dtype == np.float32 and out.shape == (2, 901, 384)
        np.testing.assert_allclose(out, ref, atol=TOKEN_ATOL, rtol=0)


def test_dinoseg_bf16_get_intermediate_layers_matches_jax(seg_pair, tmp_path):
    """A bf16 model: the frames cast to bf16 after preprocessing, every
    dense layer rounding once, within BF16_ULPS of dino_tpu's."""
    jm, _, frames, _ = seg_pair
    path = str(tmp_path / "m.npz")
    jm.save(path)
    jb = JaxDINOSeg.load_from_checkpoint(path, precision="bf16")
    pb = DINOSeg.load_from_checkpoint(path, precision="bf16", device="cpu")
    for m in (jb, pb):
        m.set_resolution(RES)
    outs, refs = pb.get_intermediate_layers(frames, n=1), \
        jb.get_intermediate_layers(frames, n=1)
    assert len(outs) == 1 and outs[0].dtype == np.float32
    assert refs[0].dtype == jnp.bfloat16
    _assert_bf16_close(outs[0], refs[0])
    # bf16 values, widened exactly
    assert np.array_equal(_t(outs[0]).bfloat16().float().numpy(), outs[0])


def test_dinoseg_forward_mask_matches_jax(seg_pair):
    jm, pm, frames, mask = seg_pair
    out = pm.forward_mask(frames[0], mask)
    assert out.shape == (3, 384) and out.dtype == np.float32
    np.testing.assert_allclose(out, jm.forward_mask(frames[0], mask),
                               atol=TOKEN_ATOL, rtol=0)


@pytest.mark.parametrize("cls_only", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_dinoseg_get_last_selfattention_matches_jax(seg_pair, cls_only,
                                                    masked):
    jm, pm, frames, mask = seg_pair
    mask = mask if masked else None
    out = pm.get_last_selfattention(frames, mask, cls_only)
    ref = jm.get_last_selfattention(frames, mask, cls_only)
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=PROB_ATOL, rtol=PROB_RTOL)


def test_dinoseg_f32_calls_ignore_the_models_precision(seg_pair, tmp_path):
    """forward_mask and get_last_selfattention run float32 on a bf16 model,
    as in dino_tpu: the same bits as the fp32 model's."""
    _, pm, frames, mask = seg_pair
    path = str(tmp_path / "m.npz")
    pm.save(path)
    pb = DINOSeg.load_from_checkpoint(path, precision="bf16", device="cpu")
    pb.set_resolution(RES)
    assert np.array_equal(pb.forward_mask(frames[0], mask),
                          pm.forward_mask(frames[0], mask))
    assert np.array_equal(pb.get_last_selfattention(frames, cls_only=True),
                          pm.get_last_selfattention(frames, cls_only=True))


def test_dinoseg_mask_shape_is_checked(seg_pair):
    _, pm, frames, _ = seg_pair
    with pytest.raises(ValueError, match="cls_mask"):
        pm.forward_mask(frames[0], np.ones((2, GRID + 1, GRID), np.float32))


# ---------------------------------------------------------------------------
# O(N) memory at a 960px sequence (N = 14,401) on a thin ViT
# ---------------------------------------------------------------------------

N960 = 120 * 120 + 1


@pytest.fixture(scope="module")
def thin():
    cfg = tvit.ViTConfig(patch_size=8, embed_dim=32, depth=1, num_heads=2)
    model = tvit.init_vit_params(tvit.VisionTransformer(cfg),
                                 torch.Generator().manual_seed(0))
    x = _t(np.random.RandomState(4).randn(1, 960, 960, 3).astype(np.float32))
    return cfg, model, x


@pytest.fixture
def spies(monkeypatch):
    """Record attention_probs's q shapes and every torch.matmul's output
    shape."""
    seen = {"q": [], "matmul": []}
    real_probs, real_matmul = tatt.attention_probs, torch.matmul

    def probs(q, k, scale, cls_mask=None):
        seen["q"].append(tuple(q.shape))
        return real_probs(q, k, scale, cls_mask)

    def matmul(a, b, **kw):
        out = real_matmul(a, b, **kw)
        seen["matmul"].append(tuple(out.shape))
        return out

    monkeypatch.setattr(tatt, "attention_probs", probs)
    monkeypatch.setattr(tvit, "attention_probs", probs)
    monkeypatch.setattr(torch, "matmul", matmul)
    return seen


def _quadratic(shapes, n):
    return [s for s in shapes if s[-2:] == (n, n)]


def test_spies_see_the_full_matrix(spies):
    """The spies' yardstick: the full path at 64px forms (N, N)."""
    cfg = tvit.ViTConfig(patch_size=8, embed_dim=32, depth=1, num_heads=2)
    model = tvit.init_vit_params(tvit.VisionTransformer(cfg),
                                 torch.Generator().manual_seed(0))
    with torch.no_grad():
        tvit.get_last_selfattention(model, torch.zeros(1, 64, 64, 3), cfg)
    assert spies["q"] == [(1, 2, 65, 16)]
    assert _quadratic(spies["matmul"], 65)


def test_cls_only_is_linear_in_n(thin, spies):
    cfg, model, x = thin
    with torch.no_grad():
        attn = tvit.get_last_selfattention(model, x, cfg, cls_only=True)
    assert spies["q"] == [(1, 2, 1, 16)]
    assert not _quadratic(spies["matmul"], N960), spies["matmul"]
    assert attn.shape == (1, 2, 1, N960)
    np.testing.assert_allclose(attn.sum(-1).numpy(), 1.0, rtol=1e-5)
    from dino_tpu_torch.utils.frames import process_attentions
    assert process_attentions(attn.numpy(), resolution=960).shape == (2, 120,
                                                                        120)


def test_forward_mask_is_linear_in_n(thin, spies):
    cfg, model, x = thin
    mask = np.zeros((3, 120, 120), np.float32)
    mask[0, :40], mask[1, 40:80], mask[2, 80:] = 1, 1, 1
    with torch.no_grad():
        out = tvit.forward_mask(model, x, _t(mask), cfg)
    # the full q reaches attention_probs, which cuts it to the CLS row
    assert spies["q"] == [(1, 2, N960, 16)]
    assert not _quadratic(spies["matmul"], N960), spies["matmul"]
    assert out.shape == (3, 32) and bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# dropout and drop-path, held to their definitions
# ---------------------------------------------------------------------------

def _binomial_ok(kept, n, p):
    """|kept/n - p| within 5 standard deviations of a Binomial(n, p)."""
    return abs(kept / n - p) <= 5 * (p * (1 - p) / n) ** 0.5


@pytest.mark.parametrize("fn", [tvit.dropout, tvit.drop_path])
def test_rate_zero_is_the_identity(fn):
    x = torch.randn(64, 5, 8)
    assert torch.equal(fn(x, 0.0, torch.Generator().manual_seed(0)), x)


@pytest.mark.parametrize("fn", [tvit.dropout, tvit.drop_path])
def test_same_generator_same_mask(fn):
    x = torch.randn(64, 5, 8)
    a = fn(x, 0.3, torch.Generator().manual_seed(7))
    b = fn(x, 0.3, torch.Generator().manual_seed(7))
    c = fn(x, 0.3, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dropout_keeps_its_share_and_scales():
    x = torch.ones(200_000)
    y = tvit.dropout(x, 0.3, torch.Generator().manual_seed(1))
    kept = y != 0
    assert _binomial_ok(int(kept.sum()), x.numel(), 0.7)
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.7))


def test_drop_path_drops_whole_samples():
    x = torch.ones(20_000, 3, 4, dtype=torch.bfloat16)
    y = tvit.drop_path(x, 0.25, torch.Generator().manual_seed(2))
    assert y.dtype == torch.bfloat16
    per_sample = y.reshape(20_000, -1)
    kept = per_sample[:, 0] != 0
    assert torch.equal(per_sample, per_sample[:, :1].expand_as(per_sample))
    assert _binomial_ok(int(kept.sum()), 20_000, 0.75)
    assert torch.equal(per_sample[kept], torch.full_like(
        per_sample[kept], (torch.ones(1, dtype=torch.bfloat16) / 0.75).item()))


def test_block_apply_regularization_needs_a_generator_and_a_rate():
    cfg = tvit.ViTConfig(patch_size=8, embed_dim=64, num_heads=1)
    blk = tvit.Block(cfg)
    x = torch.randn(2, 17, 64)
    with torch.no_grad():
        plain = tvit.block_apply(blk, x, cfg)[0]
        # rate 0 with a generator, and rates > 0 without one: inference
        gen0 = tvit.block_apply(blk, x, cfg, generator=torch.Generator())[0]
        reg = tvit.ViTConfig(patch_size=8, embed_dim=64, num_heads=1,
                             drop_rate=0.2, attn_drop_rate=0.2)
        no_gen = tvit.block_apply(blk, x, reg, drop_path_rate=0.2)[0]
        assert torch.equal(gen0, plain) and torch.equal(no_gen, plain)
        a = tvit.block_apply(blk, x, reg, drop_path_rate=0.2,
                             generator=torch.Generator().manual_seed(3))[0]
        b = tvit.block_apply(blk, x, reg, drop_path_rate=0.2,
                             generator=torch.Generator().manual_seed(3))[0]
    assert torch.equal(a, b) and not torch.equal(a, plain)


# ---------------------------------------------------------------------------
# frame and visualization utilities, equal to dino_tpu's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grayscale", [False, True])
def test_transform_img_matches_jax(grayscale):
    from dino_tpu.utils.frames import transform_img as jax_transform
    from dino_tpu_torch.utils.frames import transform_img
    img = np.random.RandomState(5).randint(0, 256, (600, 640, 3)).astype(
        np.uint8)
    out = transform_img(img, grayscale=grayscale)
    assert out.shape == (1, 480, 480, 3) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jax_transform(img, grayscale=grayscale)))


@pytest.mark.parametrize("threshold", [None, 0.6])
def test_process_attentions_matches_jax(threshold):
    from dino_tpu.utils.frames import process_attentions as jax_process
    from dino_tpu_torch.utils.frames import process_attentions
    a = np.random.RandomState(6).rand(1, 6, 1, 901).astype(np.float32)
    a /= a.sum(-1, keepdims=True)
    out = process_attentions(a, threshold=threshold, resolution=RES)
    assert out.shape == (6, GRID, GRID)
    np.testing.assert_array_equal(out, jax_process(a, threshold=threshold,
                                                   resolution=RES))
    np.testing.assert_array_equal(
        process_attentions(_t(a), threshold=threshold, resolution=RES), out)


def test_viz_matches_jax():
    from dino_tpu.utils import viz as jviz
    from dino_tpu_torch.utils import viz
    rs = np.random.RandomState(7)
    label = rs.randint(0, 7, (48, 48)).astype(np.int32)
    rgb = rs.randint(0, 256, (48, 48, 3)).astype(np.uint8)
    np.testing.assert_array_equal(viz.voc_colormap(), jviz.voc_colormap())
    np.testing.assert_array_equal(viz.rgb2gray(rgb), jviz.rgb2gray(rgb))
    for base in (None, viz.rgb2gray(rgb), rgb):
        np.testing.assert_array_equal(viz.label2rgb(label, base),
                                      jviz.label2rgb(label, base))


def test_dt_frames_matches_jax(tmp_path):
    from PIL import Image
    from dino_tpu.utils.frames import dt_frames as jax_frames
    from dino_tpu_torch.utils.frames import dt_frames
    rs = np.random.RandomState(9)
    frames, labels = tmp_path / "frames", tmp_path / "labels"
    frames.mkdir()
    labels.mkdir()
    for i in range(4):
        Image.fromarray(rs.randint(0, 255, (16, 16, 3), np.uint8)).save(
            frames / f"f{i}.png")
        Image.fromarray(rs.randint(0, 7, (16, 16, 3), np.uint8)).save(
            labels / f"f{i}.png")
    (frames / "notes.txt").write_text("not a frame")
    for kw in ({}, {"max": 2}, {"subset": [1, 3]},
               {"subset": [0, 2, 3], "max": 2},
               {"label_path": str(labels)}):
        got = list(dt_frames(str(frames), **kw))
        want = list(jax_frames(path=str(frames), **kw))
        assert [g[0] for g in got] == [w[0] for w in want], kw
        for g, w in zip(got, want):
            assert len(g) == len(w) == (3 if "label_path" in kw else 2)
            for a, b in zip(g[1:], w[1:]):
                assert a.size == (16, 16)
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(list(dt_frames(str(frames)))) == 4


def test_dt_frames_needs_a_path():
    from dino_tpu_torch.utils.frames import dt_frames
    with pytest.raises(TypeError):
        dt_frames()


def test_parse_class_names_matches_jax(tmp_path):
    from dino_tpu.utils.labels import parse_class_names as jax_parse
    from dino_tpu_torch.utils.labels import parse_class_names
    path = tmp_path / "labels.txt"
    path.write_text("__ignore__\n_background_\nroad\nduckie\n")
    assert parse_class_names(str(path)) == jax_parse(str(path))
    bad = tmp_path / "bad.txt"
    bad.write_text("_background_\nroad\n")
    with pytest.raises(ValueError, match="__ignore__"):
        parse_class_names(str(bad))


@pytest.mark.parametrize("shape,out", [((30, 30), (240, 240)),
                                       ((17, 23), (8, 40)),
                                       ((60, 60), (60, 60))])
def test_resize_nearest_matches_jax(shape, out):
    from dino_tpu.ops.resize import resize_nearest as jax_nearest
    from dino_tpu_torch.ops.resize import resize_nearest
    m = np.random.RandomState(8).rand(*shape).astype(np.float32)
    np.testing.assert_array_equal(resize_nearest(m, *out),
                                  jax_nearest(m, *out))


# ---------------------------------------------------------------------------
# the two CLIs: the arrays they write, against the JAX CLIs'
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """A 1-block fp32 checkpoint written by dino_tpu, a 320x320 image and a
    labels.txt."""
    from PIL import Image
    d = tmp_path_factory.mktemp("cli")
    jm = JaxDINOSeg(head="mlp", n_blocks=1, precision="fp32",
                    random_init=True, seed=2)
    ckpt = str(d / "m.npz")
    jm.save(ckpt)
    os.makedirs(d / "images")
    img = np.random.RandomState(9).randint(0, 256, (320, 320, 3)).astype(
        np.uint8)
    Image.fromarray(img).save(d / "images" / "f0.png")
    labels = d / "labels.txt"
    labels.write_text("__ignore__\n_background_\n" + "".join(
        f"c{i}\n" for i in range(1, 7)))
    return d, ckpt, str(labels)


def test_visualize_cli_matches_jax(cli_inputs):
    from PIL import Image
    from dino_tpu.cli.visualize import inference as jax_inference
    from dino_tpu_torch.cli import visualize
    d, ckpt, labels = cli_inputs
    jax_inference(ckpt, str(d / "images"), str(d / "jax_out"), labels,
                  resolution=RES, cpu=True)
    visualize.inference(ckpt, str(d / "images"), str(d / "port_out"), labels,
                        resolution=RES, cpu=True)
    want = np.asarray(Image.open(d / "jax_out" / "f0.png"))
    np.testing.assert_array_equal(
        np.asarray(Image.open(d / "port_out" / "f0.png")), want)
    model = DINOSeg.load_from_checkpoint(ckpt, device="cpu")
    model.set_resolution(RES)
    img = Image.open(d / "images" / "f0.png").convert("RGB")
    out = visualize.overlay(model, np.asarray(img),
                            np.array(img.resize((480, 480))))
    assert out.shape == (480, 480, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, want)


def test_visualize_attention_cli_matches_jax(cli_inputs, monkeypatch):
    import matplotlib.pyplot as plt
    from PIL import Image
    from dino_tpu.cli.visualize_attention import vis_mask as jax_vis_mask
    from dino_tpu_torch.cli import visualize_attention
    d, ckpt, _ = cli_inputs
    written = {}

    def imsave(fname, arr, **kw):
        written[fname] = np.asarray(arr)

    monkeypatch.setattr(plt, "imsave", imsave)
    image = str(d / "images" / "f0.png")
    jax_vis_mask(ckpt, image, str(d / "jax_attn"), resolution=RES)
    visualize_attention.vis_mask(ckpt, image, str(d / "port_attn"),
                                 resolution=RES, cpu=True)
    names = sorted(os.path.basename(f) for f in written if "jax_attn" in f)
    assert names == ["attn-head-dino%d.png" % j for j in range(6)] + [
        "img.png"]
    for name in names:
        got = written[str(d / "port_attn" / name)]
        want = written[str(d / "jax_attn" / name)]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=PROB_RTOL,
                                   err_msg=name)
    model = DINOSeg.load_from_checkpoint(ckpt, device="cpu")
    model.set_resolution(RES)
    img = np.array(Image.open(image).convert("RGB"))
    maps = visualize_attention.attention_maps(model, img)
    assert maps.shape == (6, RES, RES)
    for j in range(6):
        np.testing.assert_array_equal(
            maps[j], written[str(d / "port_attn" / f"attn-head-dino{j}.png")])


# ---------------------------------------------------------------------------
# Pillow and matplotlib are not needed to import the port
# ---------------------------------------------------------------------------

def test_imports_need_neither_pillow_nor_matplotlib():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "import dino_tpu_torch.api\n"
        "import dino_tpu_torch.cli.visualize\n"
        "import dino_tpu_torch.cli.visualize_attention\n"
        "import dino_tpu_torch.utils.labels\n"
        "import dino_tpu_torch.utils.viz as viz\n"
        "from dino_tpu_torch.utils import frames\n"
        "import chip_smoke\n"
        "img = np.zeros((64, 64, 3), np.uint8)\n"
        "assert frames.transform_img(img, resolution=32).shape == "
        "(1, 32, 32, 3)\n"
        "a = np.full((1, 2, 1, 17), 1 / 17, np.float32)\n"
        "assert frames.process_attentions(a, 0.5, resolution=32).shape == "
        "(2, 4, 4)\n"
        "assert viz.label2rgb(np.zeros((4, 4), np.int32)).shape == (4, 4, 3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('PIL', 'matplotlib') and sys.modules[m] is not None)\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-I", "-c", code], check=True,
                   timeout=300, cwd=REPO)
