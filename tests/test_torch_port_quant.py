"""int8 serving (ROADMAP item 8.1): dino_tpu_torch.ops.quant and
DINOSeg(precision='int8') against dino_tpu.ops.quant and dino_tpu's int8
DINOSeg, on the same seeded numpy inputs, on the CPU.

dino_tpu quantizes weights eagerly and activations inside its jitted
predict, so the activation side is held to ``jax.jit(int8_dense)``: XLA
turns the token scale's ``/ 127.0`` into a product with fl(1/127) and fuses
the dequantize's last product and the bias add into an fma, and the port
follows both (ops/quant.py).  Measured on this CPU: weight codes and scales,
token codes and scales and int8_dense's bf16 and float32 outputs all equal,
0 of 512,000 outputs differing.  Follows tests/test_quant.py.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tpu.api import DINOSeg as JaxDINOSeg
from dino_tpu.models import vit as jvit
from dino_tpu.ops.preprocess import preprocess as jax_preprocess
from dino_tpu.ops.quant import (int8_dense as jint8_dense,
                                quantize_dense_params, quantize_vit_params)
from dino_tpu.train.loop import seg_forward as jax_seg_forward
from dino_tpu_torch import DINOSeg, export_predict, load_exported_predict
from dino_tpu_torch.checkpointing.convert import from_jax_params, strip_prefix
from dino_tpu_torch.models.vit import ViTConfig, VisionTransformer, vit_forward
from dino_tpu_torch.ops import fused_mlp as tfm
from dino_tpu_torch.ops.quant import (QuantLinear, int8_dense, quantize_dense,
                                      quantize_tokens, quantize_vit)

RES = 240
# int8 labels vs dino_tpu's: both run bf16 around the int8 products, and
# their GELUs differ (XLA:CPU's erfc is not torch's:
# test_gelu_erfc_differs_from_torch_by_one_ulp), so a bf16 step can flip an
# argmax.  Measured at 240px, 2 blocks: max |log-prob diff| 2.9e-3, 4 of
# 900 patches differing, all at a top-2 gap below 6.4e-4.
INT8_MARGIN = 1e-2
# int8 ViT tokens vs dino_tpu's (embed 64, 2 blocks, 48px): max |diff|
# against max |ref|; measured 0.0081 in bf16 and 2.1e-7 in float32
VIT_BF16_REL, VIT_F32_REL = 2e-2, 1e-5
KW = dict(backbone="vit", n_blocks=2, head="mlp", n_classes=7,
          random_init=True, seed=3)


def _dense(rs, k, n):
    return (rs.randn(k, n).astype(np.float32) * 0.02,
            rs.randn(n).astype(np.float32) * 0.01)


def _port_layer(kernel, bias):
    return quantize_dense(torch.from_numpy(kernel.T.copy()),
                          torch.from_numpy(bias))


def test_quantize_dense_codes_and_scales_match_dino_tpu():
    kernel, bias = _dense(np.random.RandomState(0), 384, 1536)
    ref = quantize_dense_params({"kernel": jnp.asarray(kernel),
                                 "bias": jnp.asarray(bias)})
    q = _port_layer(kernel, bias)
    assert isinstance(q, QuantLinear) and q.weight_i8.dtype == torch.int8
    assert q.weight_i8.shape == (1536, 384) and q.weight_i8.is_contiguous()
    np.testing.assert_array_equal(q.weight_i8.numpy().T,
                                  np.asarray(ref["kernel_i8"]))
    np.testing.assert_array_equal(q.w_scale.numpy(),
                                  np.asarray(ref["w_scale"]))
    np.testing.assert_array_equal(q.bias.numpy(), bias)
    assert int(q.weight_i8.abs().max()) == 127


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_dense_matches_dino_tpu(dtype):
    """Token codes, token scales and the output against jax.jit's, bit for
    bit (0 differing)."""
    rs = np.random.RandomState(1)
    kernel, bias = _dense(rs, 384, 256)
    x = rs.randn(2000, 384).astype(np.float32)
    p = quantize_dense_params({"kernel": jnp.asarray(kernel),
                               "bias": jnp.asarray(bias)})
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))

    def jax_codes(x):
        xf = x.astype(jnp.float32)
        s_row = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True),
                            1e-12) / 127.0
        return jnp.clip(jnp.round(xf / s_row), -127, 127), s_row

    ref_codes, ref_scale = jax.jit(jax_codes)(xj)
    codes, scale = quantize_tokens(xt)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))
    ref = np.asarray(jax.jit(jint8_dense)(p, xj).astype(jnp.float32))
    out = int8_dense(_port_layer(kernel, bias), xt)
    assert out.dtype == xt.dtype and out.shape == (2000, 256)
    np.testing.assert_array_equal(out.float().numpy(), ref)


def test_int8_dense_close_to_f32():
    """tests/test_quant.py's bound: within 2% of max |x @ W + b|."""
    rs = np.random.RandomState(0)
    x = rs.randn(64, 384).astype(np.float32)
    kernel, bias = _dense(rs, 384, 256)
    ref = x @ kernel + bias
    out = int8_dense(_port_layer(kernel, bias), torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 0.02


def test_int8_dense_pads_short_inputs():
    """Fewer than 17 rows (the card's _int_mm minimum) are padded: each row
    is its own product."""
    rs = np.random.RandomState(2)
    kernel, bias = _dense(rs, 64, 32)
    q = _port_layer(kernel, bias)
    x = torch.from_numpy(rs.randn(40, 64).astype(np.float32))
    full = int8_dense(q, x)
    np.testing.assert_array_equal(int8_dense(q, x[:3]).numpy(),
                                  full[:3].numpy())
    np.testing.assert_array_equal(int8_dense(q, x[None, :5]).numpy()[0],
                                  full[:5].numpy())


@pytest.fixture(scope="module")
def small_vit():
    jcfg = jvit.ViTConfig(patch_size=8, embed_dim=64, num_heads=2)
    params = jax.tree.map(np.asarray, jvit.init_vit_params(
        jax.random.PRNGKey(0), jcfg, depth=2))
    cfg = ViTConfig(patch_size=8, embed_dim=64, num_heads=2)
    vit = VisionTransformer(cfg, depth=2)
    vit.load_state_dict(strip_prefix(from_jax_params(params), "dino."))
    return jcfg, params, cfg, vit


def test_quantize_vit_structure(small_vit):
    _, _, _, vit = small_vit
    q = quantize_vit(vit)
    blk = q.blocks[0]
    for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
        assert isinstance(lin, QuantLinear)
        assert lin.weight_i8.dtype == torch.int8
    assert not hasattr(blk.mlp.fc1, "weight")
    # float leaves shared, not copied; the masters untouched
    assert q.pos_embed is vit.pos_embed and q.cls_token is vit.cls_token
    assert q.patch_embed.proj.weight is vit.patch_embed.proj.weight
    assert q.blocks[1].norm2.weight is vit.blocks[1].norm2.weight
    assert isinstance(vit.blocks[0].mlp.fc1, torch.nn.Linear)


@pytest.mark.parametrize("dtype,rel", [("bfloat16", VIT_BF16_REL),
                                       ("float32", VIT_F32_REL)])
def test_int8_vit_forward_matches_dino_tpu(small_vit, dtype, rel,
                                           record_property):
    jcfg, params, cfg, vit = small_vit
    x = np.random.RandomState(1).randn(2, 48, 48, 3).astype(np.float32)
    qp = quantize_vit_params(jax.tree.map(jnp.asarray, params))
    ref = np.asarray(jax.jit(lambda q, x: jvit.vit_forward(
        q, x, jcfg, use_flash=False))(
            qp, jnp.asarray(x).astype(getattr(jnp, dtype))).astype(
                jnp.float32))
    with torch.no_grad():
        out = vit_forward(quantize_vit(vit), torch.from_numpy(x).to(
            getattr(torch, dtype)), cfg).float().numpy()
    got = np.abs(out - ref).max() / np.abs(ref).max()
    record_property("max_abs_diff_over_max_ref", float(got))
    assert got < rel


@pytest.fixture(scope="module")
def int8_pair():
    """dino_tpu's int8 DINOSeg (2 blocks, MLP head, 7 classes, seed 3, as
    tests/test_quant.py) and the port's on its weights, at 240px."""
    jm = JaxDINOSeg(precision="int8", **KW)
    jm.set_resolution(RES)
    pm = DINOSeg(precision="int8", device="cpu", **KW)
    pm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.vit_params),
                                       jax.tree.map(np.asarray, jm.head_params)))
    pm.set_resolution(RES)
    return jm, pm


def _frame(seed=0):
    return np.random.RandomState(seed).randint(0, 255, (240, 320, 3),
                                               np.uint8)


def test_int8_labels_match_dino_tpu_except_near_ties(int8_pair,
                                                     record_property):
    jm, pm = int8_pair
    img = _frame()
    fn = jax.jit(lambda v, h, x: jax_seg_forward(
        v, h, jm.cfg, "mlp", pre_normalized=jax_preprocess(x, RES),
        compute_dtype=jnp.bfloat16))
    ref_logp = np.asarray(fn(jm._serving_vit_params("int8"), jm.head_params,
                             jnp.asarray(img[None])))
    logp = pm.log_probs(torch.from_numpy(img[None])).numpy()
    record_property("logp_max_abs_diff", float(np.abs(logp - ref_logp).max()))
    assert np.abs(logp - ref_logp).max() < INT8_MARGIN / 2
    out = pm.predict(img)
    assert out.shape == (480, 480) and out.dtype == np.int32
    top2 = np.sort(ref_logp, axis=-1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) < INT8_MARGIN
    low = out[::16, ::16].reshape(-1)
    differ = low != ref_logp.argmax(-1)
    record_property("patches_differing", int(differ.sum()))
    record_property("largest_gap_differing", float(
        (top2[:, 1] - top2[:, 0])[differ].max()) if differ.any() else 0.0)
    np.testing.assert_array_equal(low[~near], ref_logp.argmax(-1)[~near])


def test_int8_agrees_with_bf16(int8_pair, record_property):
    """tests/test_quant.py's bound: int8 and bf16 label maps agree on more
    than 85% of pixels (measured 99.7%)."""
    _, pm = int8_pair
    img = _frame()
    a = pm.predict(img, precision="bf16")
    b = pm.predict(img)
    assert b.shape == (480, 480) and b.dtype == a.dtype
    record_property("agreement", float((a == b).mean()))
    assert float((a == b).mean()) > 0.85


def test_int8_takes_no_fused_mlp_and_per_call_override(int8_pair):
    _, pm = int8_pair
    img = _frame(1)
    assert pm.precision == "int8"
    assert pm.compute_dtype == torch.bfloat16
    np.testing.assert_array_equal(pm.predict_batch(img[None])[0],
                                  pm.predict(img))
    frames = [_frame(s) for s in range(3)]
    streamed = list(pm.predict_stream(iter(frames), batch_size=2))
    np.testing.assert_array_equal(np.stack(streamed),
                                  pm.predict_batch(np.stack(frames)))
    bf16 = DINOSeg(precision="bf16", device="cpu", **KW)
    bf16.load_state_dict(pm.model.state_dict())
    bf16.set_resolution(RES)
    np.testing.assert_array_equal(bf16.predict(img, precision="int8"),
                                  pm.predict(img))
    np.testing.assert_array_equal(pm.predict(img, precision="bf16"),
                                  bf16.predict(img))
    # the serving copy's MLP is int8: the fused kernel's route is not taken
    blocks = pm._serving_model().dino.blocks
    assert all(isinstance(b.mlp.fc1, QuantLinear) for b in blocks)
    launches = tfm.fused_ln_mlp_residual.launches
    pm.predict(img)
    assert tfm.fused_ln_mlp_residual.launches == launches


def test_int8_cache_rebuilds_after_weight_write(int8_pair):
    _, pm = int8_pair
    first = pm._serving_model()
    assert pm._serving_model() is first  # cached
    assert pm._serving_model("bf16") is pm.model
    fc1 = pm.model.dino.blocks[0].mlp.fc1
    saved = fc1.weight.detach().clone()
    try:
        with torch.no_grad():
            fc1.weight.mul_(2.0)
        second = pm._serving_model()
        assert second is not first
        np.testing.assert_array_equal(
            second.dino.blocks[0].mlp.fc1.w_scale.numpy(),
            2 * first.dino.blocks[0].mlp.fc1.w_scale.numpy())
    finally:
        with torch.no_grad():
            fc1.weight.copy_(saved)
    third = pm._serving_model()
    np.testing.assert_array_equal(third.dino.blocks[0].mlp.fc1.w_scale,
                                  first.dino.blocks[0].mlp.fc1.w_scale)


def test_int8_guards_raise():
    with pytest.raises(ValueError, match="int8"):
        DINOSeg(backbone="cnn1", precision="int8", random_init=True,
                device="cpu")
    cnn = DINOSeg(backbone="cnn1", head="linear", n_classes=3,
                  random_init=True, device="cpu")
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(ValueError, match="int8"):
        cnn.predict(img, precision="int8")
    vit = DINOSeg(n_blocks=1, head="linear", n_classes=3, random_init=True,
                  device="cpu")
    with pytest.raises(ValueError, match="unsupported precision"):
        vit.predict(img, precision="bf-16")
    for par in ("sp", "tp"):
        with pytest.raises(ValueError, match="int8"):
            vit.predict(img, precision="int8", parallelism=par)


def test_int8_export_round_trip(int8_pair, tmp_path):
    """The int8 artifact holds the codes and scales and, loaded on the CPU,
    gives the eager int8 labels."""
    _, pm = int8_pair
    path = str(tmp_path / "int8.dtts")
    export_predict(pm, path, batch_size=2, in_shape=(100, 120),
                   precision="int8")
    art = torch.load(path, weights_only=True)
    assert art["contract"]["precision"] == "int8"
    assert art["state_dict"]["dino.blocks.0.mlp.fc1.weight_i8"].dtype == \
        torch.int8
    frames = np.stack([_frame(s)[:100, :120] for s in (4, 5)])
    served = load_exported_predict(path, device="cpu")
    np.testing.assert_array_equal(served(frames), pm.predict_batch(frames))


def test_int8_server_on_cpu(int8_pair, tmp_path):
    """dt-serve --precision int8 over a checkpoint: a posted frame's labels
    are the eager int8 predict's."""
    import io
    import threading
    import urllib.request

    from PIL import Image

    from dino_tpu_torch.cli.serve import make_server
    from tests import free_port
    _, pm = int8_pair
    ckpt = str(tmp_path / "m.ckpt.npz")
    pm.save(ckpt)
    port = free_port()
    server = make_server(ckpt, port=port, resolution=RES, precision="int8",
                         device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        img = _frame(6)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            labels = np.load(io.BytesIO(resp.read()))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
    assert health["precision"] == "int8"
    np.testing.assert_array_equal(labels, pm.predict(img))


def test_dino_tpu_int8_roundings_depend_on_jit(record_property):
    """Why the port follows jax.jit's forms, not the source's: under jit,
    XLA multiplies the token scale by fl(1/127) and fuses the dequantize's
    last product and bias into an fma, so jitted and eager dino_tpu
    differ; the unfused product differs from both.  The counts at this
    test's shapes go to the report (``record_property``) and ROADMAP
    section 3."""
    rs = np.random.RandomState(1)
    kernel, bias = _dense(rs, 384, 1536)
    x = rs.randn(2000, 384).astype(np.float32)
    params = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    scale_eager = np.asarray(quantize_dense_params(params)["w_scale"])
    scale_jit = np.asarray(jax.jit(quantize_dense_params)(params)["w_scale"])
    p = quantize_dense_params(params)
    q = _port_layer(kernel, bias)
    xf = jnp.asarray(x)

    def s_row(x):
        return jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True),
                           1e-12) / 127.0

    counts = {"weight_scales_jit_vs_eager": int(
        (scale_jit != scale_eager).sum()),
        "token_scales_jit_vs_eager": int(
            (np.asarray(jax.jit(s_row)(xf)) != np.asarray(s_row(xf))).sum())}
    codes, s = quantize_tokens(torch.from_numpy(x))
    y = torch._int_mm(codes, q.weight_i8.t()) * s
    unfused = (y * q.w_scale + q.bias).numpy()
    ref = np.asarray(jax.jit(jint8_dense)(p, xf))
    counts["outputs_unfused_vs_jit"] = int((unfused != ref).sum())
    counts["outputs_port_vs_jit"] = int(
        (int8_dense(q, torch.from_numpy(x)).numpy() != ref).sum())
    for k, v in counts.items():
        record_property(k, v)
    assert counts["token_scales_jit_vs_eager"] > 0
    assert counts["outputs_unfused_vs_jit"] > 0
    assert counts["outputs_port_vs_jit"] == 0
    np.testing.assert_array_equal(q.w_scale.numpy(), scale_eager)


def test_gelu_erfc_differs_from_torch_by_one_ulp(record_property):
    """dino_tpu's GELU (jax.nn.gelu: erfc) is not the port's (F.gelu's
    erf): XLA:CPU's float32 erfc and torch's part by up to one float32 ulp
    of 1 (2^-23) at many points, so int8 labels agree with dino_tpu's
    except near ties (INT8_MARGIN)."""
    z = np.random.RandomState(0).randn(100_000).astype(np.float32) * 2
    ref = np.asarray(jax.jit(jax.lax.erfc)(jnp.asarray(z)))
    got = torch.special.erfc(torch.from_numpy(z)).numpy()
    differ = ref != got
    record_property("erfc_points_differing", int(differ.sum()))
    assert 0 < differ.sum() < z.size
    assert np.abs(got - ref).max() <= 2.0 ** -23
