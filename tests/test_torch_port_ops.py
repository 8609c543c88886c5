"""dino_tpu_torch ops vs dino_tpu ops on the same inputs (numpy, seeded).

The JAX side runs as dino_tpu's own tests run it on the CPU: the Pallas
kernels in interpret mode, matmuls at 'highest' precision (tests/conftest.py).
The port's ops take their plain PyTorch versions here (CPU tensors); the
kernels are held against them on the card in tests/test_torch_port_cuda.py.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from dino_tpu.ops import attention as jatt
from dino_tpu.ops import bicubic as jbic
from dino_tpu.ops import fused_mlp as jfm
from dino_tpu.ops import resize as jres
from dino_tpu.ops import upsample as jups
from dino_tpu_torch.precision import true_fp32
from dino_tpu_torch.models.vit import Mlp, ViTConfig, mlp_residual
from dino_tpu_torch.ops import attention as tatt
from dino_tpu_torch.ops import bicubic as tbic
from dino_tpu_torch.ops import fused_mlp as tfm
from dino_tpu_torch.ops import preprocess as tpre
from dino_tpu_torch.ops import resize as tres
from dino_tpu_torch.ops import upsample as tups

# dino_tpu.ops re-exports the function preprocess under the module's name
jpre = importlib.import_module("dino_tpu.ops.preprocess")
EPS = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulp(mag: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at each |mag| (8-bit significand)."""
    mag = np.maximum(np.abs(mag.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _assert_within_residual_ulps(out, ref, x, n_ulps=2):
    """|out - ref| <= n bf16 ulps at the scale of the residual add's
    operands, max(|x|, |ref|, |ref - x|).  The two sides sum the f32
    products in another order, which can move the bf16 rounding of
    h = fc2(..) by one step; where x + h cancels, that step is an ulp of h,
    not of the (smaller) output."""
    out, ref, x = (np.asarray(a, np.float32) for a in (out, ref, x))
    h = ref - x
    scale = np.maximum(np.maximum(np.abs(x), np.abs(ref)), np.abs(h))
    err = np.abs(out - ref)
    assert (err <= n_ulps * _bf16_ulp(scale)).all(), err.max()


# ---------------------------------------------------------------------------
# (a), (b) attention: plain version vs the Pallas flash kernel (interpret)
# ---------------------------------------------------------------------------

def _qkv(n, seed, b=1, nh=2, hd=64):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, nh, n, hd).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", [37, 226, 901, 127, 129, 191, 193])
def test_attention_plain_matches_pallas_flash(n):
    q, k, v = _qkv(n, n)
    scale = 64 ** -0.5
    ref = jatt.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale, True)
    out, lse = tatt.attention_plain(_t(q), _t(k), _t(v), scale)
    assert out.shape == q.shape and lse.shape == (2, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [37, 901])
def test_attention_plain_lse_matches_pallas(n):
    q, k, v = _qkv(n, n + 1)
    scale = 64 ** -0.5
    _, ref_lse = jatt._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), scale, True,
                                      return_lse=True)
    _, lse = tatt.attention_plain(_t(q), _t(k), _t(v), scale)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :n, 0],
                               atol=1e-5, rtol=0)


def test_flash_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (_t(a) for a in _qkv(50, 3, b=2, nh=3))
    before = tatt.flash_attention.launches
    out, lse = tatt.flash_attention(q, k, v, 0.125, return_lse=True)
    ref, ref_lse = tatt.attention_plain(q, k, v, 0.125)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert torch.equal(tatt.flash_attention(q, k, v, 0.125), ref)
    assert tatt.flash_attention.launches == before  # no kernel on the CPU


def test_attention_plain_chunking_is_exact(monkeypatch):
    """Chunking the plain version over query rows changes nothing."""
    q, k, v = (_t(a) for a in _qkv(300, 4))
    full = tatt.attention_plain(q, k, v, 0.125)
    monkeypatch.setattr(tatt, "_PLAIN_SCORE_ELEMS", 2 * 300 * 7)
    chunked = tatt.attention_plain(q, k, v, 0.125)
    assert torch.equal(full[0], chunked[0]) and torch.equal(full[1], chunked[1])


# ---------------------------------------------------------------------------
# (c), (d) fused LN + MLP + residual
# ---------------------------------------------------------------------------

def _mlp_case(m=64, d=384, h=1536, seed=0):
    rs = np.random.RandomState(seed)
    return dict(
        x=rs.randn(m, d).astype(np.float32),
        w1=(rs.randn(d, h) * 0.05).astype(np.float32),
        b1=(rs.randn(h) * 0.1).astype(np.float32),
        w2=(rs.randn(h, d) * 0.05).astype(np.float32),
        b2=(rs.randn(d) * 0.1).astype(np.float32),
        g=(1 + rs.randn(d) * 0.1).astype(np.float32),
        bt=(rs.randn(d) * 0.1).astype(np.float32))


def _torch_mlp(c):
    """nn.LayerNorm + the port's Mlp holding the case's weights (torch
    (out, in) layout)."""
    d, h = c["w1"].shape
    norm = torch.nn.LayerNorm(d, eps=EPS)
    mlp = Mlp(ViTConfig(embed_dim=d, mlp_ratio=h / d))
    with torch.no_grad():
        norm.weight.copy_(_t(c["g"]))
        norm.bias.copy_(_t(c["bt"]))
        mlp.fc1.weight.copy_(_t(c["w1"].T))
        mlp.fc1.bias.copy_(_t(c["b1"]))
        mlp.fc2.weight.copy_(_t(c["w2"].T))
        mlp.fc2.bias.copy_(_t(c["b2"]))
    return norm, mlp


def _jax_params(c):
    return ({"scale": c["g"], "bias": c["bt"]},
            {"fc1": {"kernel": c["w1"], "bias": c["b1"]},
             "fc2": {"kernel": c["w2"], "bias": c["b2"]}})


def _pallas_fused(c, dtype, rows=32):
    """The Pallas kernel itself, interpret mode, with the BlockSpecs of
    dino_tpu/ops/fused_mlp.py:93-106 (row tile shrunk for the small M)."""
    m, d = c["x"].shape
    h = c["w1"].shape[1]
    x = jnp.asarray(c["x"]).astype(dtype)
    return pl.pallas_call(
        functools.partial(jfm._kernel, eps=EPS),
        grid=(m // rows,),
        in_specs=[
            pl.BlockSpec((rows, d), lambda i: (i, 0)),
            pl.BlockSpec((d, h), lambda i: (0, 0)),
            pl.BlockSpec((h,), lambda i: (0,)),
            pl.BlockSpec((h, d), lambda i: (0, 0)),
            pl.BlockSpec((d,), lambda i: (0,)),
            pl.BlockSpec((d,), lambda i: (0,)),
            pl.BlockSpec((d,), lambda i: (0,)),
        ],
        out_specs=pl.BlockSpec((rows, d), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m, d), dtype),
        interpret=True,
    )(x, jnp.asarray(c["w1"]).astype(dtype), c["b1"],
      jnp.asarray(c["w2"]).astype(dtype), c["b2"], c["g"], c["bt"])


def test_fused_mlp_plain_matches_pallas_kernel_f32():
    c = _mlp_case(seed=1)
    ref = np.asarray(_pallas_fused(c, jnp.float32))
    norm, mlp = _torch_mlp(c)
    out = tfm.fused_ln_mlp_residual_plain(norm, mlp, _t(c["x"]), EPS)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=0)


def test_fused_mlp_plain_matches_pallas_kernel_bf16():
    """Within 2 bf16 ulps (see _assert_within_residual_ulps)."""
    c = _mlp_case(seed=2)
    ref = np.asarray(_pallas_fused(c, jnp.bfloat16).astype(jnp.float32))
    norm, mlp = _torch_mlp(c)
    x = _t(c["x"]).to(torch.bfloat16)
    out = tfm.fused_ln_mlp_residual_plain(norm, mlp, x, EPS)
    assert out.dtype == torch.bfloat16
    _assert_within_residual_ulps(out.detach().float(), ref, x.float())


@pytest.mark.parametrize("m", [1, 63, 65, 129])
def test_fused_mlp_plain_matches_pallas_kernel_at_tile_edges(m):
    """Row counts on both sides of the CUDA kernel's 64-row blocks, the
    Pallas kernel run on x padded with zero rows to its 32-row tile; under
    the kernels' tolerance (chip_smoke.mlp_err: 2 bf16 ulps of the residual
    add's operands plus one ulp of rms(h), where x + h cancels)."""
    c = _mlp_case(m=m, seed=10 + m)
    mp = -(-m // 32) * 32
    cp = dict(c, x=np.concatenate([c["x"], np.zeros((mp - m, 384),
                                                    np.float32)]))
    ref = np.array(_pallas_fused(cp, jnp.bfloat16).astype(jnp.float32))[:m]
    norm, mlp = _torch_mlp(c)
    x = _t(c["x"]).to(torch.bfloat16)
    out = tfm.fused_ln_mlp_residual_plain(norm, mlp, x, EPS)
    assert chip_smoke.mlp_err(out.detach(), torch.from_numpy(ref), x)[2]


def test_mlp_composition_matches_xla_reference_f32():
    """The fp32 path's composition (true erf) == _xla_reference."""
    c = _mlp_case(m=40, seed=3)
    ref = np.asarray(jfm._xla_reference(*_jax_params(c), jnp.asarray(c["x"]),
                                        EPS))
    norm, mlp = _torch_mlp(c)
    out = mlp_residual(norm, mlp, _t(c["x"]), EPS)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=0)


def test_fused_mlp_plain_matches_xla_reference_bf16():
    """A&S erf (|err| < 1.5e-7) vs true erf: below bf16 resolution, so the
    outputs agree to bf16 rounding (2 ulps, as above)."""
    c = _mlp_case(m=40, seed=4)
    x = jnp.asarray(c["x"]).astype(jnp.bfloat16)
    ref = np.asarray(jfm._xla_reference(*_jax_params(c), x, EPS)
                     .astype(jnp.float32))
    norm, mlp = _torch_mlp(c)
    xb = _t(c["x"]).to(torch.bfloat16)
    out = tfm.fused_ln_mlp_residual_plain(norm, mlp, xb, EPS)
    _assert_within_residual_ulps(out.detach().float(), ref, xb.float())


def test_erf_as_matches_jax():
    z = np.linspace(-6, 6, 2001).astype(np.float32)
    np.testing.assert_allclose(tfm.erf_as(_t(z)).numpy(),
                               np.asarray(jfm._erf_as(jnp.asarray(z))),
                               atol=1e-7, rtol=0)


# ---------------------------------------------------------------------------
# preprocessing and the label wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_in,scale", [(28, 30.1 / 28), (28, 15.1 / 28),
                                        (28, 120.1 / 28)])
def test_bicubic_matrix_equals_jax(n_in, scale):
    np.testing.assert_array_equal(tbic.bicubic_resize_matrix(n_in, scale),
                                  jbic.bicubic_resize_matrix(n_in, scale))


@pytest.mark.parametrize("shape,res", [((240, 320), 240), ((480, 640), 480),
                                       ((480, 640), 240)])
def test_resize_bilinear_equals_jax(shape, res):
    """Downscaling camera frames (the predict path at 240/480px) is
    bit-identical: both sides compute fl(fl(w0*x0) + fl(w1*x1)) per pass."""
    img = np.random.RandomState(res).randint(0, 256, shape + (3,)).astype(
        np.uint8)
    ref = np.asarray(jres.resize_bilinear(jnp.asarray(img), res, res))
    out = tres.resize_bilinear(_t(img), res, res)
    np.testing.assert_array_equal(out.numpy(), ref)
    i0, i1, w0, w1 = tres.bilinear_taps(shape[1], res)
    dense = np.zeros((res, shape[1]), np.float32)
    np.add.at(dense, (np.arange(res), i0), w0)
    np.add.at(dense, (np.arange(res), i1), w1)
    np.testing.assert_array_equal(dense,
                                  jres.bilinear_resize_matrix(shape[1], res))


@pytest.mark.parametrize("shape,res", [((480, 640), 960), ((100, 90), 120)])
def test_resize_bilinear_upscale_differs_only_at_ties(shape, res):
    """Upscaling, XLA's CPU dot fuses the second pass into an FMA, so the
    two sides may round a value that is k + 0.5 in exact arithmetic to
    different integers.  Every difference is one level, at such a tie."""
    img = np.random.RandomState(res).randint(0, 256, shape + (3,)).astype(
        np.uint8)
    ref = np.asarray(jres.resize_bilinear(jnp.asarray(img), res, res))
    out = tres.resize_bilinear(_t(img), res, res).numpy()
    diff = out != ref
    assert diff.mean() < 0.01
    assert (np.abs(out - ref)[diff] == 1).all()
    wr = jres.bilinear_resize_matrix(shape[0], res).astype(np.float64)
    wc = jres.bilinear_resize_matrix(shape[1], res).astype(np.float64)
    exact = np.einsum("oh,hwc->owc", wr, img.astype(np.float64))
    exact = np.einsum("pw,owc->opc", wc, exact)
    frac = exact[diff] - np.floor(exact[diff])
    assert (np.abs(frac - 0.5) < 1e-4).all()


def _tap_pass(x, dim, n_out, fma):
    """One resize pass in float64 with float32 roundings: fl(fl(w0*x0) +
    fl(w1*x1)), or with ``fma`` fl(fl(w0*x0) + w1*x1) (one rounding of the
    second product and the add, as an FMA accumulating over k)."""
    i0, i1, w0, w1 = tres.bilinear_taps(x.shape[dim], n_out)
    shape = [1] * x.ndim
    shape[dim] = n_out
    p0 = (w0.reshape(shape).astype(np.float64)
          * np.take(x, i0, axis=dim)).astype(np.float32)
    p1 = w1.reshape(shape).astype(np.float64) * np.take(x, i1, axis=dim)
    if not fma:
        p1 = p1.astype(np.float32)
    return (p0.astype(np.float64) + p1).astype(np.float32)


def test_resize_960_follows_xla_dot_blocking():
    """Why the 960px upscale cannot be bit-identical by an elementwise
    formula (ROADMAP "Faults found"): XLA:CPU runs each pass as a dense
    dot; the width pass (K=640) accumulates the two taps with an FMA,
    fl(fl(w0*x0) + w1*x1), except in output columns whose taps straddle a
    K-block edge of the CPU GEMM, where two block sums add as
    fl(fl(w0*x0) + fl(w1*x1)), the port's form.  Every pixel of
    dino_tpu's result is one of the two forms (unrounded, before
    floor(x + 0.5))."""
    img = np.random.RandomState(960).randint(0, 256, (480, 640, 3)).astype(
        np.uint8)
    ref = np.asarray(jres.resize_bilinear(jnp.asarray(img), 960, 960,
                                          round_uint8=False))
    rows = _tap_pass(img.astype(np.float32), 0, 960, fma=False)
    plain = _tap_pass(rows, 1, 960, fma=False)
    fused = _tap_pass(rows, 1, 960, fma=True)
    np.testing.assert_array_equal(
        plain, tres.resize_bilinear(_t(img), 960, 960, round_uint8=False))
    assert ((ref == plain) | (ref == fused)).all()


def test_preprocess_matches_jax():
    img = np.random.RandomState(7).randint(0, 256, (2, 240, 320, 3)).astype(
        np.uint8)
    ref = np.asarray(jpre.preprocess(jnp.asarray(img), 240))
    out = tpre.preprocess(_t(img), 240)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("res", [240, 480, 960])
def test_kron_upsample_equals_jax(res):
    out_size = res // 8
    low = np.random.RandomState(res).randint(0, 7, (out_size, out_size)).astype(
        np.uint8)
    ref = np.asarray(jups.kron_upsample(jnp.asarray(low), 480 // out_size))
    out = tups.kron_upsample(_t(low), 480 // out_size)
    assert out.shape == (480, 480)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_true_fp32_restores_tf32_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with true_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
