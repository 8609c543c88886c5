"""The bf16 flash forward and the fused LN+MLP kernels' order of operations,
emulated in torch on the CPU and held to the tolerances chip_smoke.py
states for the kernels: against the port's plain versions and against
dino_tpu's Pallas kernels in interpret mode.

flash_fwd_bf16 (dino_tpu_torch/csrc/flash_attn_fwd.cu) walks the keys in
tiles of FB_BK, keeps the running max m of the scaled scores, and takes
p = 2^(S*(scale*log2 e) - m*log2 e) with one FMA and ex2 (the plain version
and the Pallas kernel take exp(S*scale - m) against the row's final max); P
is rounded to bf16 against the tile's running max, and O is rescaled tile by
tile.  Both tile widths the kernel was built at (64 and 128 keys) are
emulated.  fused_ln_mlp_kernel (csrc/fused_ln_mlp.cu) sums fc2 in f32 chunk
by chunk over the hidden dimension (64 hidden units at a time), each half
of the hidden dimension in its own block, the two partial sums added last,
where the plain version takes one product; its A&S erf takes exp(-z^2) as
2^(-z^2 log2 e) (ex2) and 1 / (1 + p|z|) by the MUFU's approximate
reciprocal, within 1 ulp of the rounded one: the emulation takes the
rounded reciprocal and its two neighbours.  Products of bf16 values are
exact in f32,
so f32 matmuls of the rounded operands emulate the tensor cores up to the
order of their sums; the card tests (tests/test_torch_port_cuda.py) and
chip_smoke.py hold the kernels themselves.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dino_tpu.ops import attention as jatt
from dino_tpu.ops import fused_mlp as jfm
from dino_tpu_torch.ops import attention as tatt
from dino_tpu_torch.ops import fused_mlp as tfm
from tests.test_torch_port_ops import _mlp_case, _pallas_fused, _torch_mlp

ATOL, RTOL = chip_smoke.FLASH_TOL[torch.bfloat16]
LSE_ATOL = chip_smoke.LSE_ATOL
SCALE = 64 ** -0.5
LOG2E = 1.4426950408889634
EPS = 1e-6


def fma_f32(a, b, c):
    """fl(a*b + c) of float32 tensors with one rounding (the product and
    the sum exact in float64 for these magnitudes)."""
    return (a.double() * b.double() + c.double()).float()


def flash_emul(q, k, v, valid, bk):
    """(out bf16, lse f32) of bf16 q (BH, Nq, 64), k/v (BH, Nk, 64) over
    the first ``valid`` keys, in flash_fwd_bf16's order of operations."""
    bh, nq, hd = q.shape
    qf = q.float()
    m = torch.full((bh, nq), -1e30)
    l = torch.zeros(bh, nq)
    o = torch.zeros(bh, nq, hd)
    sl = torch.tensor(SCALE, dtype=torch.float32) * LOG2E
    for k0 in range(0, valid, bk):
        kt, vt = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk].float()
        s = qf @ kt.transpose(-1, -2)  # raw scores, f32
        dead = torch.arange(k0, k0 + kt.shape[1]) >= valid
        s = s.masked_fill(dead, -1e30)
        m_new = torch.maximum(m, s.amax(-1) * SCALE)
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2(fma_f32(s, sl, -(m_new * LOG2E)[..., None]))
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.to(torch.bfloat16).float() @ vt
        m = m_new
    lc = l.clamp_min(1e-30)
    return (o / lc[..., None]).to(torch.bfloat16), m + torch.log(lc)


def _bf16_qkv(nq, nk, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(1, 2, n, 64).astype(np.float32) for n in (nq, nk, nk)]


def _check_fwd(out, lse, ref, ref_lse):
    out, ref = out.float(), ref.float()
    assert bool(((out - ref).abs() <= ATOL + RTOL * ref.abs()).all()), \
        float((out - ref).abs().max())
    assert float((lse - ref_lse).abs().max()) <= LSE_ATOL


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("n, valid", [(127, 127), (128, 128), (129, 129),
                                      (129, 65), (193, 64), (901, 901),
                                      (901, 1)])
def test_fwd_emulation_within_plain_tolerance(bk, n, valid):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _bf16_qkv(n, n, seed=n + valid))
    out, lse = flash_emul(q[0], k[0], v[0], valid, bk)
    ref, ref_lse = tatt.attention_dyn_plain(q, k, v, SCALE, valid)
    _check_fwd(out, lse, ref[0], ref_lse)


@pytest.mark.parametrize("bk", [64, 128])
def test_fwd_emulation_with_no_valid_key(bk):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _bf16_qkv(65, 65, seed=3))
    out, lse = flash_emul(q[0], k[0], v[0], 0, bk)
    assert float(out.float().abs().max()) == 0.0
    assert float(lse.max()) <= -1e29


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("nq, nk, valid", [(127, 127, 127), (193, 193, 193),
                                           (130, 200, 129)])
def test_fwd_emulation_matches_pallas_kernel(bk, nq, nk, valid):
    """Against dino_tpu's _flash_kernel_dyn (interpret mode) on bf16
    inputs."""
    arrs = _bf16_qkv(nq, nk, seed=nq + nk)
    out_j, lse_j = jatt.flash_attention_with_lse_dyn(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in arrs), SCALE,
        jnp.int32(valid), interpret=True)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    out, lse = flash_emul(q[0], k[0], v[0], valid, bk)
    ref = torch.from_numpy(np.array(out_j.astype(jnp.float32)))[0]
    _check_fwd(out, lse, ref, torch.from_numpy(np.array(lse_j))[:, :nq, 0])


def erf_kernel(z, rcp_ulps=0):
    """The kernel's A&S erf in float32: 1 / (1 + p|z|) rounded, then moved
    by ``rcp_ulps`` ulps (the MUFU's reciprocal is within 1 ulp), exp(-z^2)
    as 2^(-z^2 * log2 e)."""
    az = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * az)
    for _ in range(abs(rcp_ulps)):
        t = torch.nextafter(t, torch.full_like(t, rcp_ulps * float("inf")))
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.copysign(1.0 - poly * torch.exp2(-(az * az) * LOG2E), z)


def mlp_emul(norm, mlp, x, eps, chunk=64, split=2, rcp_ulps=0):
    """x (M, 384) bf16 -> x + fc2(gelu_as(fc1(LN(x)))) in
    fused_ln_mlp_kernel's order: fc2 summed in f32 over hidden chunks,
    each of ``split`` parts of the hidden dimension on its own, the parts'
    sums added in order."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mu).mean(-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    y = (((xf - mu) * rstd) * norm.weight.float()
         + norm.bias.float()).to(torch.bfloat16).float()
    w1 = mlp.fc1.weight.to(torch.bfloat16).float()
    w2 = mlp.fc2.weight.to(torch.bfloat16).float()
    nc = w1.shape[0] // chunk
    total = None
    for r in range(split):
        acc = torch.zeros(x.shape[0], w2.shape[0])
        for c in range(r * nc // split, (r + 1) * nc // split):
            sl = slice(c * chunk, (c + 1) * chunk)
            h = y @ w1[sl].t() + mlp.fc1.bias.float()[sl]
            h = h * 0.5 * (1.0 + erf_kernel(h * 0.7071067811865476,
                                            rcp_ulps))
            acc = acc + h.to(torch.bfloat16).float() @ w2[:, sl].t()
        total = acc if total is None else total + acc
    return x + (total + mlp.fc2.bias.float()).to(torch.bfloat16)


@pytest.mark.parametrize("rcp_ulps", [-1, 0, 1])
def test_kernel_erf_matches_jax_erf_as(rcp_ulps):
    z = np.linspace(-6, 6, 2001).astype(np.float32)
    np.testing.assert_allclose(
        erf_kernel(torch.from_numpy(z), rcp_ulps).numpy(),
        np.asarray(jfm._erf_as(jnp.asarray(z))), atol=1e-6, rtol=0)


def _pallas_padded(c, rows=32):
    """The Pallas kernel (interpret) on x padded with zero rows to a
    multiple of the row tile; the padding rows are dropped."""
    m = c["x"].shape[0]
    mp = -(-m // rows) * rows
    cp = dict(c, x=np.concatenate([c["x"], np.zeros((mp - m, c["x"].shape[1]),
                                                    np.float32)]))
    out = _pallas_fused(cp, jnp.bfloat16, rows)
    return torch.from_numpy(np.array(out.astype(jnp.float32))[:m])


@pytest.mark.parametrize("rcp_ulps", [-1, 0, 1])
@pytest.mark.parametrize("hidden", [64, 1536])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 129])
def test_mlp_emulation_within_tolerance(m, hidden, rcp_ulps):
    """The chunked emulation against the plain version and the Pallas
    kernel, under chip_smoke.mlp_err's tolerance, with the GELU's
    reciprocal rounded and one ulp to either side."""
    c = _mlp_case(m=m, h=hidden, seed=m + hidden)
    norm, mlp = _torch_mlp(c)
    x = torch.from_numpy(c["x"]).to(torch.bfloat16)
    with torch.no_grad():
        out = mlp_emul(norm, mlp, x, EPS, rcp_ulps=rcp_ulps)
        plain = tfm.fused_ln_mlp_residual_plain(norm, mlp, x, EPS)
    assert chip_smoke.mlp_err(out, plain, x)[2]
    assert chip_smoke.mlp_err(out, _pallas_padded(c), x)[2]
