"""The f32 flash backward's 3-pass TF32 products, emulated in torch on the
CPU in the kernel's order of operations, against a float64 backward, held to
the f32 backward's tolerance (chip_smoke.BWD_F32_TOL).

The CUDA kernel (dino_tpu_torch/csrc/flash_attn_bwd.cu, flash_bwd_f32)
splits every f32 operand x into hi = tf32(x) and lo = tf32(x - hi) (round to
nearest, ties away from zero) and forms each product as lo_a.hi_b +
hi_a.lo_b + hi_a.hi_b, small terms first.  Products of two tf32 values are
exact in f32, so f32 matmuls of the halves emulate the passes; the sums run
in another order than the tensor cores'.  Emulated here as the kernel runs
them:

  * the score products S = Q.K^T and dP = dO.V^T over hd (one tile's
    accumulator each);
  * P = exp(S*scale - lse) and dS = P*(dP - D)*scale in float32 from the
    forward's lse and D = rowsum(dO*O), as the kernel forms them;
  * the gradient products per tile of F_T = 32 streamed rows (queries for
    dK and dV, keys for dQ), each tile's three passes in a fresh
    accumulator, folded into the running sum in float32: the tensor cores'
    float32 accumulation truncates, so the kernel never lets it run across
    tiles.

One TF32 pass (hi_a.hi_b alone) is shown to miss the same tolerance on
random inputs.  On the q, k, v of a 240px fp32 forward of the random-init
model the gradients are small enough (max |dv| ~0.13) that the tolerance's
atol lets one pass through at 93% of it; there the test shows the split's
margin instead: one pass spends at least 100 times the tolerance that three
do (0.93 against 9.2e-4).  The card tests and chip_smoke.py hold the kernel
itself.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from dino_tpu_torch.ops import attention as tatt
from tests.test_torch_port_tf32x3 import model_qkv, split, to_tf32  # noqa: F401

ATOL, RTOL = chip_smoke.BWD_F32_TOL
SCALE = 64 ** -0.5
F_T = 32  # streamed rows per tile (csrc flash_attn_bwd.cu F_T)


def matmul_3pass(a, b):
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    acc = a_lo @ b_hi
    acc = acc + a_hi @ b_lo
    return acc + a_hi @ b_hi


def matmul_1pass(a, b):
    return to_tf32(a) @ to_tf32(b)


def tiled(a, b, matmul):
    """a @ b contracting over tiles of F_T: each tile's product in its own
    accumulator, the tiles folded in order in float32."""
    acc = None
    for i in range(0, a.shape[-1], F_T):
        t = matmul(a[..., i:i + F_T], b[..., i:i + F_T, :])
        acc = t if acc is None else acc + t
    return acc


def backward(q, k, v, do, lse, dsum, matmul):
    """(dq, dk, dv) in the kernel's order, with ``matmul`` for every
    product."""
    s = matmul(q, k.transpose(-1, -2))
    p = torch.exp(s * SCALE - lse[..., None])
    dp = matmul(do, v.transpose(-1, -2))
    ds = p * (dp - dsum[..., None]) * SCALE
    dv = tiled(p.transpose(-1, -2), do, matmul)
    dk = tiled(ds.transpose(-1, -2), q, matmul)
    dq = tiled(ds, k, matmul)
    return dq, dk, dv


def ratio(q, k, v, do, matmul):
    """Max |err| / (ATOL + RTOL |ref|) over dq, dk, dv of ``matmul``'s
    backward against the float64 one.  lse and D are the port's f32
    forward's, as the kernel receives them."""
    out, lse = tatt.attention_plain(q, k, v, SCALE)
    b, nh, n, _ = q.shape
    lse = lse.reshape(b, nh, n)
    dsum = (do * out).sum(-1)
    got = backward(q, k, v, do, lse, dsum, matmul)
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    s = qd @ kd.transpose(-1, -2) * SCALE
    pd = torch.softmax(s, -1)
    dsd = pd * (dod @ vd.transpose(-1, -2)
                - (dod * (pd @ vd)).sum(-1, keepdim=True)) * SCALE
    ref = (dsd @ kd, dsd.transpose(-1, -2) @ qd, pd.transpose(-1, -2) @ dod)
    return max(float(((a.double() - r).abs() / (ATOL + RTOL * r.abs())).max())
               for a, r in zip(got, ref))


def randn_qkvd(n):
    rs = np.random.RandomState(n)
    return [torch.from_numpy(rs.randn(1, 2, n, 64).astype(np.float32))
            for _ in range(4)]


def model_do(q):
    rs = np.random.RandomState(7)
    return torch.from_numpy(rs.randn(*q.shape).astype(np.float32))


def test_tiled_folds_every_tile():
    a, b = torch.ones(1, 2, 70), torch.ones(1, 70, 3)
    assert torch.equal(tiled(a, b, torch.matmul), torch.full((1, 2, 3), 70.))


@pytest.mark.parametrize("n", [37, 901, 3601])
def test_3pass_backward_within_f32_tolerance(n):
    assert ratio(*randn_qkvd(n), matmul_3pass) <= 1.0


@pytest.mark.parametrize("n", [37, 901, 3601])
def test_single_tf32_pass_backward_misses_f32_tolerance(n):
    assert ratio(*randn_qkvd(n), matmul_1pass) > 1.0


def test_3pass_backward_on_model_qkv(model_qkv):  # noqa: F811
    q, k, v = model_qkv
    assert ratio(q, k, v, model_do(q), matmul_3pass) <= 1.0


def test_single_tf32_pass_backward_spends_the_margin_on_model_qkv(
        model_qkv):  # noqa: F811
    q, k, v = model_qkv
    one = ratio(q, k, v, model_do(q), matmul_1pass)
    assert one >= 100 * ratio(q, k, v, model_do(q), matmul_3pass), one
