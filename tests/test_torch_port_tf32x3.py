"""The f32 flash forward's 3-pass TF32 split, emulated in torch on the CPU:
its error budget against a float64 reference, held to the f32 forward's
tolerances (chip_smoke.FLASH_TOL[float32], LSE_ATOL).

The CUDA kernel (dino_tpu_torch/csrc/flash_attn_fwd.cu, flash_fwd_f32) splits
every f32 operand x into hi = tf32(x) and lo = tf32(x - hi), rounding to
nearest with ties away from zero (cvt.rna.tf32.f32), and forms each product
as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, small terms first, in f32.  Products
of two tf32 values are exact in f32, so f32 matmuls of the halves emulate
the passes; the sums run in another order than the tensor cores'.  One
TF32 pass (hi_a.hi_b alone) is shown to miss the same tolerances: the split
is what keeps the parity path at float32's accuracy.  What the emulation
does not model, the tensor cores' f32 accumulation (which truncates), the
kernel bounds by summing each 64-key tile's P.V in its own accumulator; the
card tests (tests/test_torch_port_cuda.py) hold the kernel itself.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.ops import attention as tatt

ATOL, RTOL = chip_smoke.FLASH_TOL[torch.float32]
LSE_ATOL = chip_smoke.LSE_ATOL
SCALE = 64 ** -0.5
ROWS = 1024  # query rows per chunk: bounds the (rows, N) score matrices


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero, by integer operations on the bits: add half of the dropped 13 bits'
    range to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def matmul_3pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    acc = a_lo @ b_hi
    acc = acc + a_hi @ b_lo
    return acc + a_hi @ b_hi


def matmul_1pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return to_tf32(a) @ to_tf32(b)


def attention(q, k, v, matmul):
    """(out, lse) of softmax attention with ``matmul`` for both products, in
    the kernel's order: scale after Q.K^T, P unrounded into P.V."""
    outs, lses = [], []
    for i in range(0, q.shape[-2], ROWS):
        s = matmul(q[..., i:i + ROWS, :], k.transpose(-1, -2)) * SCALE
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        outs.append(matmul(p, v) / l)
        lses.append((m + torch.log(l))[..., 0])
    return torch.cat(outs, -2), torch.cat(lses, -1)


def errors(q, k, v, matmul):
    """(max |out err| against ATOL + RTOL |ref|, as a ratio; max |lse err|)
    of ``matmul``'s attention against the float64 one."""
    out, lse = attention(q, k, v, matmul)
    ref, ref_lse = attention(q.double(), k.double(), v.double(),
                             torch.matmul)
    ratio = ((out.double() - ref).abs() / (ATOL + RTOL * ref.abs())).max()
    return float(ratio), float((lse.double() - ref_lse).abs().max())


def randn_qkv(n):
    rs = np.random.RandomState(n)
    return [torch.from_numpy(rs.randn(1, 2, n, 64).astype(np.float32))
            for _ in range(3)]


@pytest.fixture(scope="module")
def model_qkv():
    """q, k, v (1, 6, 901, 64) of the attention in a 240px fp32 forward of
    a random-init 1-block ViT-S/8, as the port computes them."""
    seen = []
    real = tatt.flash_attention

    def spy(q, k, v, scale, return_lse=False):
        seen.append((q.clone(), k.clone(), v.clone()))
        return real(q, k, v, scale, return_lse)

    model = DINOSeg(head="mlp", n_blocks=1, precision="fp32",
                    random_init=True, device="cpu", seed=0)
    model.set_resolution(240)
    frame = np.random.RandomState(0).randint(0, 256, (1, 240, 320, 3))
    tatt.flash_attention = spy
    try:
        model.log_probs(torch.from_numpy(frame.astype(np.uint8)),
                        precision="fp32")
    finally:
        tatt.flash_attention = real
    assert len(seen) == 1 and seen[0][0].shape == (1, 6, 901, 64)
    return seen[0]


def test_to_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's step in [1, 2)
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2 ** -23,
                      one + 1.5 * ulp, -(one + ulp / 2), 3.0, 0.0],
                     dtype=torch.float32)
    want = [one + ulp, one, one + 2 * ulp, -(one + ulp), 3.0, 0.0]
    assert to_tf32(x).tolist() == want
    hi, lo = split(x)
    assert torch.equal(to_tf32(hi), hi) and torch.equal(to_tf32(lo), lo)


@pytest.mark.parametrize("n", [37, 901, 4001])
def test_3pass_split_within_f32_tolerance(n):
    ratio, lse_err = errors(*randn_qkv(n), matmul_3pass)
    assert ratio <= 1.0 and lse_err <= LSE_ATOL, (ratio, lse_err)


@pytest.mark.parametrize("n", [37, 901, 4001])
def test_single_tf32_pass_misses_f32_tolerance(n):
    ratio, lse_err = errors(*randn_qkv(n), matmul_1pass)
    assert ratio > 1.0 or lse_err > LSE_ATOL, (ratio, lse_err)


def test_3pass_split_on_model_qkv(model_qkv):
    ratio, lse_err = errors(*model_qkv, matmul_3pass)
    assert ratio <= 1.0 and lse_err <= LSE_ATOL, (ratio, lse_err)


def test_single_tf32_pass_misses_on_model_qkv(model_qkv):
    ratio, lse_err = errors(*model_qkv, matmul_1pass)
    assert ratio > 1.0 or lse_err > LSE_ATOL, (ratio, lse_err)
