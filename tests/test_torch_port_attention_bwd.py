"""dino_tpu_torch's flash-attention backward (plain version and the autograd
Function) vs dino_tpu's Pallas backward kernel (interpret mode) and the XLA
vjp of attention_xla, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_tpu.ops import attention as jatt
from dino_tpu_torch.ops import attention as tatt

SCALE = 64 ** -0.5
# float32: tests/test_attention.py:66's tolerance for the Pallas backward
F32_TOL = dict(atol=5e-5, rtol=1e-4)
# bf16: both sides round P and dS to bf16 before their products, from
# float32 scores summed in another order, so a value at a rounding edge may
# round one bf16 step apart (2^-8 relative); such steps add up over the N
# terms of each sum.  Held per tensor against its largest magnitude.
BF16_REL = 2e-2


def _inputs(n, dtype, seed):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(1, 2, n, 64).astype(np.float32) for _ in range(4)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(dtype) for a in arrs])


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, dtype):
    for g, w in zip(got, want):
        g = g.detach().float().numpy()
        w = _np(w)
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, **F32_TOL)
        else:
            assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()


def _pallas_bwd(jq, jk, jv, jg):
    """dino_tpu's backward kernel in interpret mode, from its own forward;
    returns (dq, dk, dv) f32 and the forward's (out, lse (B*nh, N))."""
    out, lse = jatt._flash_fwd_impl(jq, jk, jv, SCALE, True, return_lse=True)
    dsum = jnp.sum(jg.astype(jnp.float32) * out.astype(jnp.float32), axis=-1)
    grads = jatt._flash_bwd_pallas(jq, jk, jv, lse, jg, dsum, SCALE, True)
    n = jq.shape[2]
    return grads, out, lse[:, :n, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [37, 226, 901])
def test_bwd_plain_matches_pallas_kernel(n, dtype):
    """Same q, k, v, dO, out and lse into both backwards."""
    (jq, jk, jv, jg), (q, k, v, g) = _inputs(n, dtype, n)
    want, out, lse = _pallas_bwd(jq, jk, jv, jg)
    got = tatt.attention_bwd_plain(
        q, k, v, torch.from_numpy(np.array(_np(out))).to(dtype),
        torch.from_numpy(np.array(lse)), g, SCALE)
    assert all(t.dtype == torch.float32 and t.shape == q.shape for t in got)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [37, 226, 901])
def test_flash_attention_autograd_matches_pallas_and_xla_vjp(n, dtype):
    """loss.backward() through the port's flash_attention (its own forward,
    the FlashAttention rule) against the Pallas backward and, in float32,
    against the XLA vjp of the materialized attention."""
    (jq, jk, jv, jg), (q, k, v, g) = _inputs(n, dtype, n + 1)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = tatt.flash_attention_bwd.launches
    out = tatt.flash_attention(q, k, v, SCALE)
    assert type(out.grad_fn).__name__.startswith("FlashAttention")
    out.backward(g)
    assert tatt.flash_attention_bwd.launches == before  # no kernel on the CPU
    got = (q.grad, k.grad, v.grad)
    assert all(t.dtype == dtype for t in got)
    want, _, _ = _pallas_bwd(jq, jk, jv, jg)
    _assert_close(got, want, dtype)
    if dtype == torch.float32:
        _, vjp = jax.vjp(lambda a, b, c: jatt.attention_xla(a, b, c,
                                                            SCALE)[0],
                         jq, jk, jv)
        _assert_close(got, vjp(jg), dtype)


def test_flash_attention_without_grad_is_the_plain_forward():
    _, (q, k, v, _) = _inputs(50, torch.float32, 3)
    with torch.no_grad():
        out = tatt.flash_attention(q.requires_grad_(), k, v, SCALE)
    assert out.grad_fn is None
    assert torch.equal(out, tatt.attention_plain(q.detach(), k, v, SCALE)[0])
    # with a gradient the forward is the same, and return_lse still works
    out2, lse = tatt.flash_attention(q, k, v, SCALE, return_lse=True)
    assert torch.equal(out2.detach(), out) and not lse.requires_grad


def test_flash_attention_bwd_wrapper_on_cpu_is_the_plain_version():
    _, (q, k, v, g) = _inputs(70, torch.float32, 4)
    out, lse = tatt.attention_plain(q, k, v, SCALE)
    before = tatt.flash_attention_bwd.launches
    got = tatt.flash_attention_bwd(q, k, v, out, lse, g, SCALE)
    want = tatt.attention_bwd_plain(q, k, v, out, lse, g, SCALE)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tatt.flash_attention_bwd.launches == before


def test_bwd_plain_chunking_changes_only_the_summation_order(monkeypatch):
    """Chunking over query rows leaves dq's rows as they were; dk and dv sum
    the chunks' float32 partial products in another order."""
    _, (q, k, v, g) = _inputs(300, torch.float32, 5)
    out, lse = tatt.attention_plain(q, k, v, SCALE)
    full = tatt.attention_bwd_plain(q, k, v, out, lse, g, SCALE)
    monkeypatch.setattr(tatt, "_PLAIN_SCORE_ELEMS", 2 * 300 * 7)
    chunked = tatt.attention_bwd_plain(q, k, v, out, lse, g, SCALE)
    assert torch.equal(full[0], chunked[0])
    for a, b in zip(full[1:], chunked[1:]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_backward_raises_off_cpu_instead_of_taking_plain():
    q, k, v, g = (torch.zeros(1, 2, 8, 64, device="meta") for _ in range(4))
    lse = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        tatt.flash_attention_bwd(q, k, v, q, lse, g, SCALE)
    with pytest.raises(ValueError, match="device"):
        tatt.flash_attention(q.requires_grad_(), k, v, SCALE)
