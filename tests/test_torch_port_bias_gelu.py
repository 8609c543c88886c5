"""fc1's bias, GELU and rounding as one pass each way
(``dino_tpu_torch.ops.bias_gelu``), on the CPU.

The plain versions the wrappers take for a CPU tensor are the composition's
own operations, so :func:`fc1_bias_gelu` under autograd must equal, bit for
bit, what ``mlp_residual`` ran before it: ``affine`` (the float32 product
and bias, ``_LinearOnce`` under autograd) -> ``F.gelu`` in float32 ->
``.to(bf16)``, in h and in dx, dW1 and db1.  ``mlp_residual``'s gate takes
the kernels for a bf16 tensor on the card only, whether or not a gradient
is needed; here the card is stood in for by a gate that reads a CPU tensor
as a CUDA one.  The kernels themselves are held to the composition on the
card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from dino_tpu_torch.models import heads
from dino_tpu_torch.models import vit as tvit
from dino_tpu_torch.ops import bias_gelu as tbg

BF16 = torch.bfloat16


def _fc1(d_in, hidden, seed):
    """An f32 nn.Linear at the model's init scale with a bias of scale
    0.5."""
    g = torch.Generator().manual_seed(seed)
    lin = nn.Linear(d_in, hidden)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(hidden, d_in, generator=g) * d_in ** -0.5)
        lin.bias.uniform_(-0.5, 0.5, generator=g)
    return lin


def _x(shape, seed):
    g = torch.Generator().manual_seed(seed + 1)
    return (torch.randn(shape, generator=g) * 2.0).to(BF16)


def _run(fn, lin, x, dh):
    """fn(lin, x) and the gradients of x, fc1's weight and bias for the
    cotangent dh."""
    lin.zero_grad(set_to_none=True)
    xg = x.clone().requires_grad_()
    h = fn(lin, xg)
    h.backward(dh)
    return h, xg.grad, lin.weight.grad, lin.bias.grad


def _composition(lin, x):
    return F.gelu(heads.affine(lin, x), approximate="none").to(x.dtype)


def _function(lin, x):
    return tbg.fc1_bias_gelu(x, lin.weight.to(x.dtype), lin.bias)


@pytest.mark.parametrize("shape,hidden", [((37, 24), 64), ((2, 9, 24), 72),
                                          ((50, 384), 1536), ((1, 384), 8)])
def test_function_is_the_composition_bit_for_bit(shape, hidden):
    """h, dx, dW1 and db1 of the Function's plain versions equal autograd
    through affine -> F.gelu -> .to(bf16)."""
    lin = _fc1(shape[-1], hidden, seed=hidden)
    x = _x(shape, seed=hidden)
    dh = _x(shape[:-1] + (hidden,), seed=hidden + 7)
    want = _run(_composition, lin, x, dh)
    got = _run(_function, lin, x, dh)
    for name, a, b in zip(("h", "dx", "dW1", "db1"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


def test_forward_without_a_gradient_has_the_same_bits():
    """The forward alone (no gradient needed) and the Function's forward
    under autograd give one activation, as a pipeline's gradient-free
    forward slot and its recompute need."""
    lin = _fc1(24, 64, seed=3)
    x = _x((5, 11, 24), seed=3)
    with torch.no_grad():
        free = _function(lin, x)
    taped = _function(lin, x.clone().requires_grad_())
    assert taped.requires_grad and not free.requires_grad
    assert torch.equal(free, taped.detach())


class _OnCard:
    """A stand-in that reads as a tensor on the card."""

    def __init__(self, dtype):
        self.is_cuda, self.dtype = True, dtype


@pytest.mark.parametrize("x,hidden,want", [
    (_OnCard(BF16), 1536, True), (_OnCard(BF16), 64, True),
    (_OnCard(BF16), 1540, False), (_OnCard(torch.float32), 1536, False),
    (_OnCard(torch.float16), 1536, False),
    (torch.zeros(2, 4, dtype=BF16), 1536, False),
    (torch.zeros(2, 4), 1536, False)])
def test_applies_only_to_bf16_on_the_card(x, hidden, want):
    assert tbg.applies(x, hidden) is want


def _card_gate(monkeypatch):
    """The gate as on the card, for CPU tensors; returns the list the
    spied fc1_bias_gelu appends each call's input dtype to."""
    real_applies, real_fn = tbg.applies, tbg.fc1_bias_gelu
    calls = []

    def applies(x, hidden):
        return real_applies(_OnCard(x.dtype), hidden)

    def fn(x, w1, b1):
        calls.append(x.dtype)
        return real_fn(x, w1, b1)
    monkeypatch.setattr(tbg, "applies", applies)
    monkeypatch.setattr(tbg, "fc1_bias_gelu", fn)
    return calls


def _block(dim=24, seed=5):
    blk = tvit.Block(tvit.ViTConfig(embed_dim=dim, num_heads=2))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return blk


def _mlp_residual(blk, x, grad, drop_rate):
    gen = torch.Generator().manual_seed(11) if drop_rate else None
    x = x.clone().requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        out = tvit.mlp_residual(blk.norm2, blk.mlp, x, 1e-6, drop_rate,
                                generator=gen)
    if not grad:
        return (out,)
    blk.zero_grad(set_to_none=True)
    out.backward(torch.ones_like(out))
    return (out, x.grad, blk.mlp.fc1.weight.grad, blk.mlp.fc1.bias.grad,
            blk.norm2.weight.grad)


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("drop_rate", [0.0, 0.25])
def test_mlp_residual_takes_the_function_on_the_card(monkeypatch, grad,
                                                     drop_rate):
    """With the card's gate, a bf16 mlp_residual goes through
    fc1_bias_gelu with or without a gradient, dropout after it included,
    and keeps the composition's bits; float32 keeps its form."""
    blk = _block()
    x = _x((2, 7, 24), seed=9)
    want = _mlp_residual(blk, x, grad, drop_rate)
    calls = _card_gate(monkeypatch)
    got = _mlp_residual(blk, x, grad, drop_rate)
    assert calls == [BF16]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _mlp_residual(blk, x.float(), grad, drop_rate)
    assert calls == [BF16]


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_mlp_residual_on_the_cpu_keeps_the_composition(monkeypatch, dtype):
    """Without the card the gate never engages: the CPU runs the
    composition as before."""
    calls = []
    real = tbg.fc1_bias_gelu
    monkeypatch.setattr(tbg, "fc1_bias_gelu",
                        lambda *a: calls.append(1) or real(*a))
    blk = _block()
    _mlp_residual(blk, _x((2, 7, 24), seed=1).to(dtype), True, 0.0)
    assert calls == []


def test_wrappers_raise_off_the_cpu_and_the_card():
    y = torch.zeros(4, 8, device="meta")
    b = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbg.bias_gelu_fwd(y, b)
    with pytest.raises(ValueError, match="unsupported device"):
        tbg.bias_gelu_bwd(y.to(BF16), y, b)

