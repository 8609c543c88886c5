"""bf16 dense layers round once, as ``dino_tpu``'s do.

``dino_tpu``'s ``dense`` (models/vit.py), the head's ``_affine``
(models/heads.py) and the head-major qkv einsum (ops/attention.py) take the
product with a float32 result, add the float32 bias, and round once.  The
port's layers (``dino_tpu_torch.models.heads``: ``dense``, ``affine``,
``mlp_head_apply``) are held to them at the model's widths, on the same
bf16 inputs and weights, made with numpy from a seed:

  * at most 0.1% of the outputs differ, each by at most one bf16 ulp (the
    two sides sum the products in other orders), the ulp taken at the
    larger of the two outputs and 2^-14 of the sum's terms, |x|.|W| + |b|:
    where a sum cancels further, float32's own sum-order error (a few
    float32 ulps of the terms) sets the floor; ``affine``'s float32 output
    is compared as its consumers use it, rounded to bf16;
  * the MLP head's argmax is equal except where the reference's top-2
    log-prob margin is below 1e-3.

The forms the port had before (the product rounded to bf16, then the bias
added, in float32 for the head and fc1/fc2, in bf16 for qkv, proj and the
patch embed) fail the first rule; the tests show that too.  float32 keeps
its forms bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from dino_tpu.models import heads as jheads
from dino_tpu.models import vit as jvit
from dino_tpu_torch.models import heads
from dino_tpu_torch.models import vit as tvit
from dino_tpu_torch.ops import attention as tatt

ROWS = 2000
MAX_DIFFERING = 1e-3      # share of outputs that may differ
HEAD_MARGIN = 1e-3        # reference top-2 margin below which argmax may flip

# (name, in, out, kind): the model's dense layers; "dense" layers round to
# the input dtype, "affine" layers return the float32 sum
LAYERS = [("qkv", 384, 1152, "dense"), ("proj", 384, 384, "dense"),
          ("patch_embed", 192, 384, "dense"), ("fc1", 384, 1536, "affine"),
          ("fc2", 1536, 384, "affine"), ("head_1", 384, 200, "affine"),
          ("head_2", 200, 100, "affine"), ("head_3", 100, 7, "affine")]


def _weights(n_in, n_out, seed):
    """f32 weight (out, in) at the model's init scale and a bias of scale
    0.5 (trained biases are not small)."""
    rs = np.random.RandomState(seed)
    w = (rs.randn(n_out, n_in) * n_in ** -0.5).astype(np.float32)
    b = rs.uniform(-0.5, 0.5, n_out).astype(np.float32)
    return w, b


def _x(n_in, seed):
    rs = np.random.RandomState(seed + 1)
    return torch.from_numpy(rs.randn(ROWS, n_in).astype(np.float32)).to(
        torch.bfloat16)


def _to_jax(x: torch.Tensor):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def _reference(kind, x, w, b):
    p = {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}
    y = (jvit.dense(p, _to_jax(x)) if kind == "dense"
         else jheads._affine(p, _to_jax(x)).astype(jnp.bfloat16))
    return torch.from_numpy(np.array(y.astype(jnp.float32)))


def _port(kind, x, w, b):
    lin = nn.Linear(w.shape[1], w.shape[0])
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
        y = (heads.dense(x, lin.weight, lin.bias) if kind == "dense"
             else heads.affine(lin, x, torch.bfloat16))
    return y.float()


def _old_form(kind, x, w, b):
    """The port's forms before the repair."""
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    if kind == "dense":
        y = F.linear(x, wt.to(x.dtype), bt.to(x.dtype))
    else:
        y = (F.linear(x, wt.to(x.dtype)).float() + bt).to(torch.bfloat16)
    return y.float()


def _bf16_ulp(mag):
    mag = mag.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _terms(x, w, b):
    """|x|.|W|^T + |b|: the magnitude of each output's terms."""
    return (x.double().abs() @ torch.from_numpy(w).double().abs().T
            + torch.from_numpy(b).double().abs()).float()


def _differing(got, ref, terms):
    """(share of outputs that differ, all within one bf16 ulp)."""
    diff = (got - ref).abs()
    mag = torch.maximum(torch.maximum(got.abs(), ref.abs()),
                        terms * 2.0 ** -14)
    return float((diff > 0).float().mean()), bool((diff <= _bf16_ulp(mag)
                                                  ).all())


@pytest.mark.parametrize("name,n_in,n_out,kind", LAYERS)
def test_bf16_layer_rounds_once_like_dino_tpu(name, n_in, n_out, kind):
    w, b = _weights(n_in, n_out, seed=n_in + n_out)
    x = _x(n_in, seed=n_in + n_out)
    share, one_ulp = _differing(_port(kind, x, w, b),
                                _reference(kind, x, w, b), _terms(x, w, b))
    assert share <= MAX_DIFFERING and one_ulp, (name, share, one_ulp)


@pytest.mark.parametrize("name,n_in,n_out,kind", LAYERS)
def test_old_bf16_form_fails_the_same_rule(name, n_in, n_out, kind):
    w, b = _weights(n_in, n_out, seed=n_in + n_out)
    x = _x(n_in, seed=n_in + n_out)
    share, one_ulp = _differing(_old_form(kind, x, w, b),
                                _reference(kind, x, w, b), _terms(x, w, b))
    assert share > MAX_DIFFERING or not one_ulp, (name, share)


def _head(seed=0):
    """An MLP head (384 -> 200 -> 100 -> 7) in both packages, the same
    weights, torch.nn.Linear's init."""
    g = torch.Generator().manual_seed(seed)
    head = heads.init_head("mlp", 7, 384, generator=g)
    jp = {name: {"kernel": jnp.asarray(lin.weight.detach().numpy().T),
                 "bias": jnp.asarray(lin.bias.detach().numpy())}
          for name, lin in head.named_children()}
    return head, jp


def test_bf16_mlp_head_argmax_matches_dino_tpu():
    head, jp = _head()
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(20000, 384).astype(np.float32)).to(
        torch.bfloat16)
    with torch.no_grad():
        got = heads.mlp_head_apply(head, x)
    ref = torch.from_numpy(np.array(jheads.mlp_head_apply(jp, _to_jax(x))))
    top2 = torch.topk(ref, 2, dim=-1).values
    near = top2[:, 0] - top2[:, 1] < HEAD_MARGIN
    flips = got.argmax(-1) != ref.argmax(-1)
    assert not bool((flips & ~near).any()), int(flips.sum())
    assert float((got - ref).abs().max()) < 1e-3


@pytest.mark.parametrize("name,n_in,n_out,kind", LAYERS)
def test_fp32_layer_keeps_its_form_bit_for_bit(name, n_in, n_out, kind):
    w, b = _weights(n_in, n_out, seed=n_in + n_out)
    x = _x(n_in, seed=n_in + n_out).float()
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    lin = nn.Linear(n_in, n_out)
    with torch.no_grad():
        lin.weight.copy_(wt)
        lin.bias.copy_(bt)
        if kind == "dense":
            got, want = heads.dense(x, lin.weight, lin.bias), F.linear(x, wt,
                                                                       bt)
        else:
            got, want = heads.affine(lin, x), F.linear(x, wt) + bt
    assert torch.equal(got, want)


def test_fp32_forward_keeps_its_forms_bit_for_bit(monkeypatch):
    """A 2-block ViT's fp32 forward and MLP head equal the same forward run
    with the forms the port had before the repair."""
    cfg = tvit.vit_small(patch_size=8)
    model = tvit.init_vit_params(tvit.VisionTransformer(cfg, depth=2),
                                 torch.Generator().manual_seed(1))
    head, _ = _head(2)
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(1, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        tokens = tvit.vit_forward(model, x, cfg)
        got = heads.mlp_head_apply(head, tokens[0, 1:])

        def old_dense(x, weight, bias):
            return F.linear(x, weight.to(x.dtype), bias.to(x.dtype))

        def old_affine(lin, x, dtype=torch.float32):
            return (F.linear(x, lin.weight.to(x.dtype)).float()
                    + lin.bias.float()).to(dtype)

        for mod, name, fn in ((tatt, "dense", old_dense),
                              (tvit, "dense", old_dense),
                              (tvit, "affine", old_affine),
                              (heads, "affine", old_affine)):
            monkeypatch.setattr(mod, name, fn)
        want_tokens = tvit.vit_forward(model, x, cfg)
        want = heads.mlp_head_apply(head, want_tokens[0, 1:])
    assert torch.equal(tokens, want_tokens) and torch.equal(got, want)
