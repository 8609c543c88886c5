"""dino_tpu_torch ViT and heads vs dino_tpu on carried weights, and vs the
torch goldens (a second oracle, independent of JAX).  CPU, float32."""
import jax
import numpy as np
import pytest
import torch

from dino_tpu.models import vit as jvit
from dino_tpu.models.heads import init_head as jinit_head
from dino_tpu.models.heads import mlp_head_apply as jmlp_head
from dino_tpu_torch.checkpointing.convert import (from_jax_params,
                                                  strip_prefix, to_jax_params)
from dino_tpu_torch.models import heads as theads
from dino_tpu_torch.models import vit as tvit
from tests.conftest import golden_state_dict

ATOL = 2e-4   # tests/test_vit_parity.py:17-18
RTOL = 1e-4

SMALL = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2)
GOLDEN = dict(patch_size=8, embed_dim=192, depth=2, num_heads=3,
              mlp_ratio=4.0, qkv_bias=True, ln_eps=1e-6)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def small_pair():
    """A random JAX ViT (D=64, 2 heads, depth 2) and the port's ViT holding
    the same weights through from_jax_params."""
    jcfg = jvit.ViTConfig(**SMALL)
    params = _numpy_tree(jvit.init_vit_params(jax.random.PRNGKey(0), jcfg))
    model = tvit.VisionTransformer(tvit.ViTConfig(**SMALL))
    model.load_state_dict(strip_prefix(from_jax_params(params), "dino."),
                          strict=True)
    return jcfg, params, model


@pytest.mark.parametrize("res,intermediate", [(240, 0), (120, 0), (240, 1)])
def test_vit_forward_matches_jax(small_pair, res, intermediate):
    jcfg, params, model = small_pair
    x = np.random.RandomState(res).randn(2, res, res, 3).astype(np.float32)
    ref = np.asarray(jvit.vit_forward(params, x, jcfg,
                                      intermediate=intermediate))
    with torch.no_grad():
        out = tvit.vit_forward(model, torch.from_numpy(x), model.cfg,
                               intermediate=intermediate)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_patchify_and_pos_interp_match_jax(small_pair):
    jcfg, params, model = small_pair
    x = np.random.RandomState(1).randn(1, 64, 48, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tvit.patchify(torch.from_numpy(x), 8).numpy(),
        np.asarray(jvit.patchify(x, 8)))
    ref = np.asarray(jvit.interpolate_pos_encoding(params["pos_embed"], 120,
                                                   120, 8))
    out = tvit.interpolate_pos_encoding(model.pos_embed.detach(), 120, 120, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    # the gh*gw == n and h == w short-cut returns the table itself
    same = tvit.interpolate_pos_encoding(model.pos_embed, 224, 224, 8)
    assert same is model.pos_embed


def test_prepare_tokens_rejects_integer_pixels(small_pair):
    _, _, model = small_pair
    with pytest.raises(TypeError, match="float"):
        tvit.prepare_tokens(model, torch.zeros(1, 16, 16, 3, dtype=torch.uint8),
                            model.cfg)


def test_jax_params_round_trip(small_pair):
    _, params, model = small_pair
    head = _numpy_tree(jinit_head(jax.random.PRNGKey(1), "mlp", 7, 64))
    vit_back, head_back = to_jax_params(from_jax_params(params, head))
    for a, b in zip(jax.tree.leaves(vit_back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(head_back), jax.tree.leaves(head)):
        np.testing.assert_array_equal(a, b)


def test_truncate_blocks(small_pair):
    jcfg, params, _ = small_pair
    model = tvit.VisionTransformer(tvit.ViTConfig(**SMALL))
    model.load_state_dict(strip_prefix(from_jax_params(params), "dino."))
    tvit.truncate_blocks(model, 1)
    assert len(model.blocks) == 1
    x = np.random.RandomState(2).randn(1, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jvit.vit_forward(jvit.truncate_blocks(params, 1), x,
                                      jcfg))
    with torch.no_grad():
        out = tvit.vit_forward(model, torch.from_numpy(x), model.cfg)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_mlp_head_matches_jax():
    head = _numpy_tree(jinit_head(jax.random.PRNGKey(2), "mlp", 7, 64))
    mod = theads.MLPHead(7, 64)
    mod.load_state_dict({f"{name}.{key}": torch.from_numpy(np.array(
        lin["kernel"].T if key == "weight" else lin["bias"]))
        for name, lin in head.items() for key in ("weight", "bias")},
        strict=True)
    x = np.random.RandomState(3).randn(50, 64).astype(np.float32)
    with torch.no_grad():
        out = theads.head_apply("mlp", mod, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jmlp_head(head, x)),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (f) torch goldens: a strict load of the reference-named weights
# ---------------------------------------------------------------------------

def _nhwc(x):
    return torch.from_numpy(np.transpose(x, (0, 2, 3, 1)).copy())


@pytest.fixture(scope="module")
def golden_model(vit_golden):
    sd = {k: torch.from_numpy(v) for k, v in
          golden_state_dict(vit_golden).items()}
    assert len(sd) == 30
    model = tvit.VisionTransformer(tvit.ViTConfig(**GOLDEN))
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize("x_key,out_key,kw", [
    ("x240", "out240", {}),
    ("x240", "out240_int1", {"intermediate": 1}),
    ("x240", "cls240", {"all_tokens": False}),
    ("x120", "out120", {}),
])
def test_golden_forward(vit_golden, golden_model, x_key, out_key, kw):
    with torch.no_grad():
        out = tvit.vit_forward(golden_model, _nhwc(vit_golden[x_key]),
                               golden_model.cfg, **kw)
    np.testing.assert_allclose(out.numpy(), vit_golden[out_key],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("head_type,prefix,out_key", [
    ("mlp", "sd::", "mlp_out"), ("linear", "sd_lin::", "lin_out")])
def test_golden_heads(heads_golden, head_type, prefix, out_key):
    sd = {k: torch.from_numpy(v)
          for k, v in golden_state_dict(heads_golden, prefix).items()}
    head = theads.init_head(head_type, 7, 192)
    head.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = theads.head_apply(head_type, head,
                                torch.from_numpy(heads_golden["feats"]))
    np.testing.assert_allclose(out.numpy(), heads_golden[out_key],
                               atol=ATOL, rtol=RTOL)
