"""The fp32 label legs of the bench configuration: ViT-S/8 cut to 3 blocks,
MLP head, 7 classes, random weights from dino_tpu's seed 0 carried across
with from_jax_params; both packages on the CPU in fp32, the frames already
at the resolution (so the resize is the identity on both sides and the
960px upscale tie stays out).  The label maps must be equal except at
patches whose top-2 log-prob margin (dino_tpu's) is below MARGIN.

The 960px leg is slow: dino_tpu's CPU forward materializes 6 x 14,401^2
float32 scores per block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dino_tpu.api import DINOSeg as JaxDINOSeg
from dino_tpu.ops.preprocess import preprocess as jax_preprocess
from dino_tpu.train.loop import seg_forward as jax_seg_forward
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.checkpointing.convert import from_jax_params

MARGIN = 1e-4  # top-2 log-prob gap below which fp32 argmax may flip


@pytest.fixture(scope="module")
def bench_pair():
    jm = JaxDINOSeg(head="mlp", n_blocks=3, n_classes=7, precision="fp32",
                    random_init=True, seed=0)
    pm = DINOSeg(head="mlp", n_blocks=3, n_classes=7, precision="fp32",
                 random_init=True, device="cpu")
    pm.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, jm.vit_params),
        jax.tree.map(np.asarray, jm.head_params)))
    return jm, pm


def _label_leg(jm, pm, res, batch, seed):
    """Port and dino_tpu label maps of ``batch`` frames at ``res``; returns
    (patches that differ, near-tie patches)."""
    frames = np.random.RandomState(seed).randint(
        0, 256, (batch, res, res, 3)).astype(np.uint8)
    for m in (jm, pm):
        m.set_resolution(res)
    out, ref = pm.predict_batch(frames), jm.predict_batch(frames)
    x = jax_preprocess(jnp.asarray(frames), res)
    logp = np.asarray(jax_seg_forward(jm.vit_params, jm.head_params, jm.cfg,
                                      "mlp", pre_normalized=x))
    grid, f = res // 8, 480 // (res // 8)
    top2 = np.sort(logp, axis=-1)[:, -2:]
    near = ((top2[:, 1] - top2[:, 0]) < MARGIN).reshape(batch, grid, grid)
    assert out.shape == ref.shape == (batch, 480, 480)
    assert out.dtype == np.int32
    low, low_ref = out[:, ::f, ::f], ref[:, ::f, ::f]
    np.testing.assert_array_equal(low[~near], low_ref[~near])
    np.testing.assert_array_equal(out, np.kron(low, np.ones((1, f, f),
                                                            np.int32)))
    return int((low != low_ref).sum()), int(near.sum())


def test_labels_480_match_jax(bench_pair):
    jm, pm = bench_pair
    _label_leg(jm, pm, 480, 2, seed=0)


@pytest.mark.slow
def test_labels_960_match_jax(bench_pair):
    jm, pm = bench_pair
    _label_leg(jm, pm, 960, 1, seed=1)
