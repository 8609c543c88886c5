"""dino_tpu_torch's CUDA kernels against their plain versions, on the card.

Skips without a CUDA device.  Imports neither jax nor dino_tpu, so the card
machine runs it without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.models import heads
from dino_tpu_torch.models.vit import Block, Mlp, ViTConfig
from dino_tpu_torch.models.vit import layer_norm as tvit_layer_norm
from dino_tpu_torch.ops import attention as tatt
from dino_tpu_torch.ops import fused_mlp as tfm
from dino_tpu_torch.train import loop as tloop

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_port_cuda.py on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [37, 901])
def test_flash_kernel_matches_plain(cuda, dtype, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    q, k, v = (torch.randn(2, 3, n, 64, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = tatt.flash_attention.launches
    out, lse = tatt.flash_attention(q, k, v, 0.125, return_lse=True)
    assert tatt.flash_attention.launches == before + 1
    ref, ref_lse = tatt.attention_plain(q, k, v, 0.125)
    atol, rtol = chip_smoke.FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=chip_smoke.LSE_ATOL, rtol=0)


def test_fused_mlp_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(0)
    block = Block(ViTConfig())
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    block = block.to(cuda)
    x = (torch.randn(1000, 384, generator=g) * 0.5).to(cuda, torch.bfloat16)
    before = tfm.fused_ln_mlp_residual.launches
    with torch.no_grad():
        out = tfm.fused_ln_mlp_residual(block.norm2, block.mlp, x, 1e-6)
        ref = tfm.fused_ln_mlp_residual_plain(block.norm2, block.mlp, x, 1e-6)
    assert tfm.fused_ln_mlp_residual.launches == before + 1
    assert chip_smoke.mlp_err(out, ref, x)[2]


def test_predict_on_card_runs_both_kernels(cuda):
    model = DINOSeg(head="mlp", n_blocks=1, precision="bf16", random_init=True)
    assert model.device.type == "cuda"
    model.set_resolution(240)
    frame = np.random.RandomState(0).randint(0, 256, (240, 320, 3)).astype(
        np.uint8)
    flash0 = tatt.flash_attention.launches
    mlp0 = tfm.fused_ln_mlp_residual.launches
    out = model.predict(frame)
    assert out.shape == (480, 480) and out.dtype == np.int32
    assert tatt.flash_attention.launches == flash0 + 1
    assert tfm.fused_ln_mlp_residual.launches == mlp0 + 1
    cpu = DINOSeg(head="mlp", n_blocks=1, precision="fp32", random_init=True,
                  device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in
                         model.model.state_dict().items()})
    cpu.set_resolution(240)
    img = torch.from_numpy(frame[None])
    card = model.log_probs(img.to(cuda), precision="fp32").cpu()
    np.testing.assert_allclose(card.numpy(), cpu.log_probs(img).numpy(),
                               atol=chip_smoke.CPU_LOGP_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [37, 901])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    q, k, v, do = (torch.randn(2, 3, n, 64, generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    out, lse = tatt.flash_attention(q, k, v, 0.125, return_lse=True)
    before = tatt.flash_attention_bwd.launches
    got = tatt.flash_attention_bwd(q, k, v, out, lse, do, 0.125)
    assert tatt.flash_attention_bwd.launches == before + 1
    ref = tatt.attention_bwd_plain(q, k, v, out, lse, do, 0.125)
    assert all(t.dtype == torch.float32 for t in got)
    assert chip_smoke.bwd_err(got, ref, dtype)[1]


def _train_pair(cuda, res, seed=0):
    """A 1-block ViT-S/8 + MLP head on the card and its copy on the CPU."""
    card = DINOSeg(head="mlp", n_blocks=1, random_init=True, seed=seed,
                   freeze_backbone=False)
    cpu = DINOSeg(head="mlp", n_blocks=1, random_init=True, device="cpu",
                  freeze_backbone=False)
    cpu.load_state_dict({k: v.cpu() for k, v in
                         card.model.state_dict().items()})
    rs = np.random.RandomState(seed)
    imgs = torch.from_numpy(rs.randint(0, 255, (2, res, res, 3)).astype(
        np.uint8))
    labels = torch.from_numpy(rs.randint(0, 7, (2, (res // 8) ** 2)).astype(
        np.int32))
    return card, cpu, imgs, labels


def _step(model, imgs, labels, compute_dtype, accum_steps=1):
    opt = tloop.make_optimizer("adam", 1e-5)
    vit, head = model.model.dino, model.model.clf
    step = tloop.make_train_step(model.cfg, "mlp", 7, opt, False,
                                 compute_dtype=compute_dtype,
                                 accum_steps=accum_steps)
    return step(vit, head, tloop.init_opt_state(opt, vit, head, False),
                imgs.to(model.device), labels.to(model.device))


def test_unfrozen_bf16_step_launches_the_backward(cuda):
    card, _, imgs, labels = _train_pair(cuda, 240)
    before = (tatt.flash_attention.launches, tatt.flash_attention_bwd.launches,
              tfm.fused_ln_mlp_residual.launches)
    loss, _ = _step(card, imgs, labels, torch.bfloat16, accum_steps=2)
    after = (tatt.flash_attention.launches, tatt.flash_attention_bwd.launches,
             tfm.fused_ln_mlp_residual.launches)
    # 2 microbatches x 1 block: forward and backward each, no fused MLP
    assert [a - b for a, b in zip(after, before)] == [2, 2, 0]
    assert bool(torch.isfinite(loss))
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in card.model.dino.parameters())


def test_card_backbone_gradients_equal_the_cpu_step(cuda):
    """fp32: every backbone parameter gets a gradient through the CUDA
    kernels, and it equals the CPU step's (chip_smoke's tolerances)."""
    card, cpu, imgs, labels = _train_pair(cuda, 240, seed=1)
    loss_card, _ = _step(card, imgs, labels, None)
    loss_cpu, _ = _step(cpu, imgs, labels, None)
    np.testing.assert_allclose(loss_card.item(), loss_cpu.item(),
                               rtol=chip_smoke.STEP_LOSS_RTOL)
    grads = dict(card.model.named_parameters())
    for name, p in cpu.model.named_parameters():
        g = grads[name].grad
        assert g is not None, name
        diff = (g.cpu() - p.grad).abs().max().item()
        assert diff <= chip_smoke.STEP_GRAD_REL * p.grad.abs().max().item(), \
            name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n, valid", [(901, 901), (901, 900), (901, 1),
                                      (901, 0), (37, 36)])
def test_dyn_kernels_match_plain(cuda, dtype, n, valid):
    """Kernels 5 and 6 (one ring hop) vs their plain versions; dead keys'
    dk/dv rows are exact zeros, and with no valid key the lse is ~ -1e30."""
    g = torch.Generator(device=cuda).manual_seed(n + valid)
    q, k, v, do = (torch.randn(2, 3, n, 64, generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    before = (tatt.flash_attention_with_lse_dyn.launches,
              tatt.flash_attention_bwd_dyn.launches)
    out, lse = tatt.flash_attention_with_lse_dyn(q, k, v, 0.125, valid)
    ref, ref_lse = tatt.attention_dyn_plain(q, k, v, 0.125, valid)
    atol, rtol = chip_smoke.FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=chip_smoke.LSE_ATOL, rtol=0)
    if valid == 0:
        assert float(lse.max()) <= -1e29
    if valid:  # the backward's global lse and D: this bound's forward
        glse, gout = ref_lse, ref
    else:  # no valid key: any finite lse, the full bound's
        gout, glse = tatt.attention_plain(q, k, v, 0.125)
    dsum = (do.float() * gout.float()).sum(-1).reshape(6, n)
    got = tatt.flash_attention_bwd_dyn(q, do, glse, dsum, k, v, 0.125, valid)
    want = tatt.attention_bwd_dyn_plain(q, do, glse, dsum, k, v, 0.125, valid)
    assert (tatt.flash_attention_with_lse_dyn.launches,
            tatt.flash_attention_bwd_dyn.launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert all(t.dtype == torch.float32 for t in got)
    assert chip_smoke.bwd_dyn_err(got, want, dtype)[1]
    for t in got[1:]:
        assert torch.count_nonzero(t[:, :, valid:]) == 0


def test_dyn_forward_at_full_bound_is_the_static_kernel(cuda):
    """At valid = N kernel 5 runs kernel 1's loop: the same bits."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 3, 901, 64, generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(3))
    out, lse = tatt.flash_attention_with_lse_dyn(q, k, v, 0.125, 901)
    out1, lse1 = tatt.flash_attention(q, k, v, 0.125, return_lse=True)
    assert torch.equal(out, out1) and torch.equal(lse, lse1)


@pytest.mark.parametrize("n", [37, 129, 901, 4001])
def test_f32_forward_matches_plain(cuda, n):
    """The 3-pass TF32 forward (kernels 1 and 4 in f32) vs its plain
    version, at FLASH_TOL/LSE_ATOL; out is the same bits with and without
    the LSE."""
    g = torch.Generator(device=cuda).manual_seed(n + 1)
    q, k, v = (torch.randn(1, 6, n, 64, generator=g, device=cuda)
               for _ in range(3))
    out, lse = tatt.flash_attention(q, k, v, 0.125, return_lse=True)
    out_only = tatt.flash_attention(q, k, v, 0.125)
    ref, ref_lse = tatt.attention_plain(q, k, v, 0.125)
    atol, rtol = chip_smoke.FLASH_TOL[torch.float32]
    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=chip_smoke.LSE_ATOL, rtol=0)
    assert torch.equal(out, out_only)


@pytest.mark.parametrize("n", [127, 128, 129, 901, 3601])
def test_bf16_bwd_at_tile_edges(cuda, n):
    """The bf16 backward (128-row blocks of 64-row warpgroups) vs its plain
    version at N on both sides of the tiles, static and dynamic-bound, with
    the bound on both sides of them too; dead keys' rows exact zeros."""
    g = torch.Generator(device=cuda).manual_seed(n + 2)
    q, k, v, do = (torch.randn(2, 6, n, 64, generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(4))
    out, lse = tatt.flash_attention(q, k, v, 0.125, return_lse=True)
    got = tatt.flash_attention_bwd(q, k, v, out, lse, do, 0.125)
    ref = tatt.attention_bwd_plain(q, k, v, out, lse, do, 0.125)
    assert chip_smoke.bwd_err(got, ref, torch.bfloat16)[1]
    dsum = (do.float() * out.float()).sum(-1).reshape(12, n)
    for valid in sorted({n, n - 1, 127, 128, 129, 64, 1, 0}):
        if valid > n:
            continue
        got = tatt.flash_attention_bwd_dyn(q, do, lse, dsum, k, v, 0.125,
                                           valid)
        want = tatt.attention_bwd_dyn_plain(q, do, lse, dsum, k, v, 0.125,
                                            valid)
        assert chip_smoke.bwd_dyn_err(got, want, torch.bfloat16)[1], valid
        for t in got[1:]:
            assert torch.count_nonzero(t[:, :, valid:]) == 0, valid
        assert all(bool(torch.isfinite(t).all()) for t in got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_repeats_its_bits(cuda, dtype):
    """Two back-to-back backward calls (static and dynamic-bound) give the
    same bits: no atomics, a fixed order of every sum."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn(2, 6, 901, 64, generator=g, device=cuda).to(
        dtype) for _ in range(4))
    out, lse = tatt.flash_attention(q, k, v, 0.125, return_lse=True)
    a = tatt.flash_attention_bwd(q, k, v, out, lse, do, 0.125)
    b = tatt.flash_attention_bwd(q, k, v, out, lse, do, 0.125)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    dsum = (do.float() * out.float()).sum(-1).reshape(12, 901)
    a = tatt.flash_attention_bwd_dyn(q, do, lse, dsum, k, v, 0.125, 700)
    b = tatt.flash_attention_bwd_dyn(q, do, lse, dsum, k, v, 0.125, 700)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n", [chip_smoke.FWD_BQ - 1, chip_smoke.FWD_BQ,
                               chip_smoke.FWD_BQ + 1, 901])
def test_bf16_fwd_at_tile_edges(cuda, n):
    """The bf16 forward at query counts around its block rows, B*nh = 1,
    static and dynamic-bound with bounds around its key tiles; each call
    twice, the same bits."""
    g = torch.Generator(device=cuda).manual_seed(n + 3)
    q, k, v = (torch.randn(1, 1, n, 64, generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(3))
    atol, rtol = chip_smoke.FLASH_TOL[torch.bfloat16]
    out, lse = tatt.flash_attention(q, k, v, 0.125, return_lse=True)
    again = tatt.flash_attention(q, k, v, 0.125, return_lse=True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = tatt.attention_plain(q, k, v, 0.125)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=chip_smoke.LSE_ATOL, rtol=0)
    for valid in sorted({0, 1, 63, 64, 65, 127, 128, 129, n}):
        if valid > n:
            continue
        out, lse = tatt.flash_attention_with_lse_dyn(q, k, v, 0.125, valid)
        again = tatt.flash_attention_with_lse_dyn(q, k, v, 0.125, valid)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        ref, ref_lse = tatt.attention_dyn_plain(q, k, v, 0.125, valid)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
        if valid:
            torch.testing.assert_close(lse, ref_lse,
                                       atol=chip_smoke.LSE_ATOL, rtol=0)
        else:
            assert float(lse.max()) <= -1e29


@pytest.mark.parametrize("hidden", [64, 1536])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 129, 3601, 2 * 16 * 785])
def test_fused_mlp_at_row_edges(cuda, m, hidden):
    """The fused MLP on both sides of its 64-row blocks and cluster pairs,
    and at the bf16 DINO pretrain step's teacher rows (2 global views x
    batch 16 x 785 tokens, half a block past 392 blocks), with the model's
    own init (trunc-normal .02 weights), at hidden 64 and 1,536; twice,
    the same bits."""
    gen = torch.Generator().manual_seed(m + hidden)
    norm = torch.nn.LayerNorm(384, eps=1e-6)
    mlp = Mlp(ViTConfig(mlp_ratio=hidden / 384))
    with torch.no_grad():
        for lin in (mlp.fc1, mlp.fc2):
            torch.nn.init.trunc_normal_(lin.weight, std=0.02, a=-0.04, b=0.04,
                                        generator=gen)
            torch.nn.init.zeros_(lin.bias)
    norm, mlp = norm.to(cuda), mlp.to(cuda)
    x = (torch.randn(m, 384, generator=gen) * 0.5).to(cuda, torch.bfloat16)
    with torch.no_grad():
        out = tfm.fused_ln_mlp_residual(norm, mlp, x, 1e-6)
        again = tfm.fused_ln_mlp_residual(norm, mlp, x, 1e-6)
        ref = tfm.fused_ln_mlp_residual_plain(norm, mlp, x, 1e-6)
    assert torch.equal(out, again)
    assert chip_smoke.mlp_err(out, ref, x)[2]


@pytest.mark.parametrize("n", chip_smoke.BWD_EDGE_N)
def test_f32_bwd_at_tile_edges(cuda, n):
    """The f32 backward (flash_bwd_f32) at query counts around its 32-row
    tiles, 64-row warpgroups and 128-row blocks, B*nh = 1: static, and
    dynamic-bound with key bounds around its tiles; each call twice, the
    same bits; dead keys' rows exact zeros; every launch counted as f32."""
    g = torch.Generator(device=cuda).manual_seed(n + 3)
    q, k, v, do = (torch.randn(1, 1, n, 64, generator=g, device=cuda)
                   for _ in range(4))
    out, lse = tatt.flash_attention(q, k, v, 0.125, return_lse=True)
    before = (tatt.flash_attention_bwd.launches_f32,
              tatt.flash_attention_bwd_dyn.launches_f32)
    got = tatt.flash_attention_bwd(q, k, v, out, lse, do, 0.125)
    again = tatt.flash_attention_bwd(q, k, v, out, lse, do, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = tatt.attention_bwd_plain(q, k, v, out, lse, do, 0.125)
    assert chip_smoke.bwd_err(got, ref, torch.float32)[1]
    dsum = (do * out).sum(-1).reshape(1, n)
    bounds = sorted(b for b in {0, 1, 63, 64, 65, n} if b <= n)
    for valid in bounds:
        got = tatt.flash_attention_bwd_dyn(q, do, lse, dsum, k, v, 0.125,
                                           valid)
        again = tatt.flash_attention_bwd_dyn(q, do, lse, dsum, k, v, 0.125,
                                             valid)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), valid
        want = tatt.attention_bwd_dyn_plain(q, do, lse, dsum, k, v, 0.125,
                                            valid)
        assert chip_smoke.bwd_err(got, want, torch.float32)[1], valid
        for t in got[1:]:
            assert torch.count_nonzero(t[:, :, valid:]) == 0, valid
    assert (tatt.flash_attention_bwd.launches_f32,
            tatt.flash_attention_bwd_dyn.launches_f32) == (
                before[0] + 2, before[1] + 2 * len(bounds))


def test_bf16_dense_on_card_matches_the_cpu(cuda):
    """heads.linear_once on the card (mm with a float32 result, then the
    float32 bias and one rounding) against its CPU form on the same bf16 operands: the
    float32 sums within float32 rounding of their terms, and under autograd
    the same gradients up to bf16 rounding."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(300, 384).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rs.randn(1152, 384).astype(np.float32) / 20
                         ).bfloat16()
    b = torch.from_numpy(rs.uniform(-0.5, 0.5, 1152).astype(np.float32))
    g = torch.from_numpy(rs.randn(300, 1152).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        xs, ws, bs = (t.detach().clone().to(dev).requires_grad_()
                      for t in (x, w, b))
        y = heads.linear_once(xs, ws, bs, torch.float32)
        assert y.dtype == torch.float32
        y.backward(g.to(dev))
        grads.append([t.detach().cpu().float() for t in (y, xs.grad,
                                                           ws.grad, bs.grad)])
    terms = x.float().abs() @ w.float().abs().t() + b.abs()
    assert bool(((grads[0][0] - grads[1][0]).abs() <= 1e-6 * terms).all())
    for a, c in zip(grads[0][1:], grads[1][1:]):
        torch.testing.assert_close(c, a, rtol=1e-2, atol=1e-2)


def test_attention_maps_on_card_match_the_cpu(cuda):
    """chip_smoke's 240px attention-map checks on a 2-block model: the card
    against the port's CPU run, with the launches of each call (the f32
    forward depth - 1 times per attention call, bf16 intermediate layers on
    the bf16 forward and the fused MLP)."""
    model = DINOSeg(head="mlp", n_blocks=2, precision="bf16", random_init=True)
    frame = np.random.RandomState(0).randint(0, 256, (240, 320, 3)).astype(
        np.uint8)
    total = chip_smoke.attention_checks(
        model, chip_smoke.attention_twins(model), frame,
        chip_smoke.attention_masks(chip_smoke.ATTN_MASKS, 30, seed=1))
    assert total["flash_attn_fwd_f32"] == 5 * 1 + 2
    assert total["flash_attn_fwd"] - total["flash_attn_fwd_f32"] == 2
    assert total["fused_ln_mlp"] == 2


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_predict_stream_on_card_equals_predict_batch(cuda, precision):
    """predict_stream (6 frames, batch 4: a ragged tail of 2) gives
    predict_batch's maps on the padded batches, bit for bit; one block's
    kernels a batch, or a chunk where the batch splits over the cards."""
    model = DINOSeg(head="mlp", n_blocks=1, precision="bf16", random_init=True)
    model.set_resolution(240)
    frames = np.random.RandomState(1).randint(
        0, 256, (6, 240, 320, 3)).astype(np.uint8)
    got = chip_smoke.stream_check(model, frames, 4, precision)
    chunks = len(model._split_devices(4, None) or [cuda])
    assert got["flash_attn_fwd"] == 2 * chunks
    assert got["fused_ln_mlp"] == (2 * chunks if precision == "bf16" else 0)


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_fit_on_card_launches_the_kernels(cuda, tmp_path, precision):
    """A one-block fit at 240px on the card over an in-memory split (handed
    in through _make_dataset): 2 steps of batch 2, then the val and test
    passes, one batch each."""
    splits = {name: chip_smoke.memory_split(n, seed) for seed, (name, n) in
              enumerate({"train": 4, "val": 2, "test": 2}.items())}
    model = chip_smoke.MemoryDINOSeg(
        splits, head="mlp", n_blocks=1, n_classes=7, random_init=True,
        precision=precision, freeze_backbone=False, batch_size=2, lr=1e-5,
        optimizer="adam", max_epochs=1, augmented=True,
        train_resolution=240, write_path=str(tmp_path),
        logger=chip_smoke.FitLog())
    assert model.device.type == "cuda"
    out, got = chip_smoke.counted(lambda: model.fit(samples_per_epoch=4))
    if precision == "bf16":
        want = chip_smoke.launches_want(fwd=4, mlp=2, bwd=2)
    else:
        want = chip_smoke.launches_want(fwd_f32=4, bwd_f32=2)
    assert got == want
    assert out["test_support"] == 2 * 30 * 30
    (step, metrics), = [(s, m) for s, m in model.logger.metrics if s >= 0]
    assert np.isfinite(metrics["train_loss"]) and metrics["train_steps"] == 2
    assert metrics["hbm_peak_gb"] > 0


def test_device_augment_on_card_equals_the_cpu(cuda):
    """The device augmentation at 480px over 8 samples that reach every op
    (chip_smoke's batch): the card's bits equal the CPU's, twice, and it
    launches none of the kernels."""
    from dino_tpu_torch.data.augment import prepare_device_batch, resize_pair
    from dino_tpu_torch.ops.device_augment import device_augment_batch
    frames, _ = chip_smoke.memory_split(4, 0)
    params = chip_smoke.augment_batch_params(3, n=8)
    imgs = np.stack([resize_pair(frames[i % 4], None, 480)[0]
                     for i in range(8)])
    staged, packed = prepare_device_batch(imgs, params, 480)
    want = device_augment_batch(staged, packed, device="cpu")
    got, launched = chip_smoke.counted(lambda: [
        device_augment_batch(staged, packed, device=cuda) for _ in range(2)])
    for g in got:
        assert g.is_cuda and torch.equal(g.cpu(), want)
    assert not any(launched.values())


def test_fit_on_card_with_device_augmentation(cuda, tmp_path):
    """A one-block bf16 fit at 240px with augment_backend='device': every
    train batch goes through the device augmentation on the card, and the
    launches are those of the host rungs' fit."""
    from dino_tpu_torch.ops.device_augment import device_augment_batch
    splits = {name: chip_smoke.memory_split(n, seed) for seed, (name, n) in
              enumerate({"train": 4, "val": 2, "test": 2}.items())}
    model = chip_smoke.MemoryDINOSeg(
        splits, head="mlp", n_blocks=1, n_classes=7, random_init=True,
        precision="bf16", freeze_backbone=False, batch_size=2, lr=1e-5,
        optimizer="adam", max_epochs=1, augmented=True,
        train_resolution=240, write_path=str(tmp_path),
        logger=chip_smoke.FitLog())
    calls = device_augment_batch.calls
    out, got = chip_smoke.counted(lambda: model.fit(
        samples_per_epoch=3, augment_backend="device"))
    assert device_augment_batch.calls == calls + 2
    assert got == chip_smoke.launches_want(fwd=4, mlp=2, bwd=2)
    (step, metrics), = [(s, m) for s, m in model.logger.metrics if s >= 0]
    assert np.isfinite(metrics["train_loss"]) and metrics["train_steps"] == 2


def _serve_frames(n, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (n, 240, 320, 3)).astype(np.uint8)


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_program_replay_equals_eager(cuda, precision):
    """The fixed-shape program (a CUDA graph over bf16 weight copies) gives
    predict_batch's maps bit for bit, twice; each replay launches the
    flash forward (and in bf16 the fused MLP) once per block."""
    from dino_tpu_torch.serving import predict_program
    model = DINOSeg(head="mlp", n_blocks=2, n_classes=7, precision=precision,
                    random_init=True, seed=2)
    model.set_resolution(240)
    frames = _serve_frames(2, 2)
    program = predict_program(model, 2, (240, 320))
    got, again = program(frames), program(frames)
    np.testing.assert_array_equal(got, model.predict_batch(frames))
    np.testing.assert_array_equal(again, got)
    per = chip_smoke.replay_kernel_counts(lambda: program(frames))
    fwd = "flash_fwd_bf16" if precision == "bf16" else "flash_fwd_f32"
    assert per[fwd] == 2
    assert per["fused_ln_mlp_kernel"] == (2 if precision == "bf16" else 0)


def test_program_recaptures_after_a_weight_change(cuda):
    """A fused Adam step (no version bump) and a load_state_dict each
    rebuild the weight copies and recapture; the new program follows the
    new weights bit for bit."""
    from dino_tpu_torch.serving import predict_program
    model = DINOSeg(head="mlp", n_blocks=1, n_classes=7, precision="bf16",
                    random_init=True, seed=3)
    model.set_resolution(240)
    frames = _serve_frames(2, 3)
    program = predict_program(model, 2, (240, 320))
    before = program(frames)
    params = list(model.model.parameters())
    opt = torch.optim.Adam(params, lr=0.05, fused=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen, device=cuda)
    opt.step()
    assert program.stale()
    after = program(frames)
    assert program.builds == 2
    np.testing.assert_array_equal(after, model.predict_batch(frames))
    assert (after != before).any()
    model.load_state_dict({k: v * 1.5 for k, v in
                           model.model.state_dict().items()})
    assert program.stale()
    np.testing.assert_array_equal(program(frames),
                                  model.predict_batch(frames))
    assert program.builds == 3


def test_export_round_trip_on_card(cuda, tmp_path):
    from dino_tpu_torch import export_predict, load_exported_predict
    model = DINOSeg(head="mlp", n_blocks=1, n_classes=7, precision="bf16",
                    random_init=True, seed=4)
    model.set_resolution(240)
    path = str(tmp_path / "p.dtts")
    export_predict(model, path, batch_size=2, in_shape=(240, 320))
    served = load_exported_predict(path)
    assert served.device.type == "cuda"
    frames = _serve_frames(2, 4)
    np.testing.assert_array_equal(served(frames), model.predict_batch(frames))
    assert served.contract["platforms"] == ["cuda"]


def test_server_request_on_card(cuda, tmp_path):
    """One PNG request to the server over a bf16 checkpoint on the card."""
    import io
    model = DINOSeg(head="mlp", n_blocks=1, n_classes=7, precision="bf16",
                    random_init=True, seed=5)
    model.set_resolution(240)
    ckpt = str(tmp_path / "m.ckpt.npz")
    model.save(ckpt)
    server, port = chip_smoke.start_server(ckpt, resolution=240)
    try:
        img = _serve_frames(1, 5)[0]
        body, ctype = chip_smoke.http(port, "/predict",
                                      chip_smoke.png_body(img))
        assert ctype == "application/octet-stream"
        np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                      model.predict(img))
        assert chip_smoke.http_json(port, "/healthz")["device"] == "cuda"
    finally:
        chip_smoke.stop_server(server)


# ---------------------------------------------------------------------------
# int8 serving, the MoE head, the cnn backbones
# ---------------------------------------------------------------------------

def test_int8_codes_and_dense_on_card_equal_the_cpu(cuda):
    """Weight and token codes and scales, and int8_dense's bf16 and float32
    outputs at the fc1 shape of a 480px batch of 3: the card's bits are the
    CPU's."""
    from dino_tpu_torch.ops.quant import (int8_dense, quantize_dense,
                                          quantize_tokens)
    g = torch.Generator().manual_seed(0)
    w = torch.randn(1536, 384, generator=g) * 0.02
    b = torch.randn(1536, generator=g) * 0.01
    q_cpu, q_card = quantize_dense(w, b), quantize_dense(w.to(cuda),
                                                         b.to(cuda))
    assert torch.equal(q_card.weight_i8.cpu(), q_cpu.weight_i8)
    assert torch.equal(q_card.w_scale.cpu(), q_cpu.w_scale)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(10803, 384, generator=g).to(dtype)
        codes, scale = quantize_tokens(x.to(cuda))
        ref_codes, ref_scale = quantize_tokens(x)
        assert torch.equal(codes.cpu(), ref_codes)
        assert torch.equal(scale.cpu(), ref_scale)
        assert torch.equal(int8_dense(q_card, x.to(cuda)).cpu(),
                           int8_dense(q_cpu, x))


def test_moe_sparse_combine_same_bits_twice(cuda):
    """The sparse dispatch's index_add_ combine on the card: every real row
    takes one addend, so two calls give the same bits, and with capacity
    >= E the dense dispatch's."""
    head = heads.init_head("moe", 7, 384, torch.Generator().manual_seed(0),
                           n_experts=4).to(cuda)
    x = torch.randn(10800, 384, generator=torch.Generator().manual_seed(1)
                    ).to(cuda, torch.bfloat16)
    with torch.no_grad():
        a = heads.moe_head_apply_sparse(head, x, 4.0)
        b = heads.moe_head_apply_sparse(head, x, 4.0)
        dense = heads.moe_head_apply(head, x)
        dropped = heads.moe_head_apply_sparse(head, x, 1.0)
    assert torch.equal(a, b)
    assert torch.equal(a.argmax(-1), dense.argmax(-1))
    assert torch.isfinite(dropped).all()


def test_cnn1_fp32_forward_on_card_matches_the_cpu(cuda):
    from dino_tpu_torch.models import resnet
    from dino_tpu_torch.precision import true_fp32
    model = resnet.init_resnet_params(resnet.ResNetBackbone("cnn1"),
                                      torch.Generator().manual_seed(0))
    x = torch.randn(2, 240, 240, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = resnet.resnet_features(model, x)
        with true_fp32():
            got = resnet.resnet_features(model.to(cuda), x.to(cuda)).cpu()
    assert got.shape == ref.shape == (2 * 30 * 30, 512)
    assert (got - ref).abs().max() <= chip_smoke.CNN_F32_REL * ref.abs().max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bh,n", chip_smoke.PRETRAIN_ATTN)
def test_flash_kernels_at_the_pretrain_shapes(cuda, dtype, bh, n):
    """The forward and backward at the DINO pretrain step's (B*nh, N):
    local views (768, 145) and global views (192, 785), both a 17-row tail
    past the 128-row blocks."""
    q, k, v, do, out, lse = chip_smoke.bwd_inputs(bh, n, dtype, seed=n)
    ref, ref_lse = tatt.attention_plain(q, k, v, chip_smoke.SCALE)
    atol, rtol = chip_smoke.FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=chip_smoke.LSE_ATOL, rtol=0)
    before = tatt.flash_attention_bwd.launches
    got = tatt.flash_attention_bwd(q, k, v, out, lse, do, chip_smoke.SCALE)
    assert tatt.flash_attention_bwd.launches == before + 1
    assert chip_smoke.bwd_err(got, tatt.attention_bwd_plain(
        q, k, v, out, lse, do, chip_smoke.SCALE), dtype)[1]


def test_full_depth_pretrain_step_launches(cuda):
    """One DINO pretrain step at ViT-S/8's full depth (12 blocks, the
    default DinoConfig, batch 2) on the card: every student and teacher
    forward on the f32 flash kernel, every student backward on the f32
    backward, a finite loss and gradient."""
    from dino_tpu_torch.models.vit import vit_small
    from dino_tpu_torch.train import dino_pretrain as tdp
    cfg = tdp.DinoConfig()
    student, teacher = tdp.init_dino_params(
        torch.Generator().manual_seed(0), vit_small(patch_size=8), cfg,
        device=cuda)
    opt = tdp.make_dino_optimizer(student)
    g, l = (t.to(cuda) for t in chip_smoke.pretrain_crops(1, 2, cfg))
    step = tdp.make_dino_train_step(vit_small(patch_size=8), cfg)
    chip_smoke.zero_counts()
    loss = step(student, teacher, torch.zeros(1, cfg.out_dim, device=cuda),
                opt, g, l, 0.04, 0.996, 0.0)
    torch.cuda.synchronize()
    assert chip_smoke.all_counts() == chip_smoke.pretrain_want(12)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(p.grad).all())
               for p in student.parameters())


def test_sharded_fused_adamw_has_the_plain_bits(cuda):
    """The fused AdamW on flat shards (ZeRO-1's and FSDP's update) takes the
    same per-element steps as on whole tensors, moments included."""
    from dino_tpu_torch.parallel.mesh import ShardedOptimizer
    g = torch.Generator(device=cuda).manual_seed(3)
    shapes = ((384, 1152), (1152,), (7,))
    init = [torch.randn(s, generator=g, device=cuda) for s in shapes]
    whole = [p.clone().requires_grad_() for p in init]
    flat = [p.clone().requires_grad_() for p in init]
    opt_w = torch.optim.AdamW(whole, lr=1e-3, fused=True)
    opt_f = ShardedOptimizer(torch.optim.AdamW(flat, lr=1e-3, fused=True))
    for _ in range(3):
        grads = [torch.randn(s, generator=g, device=cuda) for s in shapes]
        for w, f, gr in zip(whole, flat, grads):
            w.grad, f.grad = gr.clone(), gr.clone()
        opt_w.step()
        opt_f.step()
    for w, f in zip(whole, flat):
        assert torch.equal(w, f)
    got = opt_f.state_dict()["state"]
    for i, st in opt_w.state_dict()["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got[i][k], st[k])


_DP_RANK = """
import hashlib, json, sys
import torch
import torch.distributed as dist
cfg = json.loads(sys.argv[1])
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.ops import attention as tatt
from dino_tpu_torch.parallel import dist as pd
from dino_tpu_torch.parallel.mesh import materialize
from dino_tpu_torch.train import loop as tloop
pd.init_distributed_mode("gloo", cfg["init"], cfg["world"], cfg["rank"])
m = DINOSeg(head="mlp", n_blocks=1, n_classes=3, random_init=True, seed=1,
            freeze_backbone=False)
vit, head, world = m.model.dino, m.model.clf, dist.group.WORLD
mesh = {cfg.get("mode", "zero") + "_mesh": world}
opt = tloop.make_optimizer("adam", 1e-4)
state = tloop.init_opt_state(opt, vit, head, False, **mesh)
step = tloop.make_train_step(m.cfg, "mlp", 3, opt, False,
                             compute_dtype=torch.bfloat16, dp_group=world,
                             **mesh)
gen = torch.Generator().manual_seed(2)
x = torch.randint(0, 255, (4, 64, 64, 3), generator=gen, dtype=torch.uint8)
y = torch.randint(0, 3, (4, 64), generator=gen, dtype=torch.int32)
rows = slice(2 * cfg["rank"], 2 * cfg["rank"] + 2)
before = tatt.flash_attention_bwd.launches
step(vit, head, state, x[rows].cuda(), y[rows].cuda())
materialize(state)  # FSDP: the whole model, to digest
h = hashlib.sha1()
for p in m.model.parameters():
    h.update(p.detach().cpu().numpy().tobytes())
with open(cfg["out"], "w") as fh:
    json.dump({"digest": h.hexdigest(),
               "bwd": tatt.flash_attention_bwd.launches - before}, fh)
"""


def test_two_ranks_sharing_the_card_hold_one_replica(cuda, tmp_path):
    """A ZeRO-1 data-parallel bf16 step over two gloo ranks on the card:
    both launch the flash backward and end with the same bits."""
    import json

    from tests.test_torch_port_multiprocess import spawn_ranks
    outs = [json.load(open(o)) for o in spawn_ranks(tmp_path, 2, _DP_RANK,
                                                    {})]
    assert outs[0]["digest"] == outs[1]["digest"]
    assert all(o["bwd"] == 1 for o in outs)


def test_two_fsdp_ranks_sharing_the_card_hold_one_replica(cuda, tmp_path):
    """The same step under FSDP (one unit gathered at a time, each unit's
    gradient reduced over gloo): one backward launch a rank (the recompute
    is a forward), and the ranks' gathered parameters the same bits."""
    import json

    from tests.test_torch_port_multiprocess import spawn_ranks
    outs = [json.load(open(o)) for o in spawn_ranks(tmp_path, 2, _DP_RANK,
                                                    {"mode": "fsdp"})]
    assert outs[0]["digest"] == outs[1]["digest"]
    assert all(o["bwd"] == 1 for o in outs)


def _tp_block(cuda, dtype):
    """A full-width block on the card with random weights, and LayerNorm'd
    tokens of the 480px batch-3 predict (3 x 3,601 rows) in ``dtype``."""
    g = torch.Generator().manual_seed(5)
    cfg = ViTConfig()
    block = Block(cfg)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    block = block.to(cuda)
    x = torch.randn(3, 3601, 384, generator=g).to(cuda, dtype)
    return cfg, block, x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world", [2, 4])
def test_tp_column_parallel_bits_on_card(cuda, dtype, world):
    """Each rank's column-parallel qkv and fc1 on the card: the single-rank
    layer's bits on its columns (6 heads on 4 ranks split 2, 2, 1, 1)."""
    from dino_tpu_torch.parallel import tp
    cfg, block, x = _tp_block(cuda, dtype)
    nh, hd = cfg.num_heads, cfg.head_dim
    with torch.no_grad():
        h = tvit_layer_norm(block.norm1, x, cfg.ln_eps)
        qkv = heads.dense(h, block.attn.qkv.weight, block.attn.qkv.bias)
        qkv = qkv.reshape(3, 3601, 3, nh, hd)
        fc1 = heads.affine(block.mlp.fc1, h, dtype)
        k = cfg.mlp_hidden // world
        for rank, (h0, h1) in enumerate(tp.head_groups(nh, world)):
            p = tp.tp_rank_slice(tp.tp_pack_block(block, cfg), cfg, rank,
                                 world)
            got = tp.qkv_local(p, h).reshape(3, 3601, h1 - h0, 3, hd)
            assert torch.equal(got, qkv[:, :, :, h0:h1].permute(0, 1, 3, 2,
                                                                4)), rank
            assert torch.equal(tp.fc1_local(p, h),
                               fc1[..., rank * k:(rank + 1) * k]), rank


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world", [2, 4])
def test_tp_row_parallel_sum_on_card(cuda, dtype, world):
    """The ranks' float32 proj and fc2 partials, summed with the float32
    bias, against the single-rank layer's float32 output on the same
    inputs: the same products added in another order."""
    from dino_tpu_torch.parallel import tp
    cfg, block, x = _tp_block(cuda, dtype)
    nh, hd = cfg.num_heads, cfg.head_dim
    k = cfg.mlp_hidden // world
    h1 = torch.randn(3, 3601, cfg.mlp_hidden, device=cuda).to(dtype)
    with torch.no_grad():
        want = {"proj": heads.affine(block.attn.proj, x),
                "fc2": heads.affine(block.mlp.fc2, h1)}
        got = {"proj": block.attn.proj.bias.float().clone(),
               "fc2": block.mlp.fc2.bias.float().clone()}
        for rank, (h0, h1_) in enumerate(tp.head_groups(nh, world)):
            p = tp.tp_rank_slice(tp.tp_pack_block(block, cfg), cfg, rank,
                                 world)
            if h1_ > h0:
                got["proj"] = got["proj"] + heads.affine_t(
                    x[..., h0 * hd:h1_ * hd], p["proj_w"], None)
            got["fc2"] = got["fc2"] + heads.affine_t(
                h1[..., rank * k:(rank + 1) * k], p["fc2_w"], None)
    for name in ("proj", "fc2"):
        err = (got[name] - want[name]).abs().max().item()
        assert err <= 1e-5 * want[name].abs().max().item(), (name, err)


_PP_RANK = """
import json, sys
import torch
import torch.distributed as dist
cfg = json.loads(sys.argv[1])
from dino_tpu_torch import DINOSeg
from dino_tpu_torch.ops import attention as tatt
from dino_tpu_torch.parallel import dist as pd
from dino_tpu_torch.parallel import pipeline as pp
from dino_tpu_torch.train import loop as tloop
pd.init_distributed_mode("gloo", cfg["init"], cfg["world"], cfg["rank"])
m = DINOSeg(head="linear", n_blocks=4, n_classes=3, precision="fp32",
            random_init=True, seed=1, freeze_backbone=False)
vit, head, world = m.model.dino, m.model.clf, dist.group.WORLD
svit = pp.pp_shard_vit(vit, world)
opt = tloop.make_optimizer("adam", 1e-4)
step = pp.make_pp_1f1b_train_step(m.cfg, "linear", 3, opt, world,
                                  n_microbatches=2)
gen = torch.Generator().manual_seed(2)
x = torch.randint(0, 255, (2, 64, 64, 3), generator=gen, dtype=torch.uint8)
y = torch.randint(0, 3, (2, 64), generator=gen, dtype=torch.int32)
before = (tatt.flash_attention.launches, tatt.flash_attention_bwd.launches)
loss, _ = step(svit, head, tloop.init_opt_state(opt, svit, head, False),
               x.cuda(), y.cuda())
launches = [tatt.flash_attention.launches - before[0],
            tatt.flash_attention_bwd.launches - before[1]]
grads = pp.pp_gather_state(svit, vit, world, grads=True)
grads.update({"head." + k: p.grad for k, p in head.named_parameters()})
torch.save({"loss": loss.item(), "launches": launches,
            "grads": {k: v.cpu() for k, v in grads.items()}}, cfg["out"])
"""


def test_pp_1f1b_step_over_two_ranks_on_card(cuda, tmp_path):
    """One fp32 1F1B step (4 blocks, 2 stages, 2 microbatches) over two gloo
    ranks sharing the card: each rank launches 2 x 2 x 2 forwards (slot
    and recompute) and 2 x 2 backwards, and the loss and every gradient
    leaf are the card's world-of-one step's (chip_smoke's STEP_* rules)."""
    from tests.test_torch_port_multiprocess import spawn_ranks
    outs = [torch.load(o) for o in spawn_ranks(tmp_path, 2, _PP_RANK, {},
                                               tag="pp")]
    m = DINOSeg(head="linear", n_blocks=4, n_classes=3, precision="fp32",
                random_init=True, seed=1, freeze_backbone=False)
    vit, head = m.model.dino, m.model.clf
    opt = tloop.make_optimizer("adam", 1e-4)
    gen = torch.Generator().manual_seed(2)
    x = torch.randint(0, 255, (2, 64, 64, 3), generator=gen,
                      dtype=torch.uint8)
    y = torch.randint(0, 3, (2, 64), generator=gen, dtype=torch.int32)
    loss, _ = tloop.make_train_step(m.cfg, "linear", 3, opt, False)(
        vit, head, tloop.init_opt_state(opt, vit, head, False), x.to(cuda),
        y.to(cuda))
    want = {k: p.grad.cpu() for k, p in vit.named_parameters()}
    want.update({"head." + k: p.grad.cpu()
                 for k, p in head.named_parameters()})
    for out in outs:
        assert out["launches"] == [8, 4]
        assert abs(out["loss"] - loss.item()) <= (
            chip_smoke.STEP_LOSS_RTOL * abs(loss.item()))
        for k, g in want.items():
            err = (out["grads"][k] - g).abs().max().item()
            assert err <= chip_smoke.STEP_GRAD_REL * g.abs().max().item(), k


# ---------------------------------------------------------------------------
# one process over several cards (chip_smoke.py phase 16)
# ---------------------------------------------------------------------------

def _cards_model(precision="fp32", res=240):
    model = DINOSeg(head="mlp", n_blocks=2, n_classes=7, precision=precision,
                    random_init=True, seed=16)
    model.set_resolution(res)
    return model


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_batch_split_on_one_card_equals_the_program(cuda, precision):
    """Phase 16 (a): the batch split with two chunks on card 0 gives the
    one-card program's bits at batch B/2 on each chunk."""
    from dino_tpu_torch.api import collect_labels
    from dino_tpu_torch.serving import predict_program
    model = _cards_model(precision)
    frames = _serve_frames(4, 16)
    zero = tatt.flash_attention.launches
    got = collect_labels(model._launch_split(torch.from_numpy(frames),
                                             [cuda] * 2))
    assert tatt.flash_attention.launches == zero + 2 * 2
    program = predict_program(model, 2, (240, 320))
    np.testing.assert_array_equal(got, np.concatenate(
        [program(c) for c in np.split(frames, 2)]))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_sp_ring_on_one_card_matches_one_card(cuda, precision):
    """Phase 16 (a): the in-process ring with two shards on card 0 (kernel
    5 on every hop, no fused MLP) against the one-card forward: fp32
    labels equal except near ties, log-probs within SP_FWD_TOL."""
    model = _cards_model(precision, res=480)
    frames = _serve_frames(1, 17)
    before = tatt.flash_attention_with_lse_dyn.launches
    mlp = tfm.fused_ln_mlp_residual.launches
    rec, _ = chip_smoke.sp_check(model, [model.model] * 2, frames, precision,
                              "test")
    assert tatt.flash_attention_with_lse_dyn.launches == before + 2 * 2 * 2
    assert tfm.fused_ln_mlp_residual.launches == mlp + (
        2 if precision == "bf16" else 0)  # the one-card forward's
    if precision == "fp32":
        assert rec["patches_differing_away_from_near_ties"] == 0
        assert rec["logp_within_sp_fwd_tol"]


def test_artifact_for_more_cards_is_refused(cuda, tmp_path):
    """Phase 16 (a): an artifact for more cards than the process has raises
    dino_tpu's ValueError at load."""
    from dino_tpu_torch import export_predict, load_exported_predict
    n = torch.cuda.device_count() + 1
    path = str(tmp_path / "many.dtts")
    export_predict(_cards_model(), path, batch_size=n, in_shape=(240, 320),
                   n_devices=n)
    with pytest.raises(ValueError, match=f"exported for {n} devices"):
        load_exported_predict(path)


def test_device_trace_names_the_flash_kernel(cuda, tmp_path):
    """Phase 16 (a): utils/profiling.py:device_trace around one predict
    writes a Chrome trace that names the bf16 flash forward."""
    names = chip_smoke.trace_names_flash(_cards_model("bf16"),
                                         _serve_frames(1, 18)[0],
                                         str(tmp_path))
    assert any("flash_fwd_bf16" in k for k in names), names


@pytest.mark.parametrize("parallelism", [None, "sp"])
def test_artifact_over_two_cards(cuda, tmp_path, parallelism):
    """Phase 16 (b), with two cards or more: the DP artifact gives the
    one-card program's bits; the SP artifact the one-card labels except
    near ties."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from dino_tpu_torch import export_predict, load_exported_predict
    from dino_tpu_torch.serving import predict_program
    model = _cards_model()
    frames = _serve_frames(4 if parallelism is None else 1, 19)
    path = str(tmp_path / "two.dtts")
    export_predict(model, path, batch_size=len(frames), in_shape=(240, 320),
                   n_devices=2, parallelism=parallelism)
    served = load_exported_predict(path)
    assert [d.index for d in served.devices] == [0, 1]
    if parallelism is None:
        program = predict_program(model, 2, (240, 320))
        np.testing.assert_array_equal(served(frames), np.concatenate(
            [program(c) for c in np.split(frames, 2)]))
    else:
        rec, _ = chip_smoke.sp_check(model, served.replicas, frames, "fp32",
                                  "test")
        assert rec["patches_differing_away_from_near_ties"] == 0
