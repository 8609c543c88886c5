"""FSDP's units (dino_tpu_torch/parallel/mesh.py) on the CPU, in one
process: the flat layout over two and three ranks, and the unit-by-unit
forward and steps against the port's plain ones, which the port's other
tests hold to dino_tpu (tests/test_torch_port_dp.py and
test_torch_port_dp_pretrain.py hold FSDP over two ranks to dino_tpu).

A small ViT (D=64, 2 heads of hd=32, depth 2) at 32px with an MLP or MoE
head, and a DINO head of out_dim 16; weights and data made from seeds.
With no process group a unit's all-gather and reduce-scatter are the
identity, so a world of one runs every line of the unit code but the
collectives, which the two-rank worlds run.  The layout over several
ranks is checked by cutting every rank's shard in this process.
"""
import copy

import numpy as np
import pytest
import torch

from dino_tpu_torch.models import vit as tvit
from dino_tpu_torch.models.heads import init_head
from dino_tpu_torch.parallel import mesh
from dino_tpu_torch.train import dino_pretrain as tdp
from dino_tpu_torch.train import loop as tloop

D = 64
TCFG = tvit.ViTConfig(patch_size=8, embed_dim=D, num_heads=2, depth=2)
DINO = tdp.DinoConfig(out_dim=16, n_local_crops=2, global_size=32,
                      local_size=16, hidden_dim=32, bottleneck_dim=8)


def _vit(seed=0):
    vit = tvit.VisionTransformer(TCFG)
    return tvit.init_vit_params(vit, torch.Generator().manual_seed(seed))


def _images(seed, n=2, res=32):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        n, res, res, 3).astype(np.float32))


@pytest.mark.parametrize("world", [2, 3])
def test_ranks_shards_tile_the_padded_flat_buffer(monkeypatch, world):
    """Each rank's shard is one contiguous, equal slice of the unit's
    tensors flattened and concatenated, zero-padded at the end; each
    parameter's pieces over the ranks are its elements in order."""
    vit = _vit()
    params = list(vit.blocks[0].parameters()) + [vit.cls_token]
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    size = -(-flat.numel() // world)
    shards, pieces = [], []
    for rank in range(world):
        monkeypatch.setattr(mesh, "get_world_size", lambda g=None: world)
        monkeypatch.setattr(mesh, "get_rank", lambda g=None, r=rank: r)
        unit = mesh.FlatUnit("u", [copy.deepcopy(p) for p in params], None,
                             "cpu", mesh.UnitBook())
        assert unit.size == size and unit.shard.numel() == size
        assert all(p.numel() == 0 for p in unit.params)  # freed
        shards.append(unit.shard)
        pieces.append([unit.piece(i) for i in range(len(params))])
    padded = torch.cat(shards)
    assert padded.numel() == world * size
    assert torch.equal(padded[:flat.numel()], flat)
    assert not padded[flat.numel():].any()
    for i, p in enumerate(params):
        whole = torch.cat([pieces[r][i] for r in range(world)])
        assert torch.equal(whole, p.detach().reshape(-1))


def test_unit_forward_is_vit_forwards():
    """vit_forward_units over two resolution groups: the port's
    vit_forward of each group, bit for bit (tests/test_torch_port_vit.py
    holds that to dino_tpu's), all tokens or the CLS rows; every unit
    freed after its use."""
    vit = _vit(0)
    plain = copy.deepcopy(vit)
    opt = torch.optim.Adam(vit.parameters())
    fs = mesh.FSDPOptimizer(opt, None, tvit.vit_units(vit))
    xs = [_images(1, 2, 32), _images(2, 3, 16)]
    with torch.no_grad():
        got = tvit.vit_forward_units(vit, [xs], TCFG, fs)[0]
        cls = tvit.vit_forward_units(vit, [xs], TCFG, fs,
                                     all_tokens=False)[0]
    for x, g, c in zip(xs, got, cls):
        assert torch.equal(g, tvit.vit_forward(plain, x, TCFG))
        assert torch.equal(c, tvit.vit_forward(plain, x, TCFG,
                                               all_tokens=False))
    assert fs.book.gathered == 0
    assert fs.book.peak_gathered == max(u.full_bytes for u in fs.units)


def test_unit_backward_gives_autograd_bits_one_unit_at_a_time():
    """The recomputing backward leaves each unit's shard gradient with
    plain autograd's bits; a unit is gathered twice a use (forward,
    backward), the root's two uses reduce twice, and no more than one
    unit's parameters or gradient is full at once."""
    vit = _vit()
    plain = copy.deepcopy(vit)
    x = _images(3)
    tvit.vit_forward(plain, x, TCFG).square().sum().backward()
    fs = mesh.FSDPOptimizer(torch.optim.Adam(vit.parameters()), None,
                            tvit.vit_units(vit))
    tvit.vit_forward_units(vit, [[x]], TCFG, fs)[0][0].square().sum() \
        .backward()
    for p, g in zip(plain.parameters(), fs.gathered_grads()):
        assert torch.equal(p.grad, g)
    biggest = max(u.full_bytes for u in fs.units)
    assert fs.book.peak_gathered == biggest
    assert fs.book.peak_grads == biggest
    assert fs.book.gathers == 2 * (2 + TCFG.depth)
    assert fs.book.reduces == 2 + TCFG.depth
    assert fs.book.gathered == fs.book.grads == 0
    assert all(p.numel() == 0 for p in vit.parameters())


def test_microbatches_add_up_in_the_loops_order():
    """One unit run over two microbatches: a single gather a pass, one
    reduce, and the gradient a microbatch loop of plain autograd leaves
    in .grad (the first microbatch's, then the second's added), bit for
    bit."""
    vit = _vit()
    plain = copy.deepcopy(vit)
    xs = [_images(4), _images(5)]
    for x in xs:
        tvit.vit_forward(plain, x, TCFG).square().sum().backward()
    fs = mesh.FSDPOptimizer(torch.optim.Adam(vit.parameters()), None,
                            tvit.vit_units(vit))
    outs = tvit.vit_forward_units(vit, [[x] for x in xs], TCFG, fs)
    (outs[0][0].square().sum() + outs[1][0].square().sum()).backward()
    for p, g in zip(plain.parameters(), fs.gathered_grads()):
        assert torch.equal(p.grad, g)
    assert fs.book.gathers == 2 * (2 + TCFG.depth)
    assert fs.book.reduces == 2 + TCFG.depth


def _seg_model(head):
    return _vit(1), init_head(head, 3, D, torch.Generator().manual_seed(2))


@pytest.mark.parametrize("head", ["mlp", "moe"])
@pytest.mark.parametrize("accum", [1, 2])
def test_fsdp_train_step_has_the_plain_steps_bits(head, accum):
    """make_train_step over FSDP's units, two Adam steps with a ragged
    mask, then the eval step: the plain step's parameters, loss and
    confusion matrices, bit for bit (the MoE balance term runs inside the
    head's unit)."""
    outs = []
    for fsdp in (False, True):
        vit, clf = _seg_model(head)
        optimizer = tloop.make_optimizer("adam", 1e-3)
        opt = tloop.init_opt_state(optimizer, vit, clf, False)
        if fsdp:
            opt = mesh.FSDPOptimizer(opt, None, tloop.seg_units(vit, clf))
        step = tloop.make_train_step(TCFG, head, 3, optimizer, False,
                                     accum_steps=accum)
        rs = np.random.RandomState(2)
        x = torch.from_numpy(rs.randint(0, 255, (4, 32, 32, 3)).astype(
            np.uint8))
        y = torch.from_numpy(rs.randint(0, 3, (4, 16)).astype(np.int32))
        mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
        got = [t for _ in range(2) for t in step(vit, clf, opt, x, y, mask)]
        got.append(tloop.make_eval_step(TCFG, head, 3,
                                        fsdp=opt if fsdp else None)(
            vit, clf, x, y))
        if fsdp:
            assert opt.resident_bytes()["params"] == sum(
                u.size * 4 for u in opt.units)
            opt.gather()
        outs.append(got + [p.detach().clone() for p in
                           list(vit.parameters()) + list(clf.parameters())])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _dino_step(fsdp, clip):
    student, teacher = tdp.init_dino_params(
        torch.Generator().manual_seed(0), TCFG, DINO, device="cpu")
    opt = tdp.make_dino_optimizer(student)
    if fsdp:
        opt = tdp.shard_dino_state(student, teacher, opt, None)
    step = tdp.make_dino_train_step(TCFG, DINO, clip=clip)
    center = torch.zeros(1, DINO.out_dim)
    rs = np.random.RandomState(3)
    g = torch.from_numpy(rs.randint(0, 255, (2, 2, 32, 32, 3)).astype(
        np.uint8))
    l = torch.from_numpy(rs.randint(0, 255, (2, 2, 16, 16, 3)).astype(
        np.uint8))
    losses = [step(student, teacher, center, opt, g, l, 0.04, 0.9, 0.0)
              for _ in range(2)]
    if fsdp:
        grads = dict(zip(map(id, opt.params), opt.gathered_grads()))
        grads = [grads[id(p)] for p in student.parameters()]
        opt.to_host()
    else:
        grads = [p.grad for p in student.parameters()]
    return (losses, grads, [t.detach().clone() for t in
                            list(student.parameters())
                            + list(teacher.parameters())] + [center])


def test_fsdp_pretrain_step_is_the_plain_step():
    """The pretrain step over FSDP's units (student and teacher, each
    block running both resolution groups while gathered), the clip off:
    the plain step's losses, gradients and both models' bits.  (With the
    clip the norms come from the shards' squared sums: the two-rank CLI
    runs of test_torch_port_dp_pretrain.py hold that.)"""
    plain, fsdp = _dino_step(False, 1e9), _dino_step(True, 1e9)
    for a, b in zip(plain, fsdp):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_state_dict_is_the_plain_layout_and_restores():
    """state_dict gathers each moment whole (the plain optimizer's), and
    load_state_dict / from_host restore a step's state into fresh units
    that then step as the uninterrupted run does."""
    def run(steps, restore=None):
        vit = _vit()
        opt = torch.optim.AdamW(vit.parameters(), lr=1e-3)
        fs = mesh.FSDPOptimizer(opt, None, tvit.vit_units(vit))
        if restore is not None:
            fs.to_host(gather=False)
            vit.load_state_dict(restore[0])
            fs.from_host()
            fs.load_state_dict(restore[1])
        for i in steps:
            fs.zero_grad()
            tvit.vit_forward_units(vit, [[_images(10 + i)]], TCFG,
                                   fs)[0][0].square().sum().backward()
            fs.step()
        fs.to_host()
        state = ({k: v.clone() for k, v in vit.state_dict().items()},
                 fs.state_dict())
        fs.release()
        return state

    plain_vit = _vit()
    plain = torch.optim.AdamW(plain_vit.parameters(), lr=1e-3)
    for i in range(2):
        plain.zero_grad()
        tvit.vit_forward(plain_vit, _images(10 + i), TCFG).square().sum() \
            .backward()
        plain.step()
    one = run(range(2))
    want = plain.state_dict()["state"]
    assert set(one[1]["state"]) == set(want)
    for k, st in want.items():
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(one[1]["state"][k][name], st[name])
    for k, v in plain_vit.state_dict().items():
        assert torch.equal(one[0][k], v)
    resumed = run(range(1, 2), restore=run(range(1)))
    for k in one[0]:
        assert torch.equal(resumed[0][k], one[0][k])


def test_fsdp_refuses_what_it_cannot_shard():
    vit, clf = _seg_model("mlp")
    optimizer = tloop.make_optimizer("adam", 1e-3)
    group = torch.distributed.ProcessGroup.__new__(
        torch.distributed.ProcessGroup)
    with pytest.raises(ValueError, match="unfrozen ViT"):
        tloop.init_opt_state(optimizer, vit, clf, True, fsdp_mesh=group)
    for kw in (dict(freeze_backbone=True), dict(backbone="cnn1")):
        args = {"freeze_backbone": False, **kw}
        with pytest.raises(ValueError, match="unfrozen ViT"):
            tloop.make_train_step(TCFG, "mlp", 3, optimizer,
                                  fsdp_mesh=group, **args)
    with pytest.raises(ValueError, match="every optimized parameter"):
        mesh.FSDPOptimizer(
            optimizer(list(vit.parameters()) + list(clf.parameters())),
            None, tvit.vit_units(vit))
