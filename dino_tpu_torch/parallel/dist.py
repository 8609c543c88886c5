"""Multi-process runtime over ``torch.distributed``: rank discovery, the
collectives of sequence and data parallelism, and the agreement helpers of
training over ranks.

The counterpart of ``dino_tpu/parallel/dist.py`` (which feeds
``jax.distributed``): rank discovery from RANK / WORLD_SIZE / MASTER_ADDR,
NCCL for a CUDA device and gloo for the CPU.  Where the JAX package writes
``ppermute`` / ``psum`` / ``all_gather`` inside ``shard_map`` or lets GSPMD
place them, the port calls :func:`ring_shift` (sequence parallelism's
ring), :func:`stage_hop` (a pipeline's two rings), :func:`all_reduce_sum_`
(any dtype: float gradients, int64 confusion matrices),
:func:`all_gather_seq`, :func:`all_gather_flat` and :class:`GroupSum` (a
sum whose backward is the same sum) on a process group; tensor
parallelism's two operators are :class:`CopyToGroup` (Megatron's f) and
:class:`SumFromGroup` (g).

``agree_across_hosts``, ``any_across_hosts`` and ``reduce_dict`` gather
every rank's value on every rank (so a disagreement raises on every rank,
the writer included), and :func:`barrier` publishes rank 0's files: the
decisions ``fit`` and the pretrain CLI must take in lockstep.

Under a gloo group the collectives stage CUDA tensors through host copies:
gloo's send/recv and all_gather take CPU tensors only, and NCCL refuses two
ranks on one device, so this is how several ranks share one card (the
kernels still run on the card).  gloo has no reduce-scatter: a sum that
lands in shards is :func:`all_reduce_sum_` and a slice, on either backend,
so NCCL and gloo give the same sums.
"""
from __future__ import annotations

import builtins
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch
import torch.distributed as dist


def init_distributed_mode(backend: Optional[str] = None,
                          init_method: Optional[str] = None,
                          world_size: Optional[int] = None,
                          rank: Optional[int] = None) -> None:
    """Initialize the default process group.

    Rank discovery mirrors the JAX package: explicit arguments, else env
    RANK / WORLD_SIZE (then SLURM_PROCID), and the rendezvous at
    MASTER_ADDR:MASTER_PORT (port 12355 by default) unless ``init_method``
    (``tcp://host:port`` or ``file:///path``) is given.  ``backend=None``
    picks NCCL when there is a CUDA device and gloo otherwise; with NCCL the
    process takes card ``rank % device_count``.
    """
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", os.environ.get("SLURM_PROCID", "0")))
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        init_method = f"tcp://{addr}:{os.environ.get('MASTER_PORT', '12355')}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def is_dist_avail_and_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if is_dist_avail_and_initialized() else 1


def get_rank(group=None) -> int:
    return dist.get_rank(group) if is_dist_avail_and_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def save_on_master(save_fn, *args, **kwargs):
    """Run a save callback only on rank 0 (the reference's
    ``save_on_master``); None elsewhere."""
    if is_main_process():
        return save_fn(*args, **kwargs)
    return None


def setup_for_distributed(is_master: bool) -> None:
    """Silence ``print`` on every rank but the master, unless a call passes
    ``force=True``."""
    builtin_print = builtins.print

    def print_(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            builtin_print(*args, **kwargs)

    builtins.print = print_


def _staged(group) -> bool:
    """Whether this group's collectives need CPU tensors (gloo)."""
    return dist.get_backend(group) == "gloo"


def _peer(group, group_rank: int) -> int:
    """The global rank of ``group_rank`` in ``group``."""
    if group is None or group is dist.group.WORLD:
        return group_rank
    return dist.get_global_rank(group, group_rank)


def ring_shift(tensors: Sequence[torch.Tensor], group=None
               ) -> List[torch.Tensor]:
    """Send ``tensors`` to rank+1 and receive rank-1's, around the ring.

    The tensors travel as one byte buffer, with one send and one receive
    posted together in ``batch_isend_irecv`` (a ring of blocking sends
    would deadlock).  Returns new contiguous tensors of the same shapes,
    dtypes and device; a world of one returns the inputs.
    """
    d = get_world_size(group)
    if d == 1:
        return list(tensors)
    me = dist.get_rank(group)
    device = tensors[0].device
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])
    if _staged(group):
        flat = flat.cpu()
    recv = torch.empty_like(flat)
    ops = [dist.P2POp(dist.isend, flat, _peer(group, (me + 1) % d), group),
           dist.P2POp(dist.irecv, recv, _peer(group, (me - 1) % d), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    recv = recv.to(device)
    out, offset = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        out.append(recv[offset:offset + nbytes].view(t.dtype).reshape(t.shape))
        offset += nbytes
    return out


def stage_hop(fwd: Optional[torch.Tensor], bwd: Optional[torch.Tensor],
              group=None) -> Tuple[Optional[torch.Tensor],
                                   Optional[torch.Tensor]]:
    """One tick of a pipeline's two rings over ``group``, the counterpart
    of ``lax.ppermute`` over the stage axis: ``fwd`` (activations) goes to
    rank+1 and rank-1's arrives, ``bwd`` (cotangents) goes to rank-1 and
    rank+1's arrives, both rings wrapping between the last rank and the
    first as the JAX ring does.  The tick's sends and receives, both
    directions, are posted together in one ``batch_isend_irecv``.  A
    direction passed as None is not posted: every rank of the group must
    leave out the same one.  Returns (received fwd, received bwd), new
    tensors of the inputs' shapes, dtypes and devices; a world of one
    returns the inputs (the ring of one rank sends to itself)."""
    d = get_world_size(group)
    if d == 1:
        return fwd, bwd
    me = dist.get_rank(group)
    ops, recvs = [], []
    for tag, (t, dst, src) in enumerate(((fwd, me + 1, me - 1),
                                         (bwd, me - 1, me + 1))):
        if t is None:
            recvs.append(None)
            continue
        flat = t.contiguous().reshape(-1).view(torch.uint8)
        if _staged(group):
            flat = flat.cpu()
        recv = torch.empty_like(flat)
        # with 2 ranks both directions pair the same two ranks: the tags
        # (gloo) and the posting order (NCCL) keep the rings apart
        ops += [dist.P2POp(dist.isend, flat, _peer(group, dst % d), group,
                           tag),
                dist.P2POp(dist.irecv, recv, _peer(group, src % d), group,
                           tag)]
        recvs.append((recv, t))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(None if r is None else
                 r[0].to(r[1].device).view(r[1].dtype).reshape(r[1].shape)
                 for r in recvs)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor over the group, in place; one all-reduce per dtype."""
    if get_world_size(group) == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        if _staged(group):
            flat = flat.cpu()
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat.to(ts[0].device)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_gather_seq(t: torch.Tensor, group=None, dim: int = 1) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` in rank order (the
    gather of a token-sharded sequence)."""
    d = get_world_size(group)
    if d == 1:
        return t
    src = t.contiguous()
    if _staged(group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(d)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_gather_flat(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's 1-D ``t`` (the same length on every rank) stacked in
    rank order: (world, len), on ``t``'s device."""
    d = get_world_size(group)
    if d == 1:
        return t[None]
    src = t.contiguous()
    if _staged(group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(d)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


class GroupSum(torch.autograd.Function):
    """Sum over the group, whose transpose is the same sum: the forward and
    the backward each all-reduce (the JAX ``psum`` under ``grad``)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        all_reduce_sum_([out], group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce_sum_([g], ctx.group)
        return g, None


class CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity forward, an all-reduce backward.  It goes
    on the input of a column-parallel layer (qkv, fc1): each rank's
    gradient of the input covers only its own output columns, and the sum
    over the group is the whole gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce_sum_([g], ctx.group)
        return g, None


class SumFromGroup(torch.autograd.Function):
    """Megatron's g: an all-reduce forward, the identity backward.  It goes
    on the output of a row-parallel layer (proj, fc2): the sum is the same
    on every rank, and so is its cotangent, which each rank's partial takes
    whole."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        all_reduce_sum_([out], group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(t: torch.Tensor, group=None) -> torch.Tensor:
    """:class:`CopyToGroup` where autograd needs it, else ``t``."""
    if (get_world_size(group) > 1 and torch.is_grad_enabled()
            and t.requires_grad):
        return CopyToGroup.apply(t, group)
    return t


def sum_from_group(t: torch.Tensor, group=None) -> torch.Tensor:
    """:class:`SumFromGroup` where autograd needs it; otherwise ``t`` summed
    over the group in place (the caller's partial) and returned."""
    if get_world_size(group) == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return SumFromGroup.apply(t, group)
    all_reduce_sum_([t], group)
    return t


def barrier(group=None) -> None:
    """Every rank waits here for every other (a no-op in a world of one)."""
    if get_world_size(group) > 1:
        dist.barrier(group=group)


def _gather_host(values: np.ndarray) -> np.ndarray:
    """(world, *values.shape): every rank's host array, on every rank."""
    t = torch.from_numpy(np.ascontiguousarray(values).reshape(-1))
    if dist.get_backend() == "nccl":
        t = t.cuda()
    return all_gather_flat(t).cpu().numpy().reshape(
        (get_world_size(),) + values.shape)


def agree_across_hosts(name: str, value) -> np.ndarray:
    """Gather every rank's ``value`` (as float32, as the JAX package's
    gather rounds it) and raise on EVERY rank if any rank's differs from
    rank 0's; returns rank 0's value.

    Rank 0 alone writes resume and checkpoint files, so on a filesystem
    that is not shared the other ranks would start from another state.  A
    broadcast would let rank 0 compare its value with itself and walk on
    into a collective that never completes; with the gather every rank,
    the writer included, sees the disagreement.
    """
    local = np.atleast_1d(np.asarray(value, np.float32))
    if get_world_size() < 2:
        return local
    gathered = _gather_host(local)
    bad = [r for r in range(gathered.shape[0])
           if not np.array_equal(gathered[r], gathered[0])]
    if bad:
        raise RuntimeError(
            f"hosts disagree on {name} (this is rank {get_rank()}; ranks "
            f"{bad} differ from rank 0: "
            f"{ {r: gathered[r].tolist() for r in [0] + bad} }): training "
            "over ranks needs a filesystem that every rank shares")
    return gathered[0]


def any_across_hosts(flag: bool) -> bool:
    """True on every rank iff ``flag`` is set on any rank: a decision (a
    stop signal that reached one rank first) taken at the same step
    everywhere.  Every rank must call it at the same point."""
    if get_world_size() < 2:
        return bool(flag)
    return bool(_gather_host(np.atleast_1d(np.int32(bool(flag)))).any())


def reduce_dict(input_dict: Dict[str, float], average: bool = True
                ) -> Dict[str, float]:
    """Sum (or average) a dict of scalars over the ranks, in float64."""
    world = get_world_size()
    if world < 2:
        return dict(input_dict)
    names = sorted(input_dict)
    values = np.array([float(input_dict[k]) for k in names], np.float64)
    total = _gather_host(values).sum(axis=0)
    if average:
        total = total / world
    return {k: float(v) for k, v in zip(names, total)}
