"""The rank grids of tensor and pipeline parallelism, and state sharding
over the ranks of a process group: ZeRO-1 and FSDP.

:func:`make_grid` is the counterpart of ``dino_tpu/parallel/mesh.py``'s
``make_mesh(n, model_axis)``: the (data, model) groups of a world, tensor
parallel partners on consecutive ranks; with ``stage`` the (data, stage,
model) groups of the 3-D grid.

The counterpart of ``dino_tpu/parallel/mesh.py``'s ``zero_constrain``,
``fsdp_spec``, ``fsdp_place`` and ``gather_if_sharded``.  The JAX package
pins sharding constraints and lets GSPMD place the collectives; the port
writes them by hand, one process per card.

Layout: each tensor is flattened and cut into ``world`` equal shards of
s = ceil(n / world) elements; rank r holds elements [r*s, (r+1)*s), the
last shard zero-padded.  Any tensor shards, whatever its shape, so every
rank's resident bytes per tensor are s elements.

  * :class:`FlatShards` holds a list of tensors as shards: ``release``
    drops the full tensors' storage, ``gather`` all-gathers them back.
  * :class:`ShardedOptimizer` wraps a ``torch.optim`` optimizer built over
    the full parameters and moves it onto their shards (each shard keeps
    its parameter's group, so a weight-decay mask follows each element):
    ``step`` slices the (already summed) gradients to this rank's shards,
    updates the shards and then all-gathers the parameters (ZeRO-1,
    ``fsdp=False``) or drops them until the next ``gather`` (FSDP,
    ``fsdp=True``).  The update is elementwise, so ZeRO-1 gives the plain
    optimizer's bits on the same gradients.  ``state_dict`` and
    ``load_state_dict`` speak the plain optimizer's layout (every moment
    whole), so resume files do not depend on the world; both are
    collectives.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from dino_tpu_torch.parallel.dist import (all_gather_flat, all_reduce_sum_,
                                          get_rank, get_world_size,
                                          is_dist_avail_and_initialized)


def make_grid(model: int, group=None, stage: Optional[int] = None):
    """(data group, model group) of this rank on the (data, model) grid of
    ``group``'s ranks (the default group when None): the counterpart of
    ``dino_tpu``'s ``make_mesh(n, model_axis=model)``, whose grid is
    ``devices.reshape(n // model, model)``.  Group rank r sits at data index
    r // model and model index r % model, so tensor-parallel partners are
    consecutive ranks.

    With ``stage`` (S), the 3-D grid of pipeline x tensor parallelism:
    (data group, stage group, model group) on ``np.array(ranks).reshape(D,
    S, T)`` with axes ("data", "stage", "model"), rank r = (d*S + s)*T + t.

    A collective: ``dist.new_group`` is one, so every rank of ``group``
    calls this at the same point and creates every group of the grid, its
    own or not, in the same order.  Without ``torch.distributed`` (a world
    of one) every group is None."""
    world = get_world_size(group)
    n_stage = stage or 1
    if model < 1 or n_stage < 1 or world % (model * n_stage):
        raise ValueError(f"{world} ranks not divisible by stage x model axes "
                         f"({n_stage} x {model})")
    if not is_dist_avail_and_initialized():
        return (None, None) if stage is None else (None, None, None)
    ranks = (list(range(world)) if group in (None, dist.group.WORLD)
             else dist.get_process_group_ranks(group))
    n_data = world // (n_stage * model)

    def at(d, s, t):
        return ranks[(d * n_stage + s) * model + t]
    data = [[dist.new_group([at(d, s, t) for d in range(n_data)])
             for t in range(model)] for s in range(n_stage)]
    stages = ([[dist.new_group([at(d, s, t) for s in range(n_stage)])
                for t in range(model)] for d in range(n_data)]
              if stage is not None else None)
    tensor = [[dist.new_group([at(d, s, t) for t in range(model)])
               for s in range(n_stage)] for d in range(n_data)]
    d, rest = divmod(get_rank(group), n_stage * model)
    s, t = divmod(rest, model)
    if stage is None:
        return data[s][t], tensor[d][s]
    return data[s][t], stages[d][t], tensor[d][s]


class FlatShards:
    """``tensors`` as flat shards over ``group`` (see the module's
    docstring).  The shards are leaf tensors of s elements on the tensors'
    device; the full tensors start materialized."""

    def __init__(self, tensors: Sequence[torch.Tensor], group=None):
        self.tensors = list(tensors)
        self.group = group
        self.world, self.rank = get_world_size(group), get_rank(group)
        self.shapes = [t.shape for t in self.tensors]
        self.numels = [t.numel() for t in self.tensors]
        self.sizes = [-(-n // self.world) for n in self.numels]
        self.index = {id(t): i for i, t in enumerate(self.tensors)}
        self.shards = [torch.zeros(s, dtype=t.dtype, device=t.device)
                       for t, s in zip(self.tensors, self.sizes)]
        self.materialized = True
        self.reshard()

    def local(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's zero-padded slice of tensor ``i``'s flat ``full``."""
        s, n = self.sizes[i], self.numels[i]
        lo, hi = min(self.rank * s, n), min((self.rank + 1) * s, n)
        out = torch.zeros(s, dtype=full.dtype, device=full.device)
        out[:hi - lo] = full.reshape(-1)[lo:hi]
        return out

    @torch.no_grad()
    def reshard(self) -> None:
        """Copy this rank's slice of every (materialized) tensor into its
        shard."""
        for i, t in enumerate(self.tensors):
            self.shards[i].copy_(self.local(i, t.detach()))

    def _gather_flat(self, shards: List[torch.Tensor]) -> List[torch.Tensor]:
        """All-gather a shard per tensor -> each tensor's full flat values,
        one collective per dtype."""
        out = [None] * len(shards)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, sh in enumerate(shards):
            by_dtype.setdefault(sh.dtype, []).append(i)
        for ids in by_dtype.values():
            flat = torch.cat([shards[i].reshape(-1) for i in ids])
            parts = all_gather_flat(flat, self.group)  # (world, len)
            off = 0
            for i in ids:
                s = self.sizes[i]
                out[i] = parts[:, off:off + s].reshape(-1)[:self.numels[i]]
                off += s
        return out

    @torch.no_grad()
    def gather(self) -> None:
        """Materialize every full tensor from the shards (a collective;
        every rank calls it at the same point).  A no-op when they are."""
        if self.materialized:
            return
        for t, full, shape in zip(self.tensors,
                                  self._gather_flat(self.shards),
                                  self.shapes):
            t.data = full.clone().view(shape)
        self.materialized = True

    @torch.no_grad()
    def push(self) -> None:
        """Write the gathered shards into the materialized tensors, in
        place (ZeRO-1's parameter all-gather after the update)."""
        for t, full in zip(self.tensors, self._gather_flat(self.shards)):
            t.data.copy_(full.view(t.shape))

    def release(self) -> None:
        """Drop the full tensors' storage; the shards stay."""
        for t in self.tensors:
            t.data = torch.empty(0, dtype=t.dtype, device=t.device)
            t.grad = None
        self.materialized = False

    def gathered(self, i: int, shard: torch.Tensor) -> torch.Tensor:
        """A shard-shaped tensor of tensor ``i`` (a moment) gathered whole
        and reshaped (a collective)."""
        parts = all_gather_flat(shard.reshape(-1), self.group)
        return parts.reshape(-1)[:self.numels[i]].view(self.shapes[i])

    def resident_bytes(self) -> int:
        """Bytes this rank holds for the tensors: the full storage where
        materialized, plus the shards."""
        full = sum(t.numel() * t.element_size() for t in self.tensors)
        return full + sum(s.numel() * s.element_size() for s in self.shards)


def gradient_norms(grads: Sequence[torch.Tensor], group=None
                   ) -> List[torch.Tensor]:
    """Each tensor's L2 norm over every rank's shard of it: the squared
    norms of the local shards summed over ``group`` in one all-reduce (the
    clip of a sharded leaf sees the whole leaf's norm)."""
    if not grads:
        return []
    sq = torch.stack([torch.square(g.float()).sum() for g in grads])
    all_reduce_sum_([sq], group)
    return list(torch.sqrt(sq).unbind(0))


class ShardedOptimizer:
    """A ``torch.optim`` optimizer moved onto flat shards of its parameters
    over ``group`` (see the module's docstring).

    ``param_groups`` are the inner optimizer's (over the shards; setting
    ``lr`` or ``weight_decay`` there works as on the plain optimizer),
    ``params`` the full parameters in the plain optimizer's order.
    ``fsdp=True`` drops the full parameters after each ``step``; call
    :meth:`gather` before the next forward (the train steps do).
    """

    def __init__(self, opt: torch.optim.Optimizer, group=None,
                 fsdp: bool = False):
        if opt.state:
            raise ValueError("shard an optimizer before its first step")
        self.params = [p for g in opt.param_groups for p in g["params"]]
        self.shards = FlatShards(self.params, group)
        self.fsdp = fsdp
        # tensors sharded in step with the parameters (the DINO teacher),
        # gathered and dropped with them
        self.followers: List[FlatShards] = []
        by_id = {id(p): sh for p, sh in zip(self.params, self.shards.shards)}
        for g in opt.param_groups:
            g["params"] = [by_id[id(p)] for p in g["params"]]
        self.inner = opt

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def group(self):
        return self.shards.group

    def shard_of(self, p: torch.Tensor) -> torch.Tensor:
        return self.shards.shards[self.shards.index[id(p)]]

    def gather(self) -> None:
        for sh in [self.shards] + self.followers:
            sh.gather()

    def release(self) -> None:
        """FSDP: drop the full parameters (and the followers'); the
        shards stay.  A no-op under ZeRO-1."""
        if self.fsdp:
            for sh in [self.shards] + self.followers:
                sh.release()

    def reshard(self) -> None:
        """Re-cut the shards from the materialized full tensors (after a
        restore wrote into them)."""
        for sh in [self.shards] + self.followers:
            sh.reshard()

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def shard_grads(self) -> List[torch.Tensor]:
        """Move each parameter's full gradient (the same on every rank:
        summed over the data ranks, or computed on the full batch) to this
        rank's shard of it, and the parameter's values to its shard; the
        full gradients are dropped.  Returns the shard gradients."""
        self.shards.reshard()
        out = []
        for i, (p, sh) in enumerate(zip(self.params, self.shards.shards)):
            g = (p.grad if p.grad is not None
                 else torch.zeros(self.shards.shapes[i], dtype=p.dtype,
                                  device=sh.device))
            sh.grad = self.shards.local(i, g)
            p.grad = None
            out.append(sh.grad)
        return out

    @torch.no_grad()
    def step(self, grads_sharded: bool = False) -> None:
        """One update of the shards from the full gradients (or, with
        ``grads_sharded``, from the shard gradients :meth:`shard_grads`
        left), then the parameters all-gathered (ZeRO-1) or dropped
        (FSDP)."""
        if not grads_sharded:
            self.shard_grads()
        self.inner.step()
        if self.fsdp:
            self.release()
        else:
            self.shards.push()

    def state_dict(self) -> dict:
        """The plain optimizer's state dict: each moment gathered whole
        (a collective)."""
        sd = self.inner.state_dict()
        state = {}
        for idx, st in sd["state"].items():
            s = self.shards.sizes[idx]
            state[idx] = {
                k: (self.shards.gathered(idx, v)
                    if torch.is_tensor(v) and v.dim() == 1
                    and v.numel() == s else v)
                for k, v in st.items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, sd: dict) -> None:
        """Load a plain optimizer's state dict (whole moments), each moment
        cut to this rank's shard."""
        state = {}
        for idx, st in sd["state"].items():
            idx = int(idx)
            state[idx] = {
                k: (self.shards.local(idx, v.reshape(-1))
                    if torch.is_tensor(v) and v.dim() > 0
                    and v.numel() == self.shards.numels[idx] else v)
                for k, v in st.items()}
        inner = self.inner.state_dict()
        inner["state"] = state
        self.inner.load_state_dict(inner)

    def resident_bytes(self) -> Dict[str, int]:
        """This rank's bytes of parameters (full storage where materialized,
        plus the shards), gradients and optimizer moments."""
        grads = sum(t.grad.numel() * t.grad.element_size()
                    for t in self.params + self.shards.shards
                    if t.grad is not None)
        moments = sum(v.numel() * v.element_size()
                      for st in self.inner.state.values()
                      for v in st.values() if torch.is_tensor(v)
                      and v.dim() > 0)
        return {"params": self.shards.resident_bytes(), "grads": grads,
                "moments": moments}


def optimizer_params(opt) -> List[torch.Tensor]:
    """The full parameters an optimizer (plain or sharded) updates."""
    if isinstance(opt, ShardedOptimizer):
        return list(opt.params)
    return [p for g in opt.param_groups for p in g["params"]]


def materialize(opt) -> None:
    """Gather a sharded optimizer's parameters before a forward (a
    collective under FSDP; a no-op otherwise)."""
    if isinstance(opt, ShardedOptimizer):
        opt.gather()
