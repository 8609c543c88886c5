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

ZeRO-1 (:class:`ShardedOptimizer`): each tensor is flattened and cut into
``world`` equal shards of s = ceil(n / world) elements; rank r holds
elements [r*s, (r+1)*s), the last shard zero-padded (:class:`FlatShards`).
The optimizer, built over the full parameters, is moved onto the shards
(each shard keeps its parameter's group, so a weight-decay mask follows
each element); ``step`` slices the (already summed) gradients to this
rank's shards, updates them and all-gathers the parameters.  The update is
elementwise, so ZeRO-1 gives the plain optimizer's bits on the same
gradients.

FSDP (:class:`FSDPOptimizer`): the parameters live in units
(:class:`FlatUnit`: a ViT block, the embeddings with the final norm, a
head), each one flat buffer of its tensors over the ranks, rank r keeping
one contiguous slice of equal size (the layout NCCL's
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` need).  Between
uses a parameter holds no storage.  :func:`run_unit` runs a function of
one unit over every microbatch of a step: it gathers the unit, runs,
frees it; under autograd it keeps only the function's inputs and, in its
backward, gathers the unit again, recomputes the function microbatch by
microbatch with the gradient on, takes each backward into one flat
gradient buffer (adding up in the order a microbatch loop adds ``.grad``)
and reduce-scatters that buffer into the unit's shard gradient, once a
step.  A step so holds at most one unit's full parameters and one unit's
full gradient at a time beside the shards, and its sums are plain DP's
where the ranks' sum is order-free (two ranks).  The optimizer runs on
each parameter's piece of this rank's shard, in its parameter's group.

Both optimizers' ``state_dict`` and ``load_state_dict`` speak the plain
optimizer's layout (every moment whole, on the host under FSDP), so resume
files do not depend on the world; both are collectives.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dino_tpu_torch.parallel.dist import (all_gather_flat, all_gather_into,
                                          all_reduce_sum_, get_rank,
                                          get_world_size,
                                          is_dist_avail_and_initialized,
                                          reduce_scatter_sum)


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
    """``tensors`` as flat shards of ceil(n / world) elements each over
    ``group`` (ZeRO-1's layout, see the module's docstring).  The shards
    are leaf tensors on the tensors' device."""

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
        """Copy this rank's slice of every tensor into its shard."""
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
    def push(self) -> None:
        """Write the gathered shards into the full tensors, in place
        (ZeRO-1's parameter all-gather after the update)."""
        for t, full in zip(self.tensors, self._gather_flat(self.shards)):
            t.data.copy_(full.view(t.shape))

    def gathered(self, i: int, shard: torch.Tensor) -> torch.Tensor:
        """A shard-shaped tensor of tensor ``i`` (a moment) gathered whole
        and reshaped (a collective)."""
        parts = all_gather_flat(shard.reshape(-1), self.group)
        return parts.reshape(-1)[:self.numels[i]].view(self.shapes[i])

    def resident_bytes(self) -> int:
        """Bytes this rank holds for the tensors: the full storage plus the
        shards."""
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


def _is_moment(v, n: int) -> bool:
    """Whether an optimizer state entry is a per-element moment of a
    tensor (or piece) of ``n`` elements (``step`` is 0-dim)."""
    return torch.is_tensor(v) and v.dim() > 0 and v.numel() == n


class ShardedOptimizer:
    """ZeRO-1: a ``torch.optim`` optimizer moved onto flat shards of its
    parameters over ``group`` (see the module's docstring).

    ``param_groups`` are the inner optimizer's (over the shards; setting
    ``lr`` or ``weight_decay`` there works as on the plain optimizer),
    ``params`` the full parameters in the plain optimizer's order; after
    each ``step`` every rank holds the updated full parameters.
    """

    def __init__(self, opt: torch.optim.Optimizer, group=None):
        if opt.state:
            raise ValueError("shard an optimizer before its first step")
        self.params = [p for g in opt.param_groups for p in g["params"]]
        self.shards = FlatShards(self.params, group)
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
    def step(self) -> None:
        """One update of the shards from the full gradients, then the
        parameters all-gathered."""
        self.shard_grads()
        self.inner.step()
        self.shards.push()

    def state_dict(self) -> dict:
        """The plain optimizer's state dict: each moment gathered whole
        (a collective)."""
        sd = self.inner.state_dict()
        state = {}
        for idx, st in sd["state"].items():
            s = self.shards.sizes[idx]
            state[idx] = {k: (self.shards.gathered(idx, v)
                              if _is_moment(v, s) else v)
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
                    if _is_moment(v, self.shards.numels[idx]) else v)
                for k, v in st.items()}
        inner = self.inner.state_dict()
        inner["state"] = state
        self.inner.load_state_dict(inner)

    def resident_bytes(self) -> Dict[str, int]:
        """This rank's bytes of parameters (full storage plus the shards),
        gradients and optimizer moments."""
        grads = sum(t.grad.numel() * t.grad.element_size()
                    for t in self.params + self.shards.shards
                    if t.grad is not None)
        return {"params": self.shards.resident_bytes(), "grads": grads,
                "moments": _moment_bytes(self.inner)}


def _moment_bytes(opt: torch.optim.Optimizer) -> int:
    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim() > 0)


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------

class UnitBook:
    """What a set of units holds at once, for the memory checks: full
    parameter bytes gathered on the device and full gradient bytes alive,
    now and at most since :meth:`reset`; ``sum_ranks`` says whether a
    unit's gradient is summed over the ranks (each rank ran its slab) or
    only sliced (every rank ran the whole batch)."""

    def __init__(self):
        self.sum_ranks = True
        self.gathered = self.grads = 0
        self.reset()

    def reset(self) -> None:
        self.peak_gathered, self.peak_grads = self.gathered, self.grads
        self.gathers = self.reduces = 0

    def add(self, gathered: int = 0, grads: int = 0) -> None:
        self.gathered += gathered
        self.grads += grads
        self.peak_gathered = max(self.peak_gathered, self.gathered)
        self.peak_grads = max(self.peak_grads, self.grads)

    def as_dict(self) -> Dict[str, int]:
        return {"peak_gathered_bytes": self.peak_gathered,
                "peak_grad_bytes": self.peak_grads,
                "gathers": self.gathers, "reduces": self.reduces}


class FlatUnit:
    """One FSDP unit: float32 parameters gathered together.  Their values,
    flattened in order and concatenated, zero-padded to ``world * size``
    elements, are one flat buffer; rank r keeps elements [r*size,
    (r+1)*size) as ``shard`` on ``device``.  Between uses every parameter's
    ``.data`` is an empty tensor; :meth:`gather` makes them views of the
    gathered buffer.  ``grad`` is this rank's shard of the unit's gradient
    (None until a backward reduced one)."""

    def __init__(self, name: str, params: Sequence[torch.Tensor], group,
                 device, book: UnitBook):
        self.name = name
        self.params = list(params)
        if any(p.dtype != torch.float32 for p in self.params):
            raise TypeError(f"FSDP unit {name}: float32 parameters only")
        self.group, self.book = group, book
        self.world, self.rank = get_world_size(group), get_rank(group)
        self.shapes = [p.shape for p in self.params]
        self.numels = [p.numel() for p in self.params]
        self.offsets = [sum(self.numels[:i]) for i in range(len(self.params))]
        self.size = -(-sum(self.numels) // self.world)
        self.device = torch.device(device)
        self.trainable = [p for p in self.params if p.requires_grad]
        # an input that makes run_unit's output require a gradient even
        # when no activation does (the patch embedding's)
        self.handle = torch.empty(0, requires_grad=True)
        self.shard = torch.zeros(self.size, device=self.device)
        self.grad: Optional[torch.Tensor] = None
        self.on_device = False
        self.load([p.detach() for p in self.params])
        self.free()

    @property
    def full_bytes(self) -> int:
        return self.world * self.size * 4

    def span(self, i: int):
        """(lo, hi): parameter ``i``'s elements in this rank's shard."""
        base = self.rank * self.size

        def clip(x):
            return min(max(x - base, 0), self.size)
        return (clip(self.offsets[i]),
                clip(self.offsets[i] + self.numels[i]))

    def piece(self, i: int) -> torch.Tensor:
        """Parameter ``i``'s piece of the shard: a view, possibly empty."""
        lo, hi = self.span(i)
        return self.shard[lo:hi]

    @torch.no_grad()
    def load(self, tensors: Sequence[torch.Tensor]) -> None:
        """Cut this rank's slice of the full ``tensors`` (any device) into
        the shard."""
        self.shard.zero_()
        base = self.rank * self.size
        for i, t in enumerate(tensors):
            lo, hi = self.span(i)
            if lo < hi:
                a = base + lo - self.offsets[i]
                self.shard[lo:hi].copy_(t.reshape(-1)[a:a + hi - lo])

    def _bind(self, full: torch.Tensor) -> None:
        for p, off, n, shape in zip(self.params, self.offsets, self.numels,
                                    self.shapes):
            p.data = full[off:off + n].view(shape)

    @torch.no_grad()
    def gather(self) -> None:
        """All-gather the unit on the device (a collective); a no-op when
        it is there."""
        if self.on_device:
            return
        self._bind(all_gather_into(self.shard, self.group))
        self.on_device = True
        self.book.gathers += 1
        self.book.add(gathered=self.full_bytes)

    @torch.no_grad()
    def to_host(self, gather: bool = True) -> None:
        """Bind the parameters to whole host tensors: the gathered values
        (a collective), or uninitialized storage for a restore to write."""
        self.free()
        self._bind(all_gather_into(self.shard, self.group).cpu() if gather
                   else torch.empty(self.world * self.size))

    def free(self) -> None:
        """Drop the full parameters (on the device or the host)."""
        for p in self.params:
            p.data = torch.empty(0, device=self.device)
        if self.on_device:
            self.book.add(gathered=-self.full_bytes)
        self.on_device = False

    @torch.no_grad()
    def reduce(self, flat: torch.Tensor) -> None:
        """Add this rank's slice of the unit's full gradient ``flat``
        ((world * size,)), summed over the ranks when the book says so,
        into ``grad``."""
        if self.book.sum_ranks:
            part = reduce_scatter_sum(flat, self.group)
        else:
            part = flat[self.rank * self.size:
                        (self.rank + 1) * self.size].clone()
        self.grad = part if self.grad is None else self.grad.add_(part)
        self.book.reduces += 1


def _as_tuple(out) -> tuple:
    return (out,) if torch.is_tensor(out) else tuple(out)


class _UnitRun(torch.autograd.Function):
    """``fn`` over each chunk of inputs (a microbatch's tensors) with the
    unit gathered once, keeping only the inputs.  The backward gathers the
    unit again and, chunk by chunk in order, recomputes ``fn`` with the
    gradient on and backpropagates it into one zeroed flat buffer (the
    parameters' ``.grad`` are views of it and autograd adds in place, so
    the chunks' gradients add up in the order a microbatch loop adds them
    in ``.grad``), which the unit then reduces to its shard gradient once
    and frees.  ``layout`` (a list) receives each chunk's number of
    outputs."""

    @staticmethod
    def forward(ctx, unit, fn, sizes, layout, handle, *xs):
        ctx.unit, ctx.fn, ctx.sizes = unit, fn, sizes
        ctx.save_for_backward(*xs)
        unit.gather()
        try:
            outs, lo = [], 0
            for n in sizes:
                out = _as_tuple(fn(*xs[lo:lo + n]))
                layout.append(len(out))
                outs += out
                lo += n
        finally:
            unit.free()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        unit = ctx.unit
        xs = [x.detach().requires_grad_(need) for x, need in
              zip(ctx.saved_tensors, ctx.needs_input_grad[5:])]
        unit.gather()
        flat = torch.zeros(unit.world * unit.size, device=unit.device)
        unit.book.add(grads=unit.full_bytes)
        try:
            for p, off, n, shape in zip(unit.params, unit.offsets,
                                        unit.numels, unit.shapes):
                p.grad = flat[off:off + n].view(shape)
            lo = g_lo = 0
            for n in ctx.sizes:
                chunk = xs[lo:lo + n]
                with torch.enable_grad():
                    outs = _as_tuple(ctx.fn(*chunk))
                pairs = [(o, g) for o, g in zip(outs,
                                                 grads[g_lo:g_lo + len(outs)])
                         if o.requires_grad and g is not None]
                if pairs:
                    torch.autograd.backward(
                        [o for o, _ in pairs], [g for _, g in pairs],
                        inputs=[x for x in chunk if x.requires_grad]
                        + unit.trainable)
                lo, g_lo = lo + n, g_lo + len(outs)
                del outs, pairs
            for p in unit.params:
                p.grad = None
            unit.free()
            unit.reduce(flat)
        finally:
            unit.free()
            del flat
            unit.book.add(grads=-unit.full_bytes)
        return (None,) * 5 + tuple(x.grad if x.requires_grad else None
                                   for x in xs)


def run_unit(unit: FlatUnit, fn, chunks: Sequence[Sequence[torch.Tensor]]
             ) -> list:
    """``[fn(*chunk) for chunk in chunks]``, each as a tuple, with
    ``unit``'s parameters gathered once for all chunks (a step's
    microbatches), and freed after.
    Under autograd (the gradient on and the unit trainable) through
    :class:`_UnitRun`: the backward gathers the unit again, recomputes each
    chunk in order and reduces the unit's summed gradient to its shard.
    ``fn`` returns a tensor or a tuple of them, and must compute the same
    values when it runs again."""
    chunks = [tuple(c) for c in chunks]
    if not (torch.is_grad_enabled() and unit.trainable):
        unit.gather()
        try:
            return [_as_tuple(fn(*c)) for c in chunks]
        finally:
            unit.free()
    layout: List[int] = []
    flat = _UnitRun.apply(unit, fn, [len(c) for c in chunks], layout,
                          unit.handle, *[x for c in chunks for x in c])
    out, lo = [], 0
    for n in layout:
        out.append(flat[lo:lo + n])
        lo += n
    return out


def _fused_on(opt: torch.optim.Optimizer, device: torch.device) -> None:
    """The card's fused update for an optimizer built over host tensors
    whose shards went to the card (``fused`` left at its default)."""
    if (device.type == "cuda" and "fused" in opt.defaults
            and opt.defaults["fused"] is None
            and not opt.defaults.get("foreach")):
        opt.defaults["fused"] = True
        for g in opt.param_groups:
            g["fused"] = True


class FSDPOptimizer:
    """FSDP: the parameters of ``opt`` (a ``torch.optim`` optimizer built
    over the full parameters, no step taken) moved into :class:`FlatUnit`
    s over ``group``, and ``opt`` onto each parameter's piece of this
    rank's shards (so a weight-decay mask follows each element).

    ``units`` is a list of (name, parameters) covering every parameter of
    ``opt`` once; ``followers`` the same for tensors sharded in step (the
    DINO teacher, unit for unit the student's layout), not optimized.  The
    shards go to ``device`` (default: the parameters'), and the full
    parameters are dropped: build the model on the host and only the
    shards reach the card.

    A step runs its forward through :func:`run_unit` on :meth:`unit_of`
    each module, zeroes the gradients with :meth:`zero_grad` first, and
    calls :meth:`step` after the backward, which left each unit's shard
    gradient.  :meth:`gather` / :meth:`release` make the whole model
    resident on the device and drop it again; :meth:`to_host` /
    :meth:`from_host` bind the parameters to whole host tensors (a save, a
    restore) and re-cut the shards from them.
    """

    def __init__(self, opt: torch.optim.Optimizer, group,
                 units: Sequence[Tuple[str, Sequence[torch.Tensor]]],
                 followers: Sequence[Tuple[str, Sequence[torch.Tensor]]] = (),
                 device=None):
        if opt.state:
            raise ValueError("shard an optimizer before its first step")
        self.params = [p for g in opt.param_groups for p in g["params"]]
        self.group = group
        device = torch.device(device if device is not None
                              else self.params[0].device)
        self.book = UnitBook()
        self.units = [FlatUnit(n, ps, group, device, self.book)
                      for n, ps in units]
        self.followers = [FlatUnit(n, ps, group, device, self.book)
                          for n, ps in followers]
        self._unit_of = {id(p): u for u in self.units + self.followers
                         for p in u.params}
        where = {id(p): (u, i) for u in self.units
                 for i, p in enumerate(u.params)}
        if sorted(where) != sorted(id(p) for p in self.params):
            raise ValueError("FSDP units must hold every optimized "
                             "parameter once, and nothing else")
        self._where = [where[id(p)] for p in self.params]
        self.pieces = [u.piece(i) for u, i in self._where]
        by_id = {id(p): pc for p, pc in zip(self.params, self.pieces)}
        for g in opt.param_groups:
            g["params"] = [by_id[id(p)] for p in g["params"]]
        _fused_on(opt, device)
        self.inner = opt

    @property
    def param_groups(self):
        return self.inner.param_groups

    def unit_of(self, module) -> FlatUnit:
        """The unit holding ``module``'s parameters (or a parameter's)."""
        p = module if torch.is_tensor(module) else next(module.parameters())
        return self._unit_of[id(p)]

    def piece_of(self, p: torch.Tensor) -> torch.Tensor:
        """The optimizer's tensor for parameter ``p``: its piece of this
        rank's shard."""
        return self.pieces[[id(q) for q in self.params].index(id(p))]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for u in self.units:
            u.grad = None
        self.inner.zero_grad(set_to_none=True)

    def shard_grads(self) -> List[torch.Tensor]:
        """Each parameter's piece of its unit's shard gradient (zeros for a
        unit no backward reached), set as the pieces' ``.grad``; in the
        plain optimizer's order."""
        for u in self.units:
            if u.grad is None:
                u.grad = torch.zeros_like(u.shard)
        out = []
        for (u, i), pc in zip(self._where, self.pieces):
            lo, hi = u.span(i)
            pc.grad = u.grad[lo:hi]
            out.append(pc.grad)
        return out

    def unit_grads(self) -> List[torch.Tensor]:
        """The units' shard gradients (after :meth:`shard_grads`)."""
        return [u.grad for u in self.units]

    @torch.no_grad()
    def step(self) -> None:
        """One update of the shards from the shard gradients the backward
        left."""
        self.shard_grads()
        self.inner.step()

    def gather(self) -> None:
        """Every unit (and follower) gathered on the device and kept: the
        whole model resident (a collective)."""
        for u in self.units + self.followers:
            u.gather()

    def release(self) -> None:
        """Drop every full parameter; the shards stay."""
        for u in self.units + self.followers:
            u.free()

    def to_host(self, gather: bool = True) -> None:
        """Every parameter bound to a whole host tensor, gathered one unit
        at a time (a collective), or, with ``gather=False``, to
        uninitialized host storage that a restore then writes whole."""
        for u in self.units + self.followers:
            u.to_host(gather)

    def from_host(self) -> None:
        """Re-cut every shard from the parameters' whole host tensors (after
        a restore wrote them), then drop those."""
        for u in self.units + self.followers:
            u.load([p.detach() for p in u.params])
            u.free()

    @torch.no_grad()
    def gathered_grads(self) -> List[torch.Tensor]:
        """Every parameter's whole gradient from the units' shard gradients
        (a collective), in the plain optimizer's order."""
        self.shard_grads()
        full = {id(u): all_gather_into(u.grad, u.group) for u in self.units}
        return [full[id(u)][u.offsets[i]:u.offsets[i] + u.numels[i]]
                .view(u.shapes[i]) for u, i in self._where]

    def state_dict(self) -> dict:
        """The plain optimizer's state dict: each moment gathered whole to
        the host, one unit at a time (a collective)."""
        sd = self.inner.state_dict()
        state = {idx: dict(st) for idx, st in sd["state"].items()}
        index = {id(p): k for k, p in enumerate(self.params)}
        for u in self.units:
            ids = [index[id(p)] for p in u.params]
            if not all(k in state for k in ids):
                continue
            first = ids[0]
            for key, v in list(state[first].items()):
                if not _is_moment(v, self.pieces[first].numel()):
                    continue
                flat = torch.zeros_like(u.shard)
                for i, k in enumerate(ids):
                    lo, hi = u.span(i)
                    flat[lo:hi] = state[k][key]
                full = all_gather_into(flat, u.group).cpu()
                for i, k in enumerate(ids):
                    off, n = u.offsets[i], u.numels[i]
                    state[k][key] = full[off:off + n].view(u.shapes[i])
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, sd: dict) -> None:
        """Load a plain optimizer's state dict (whole moments), each moment
        cut to this rank's pieces."""
        state = {}
        for idx, st in sd["state"].items():
            idx = int(idx)
            u, i = self._where[idx]
            lo, hi = u.span(i)
            a = u.rank * u.size + lo - u.offsets[i]
            state[idx] = {k: (v.reshape(-1)[a:a + hi - lo].clone()
                              if _is_moment(v, u.numels[i]) else v)
                          for k, v in st.items()}
        inner = self.inner.state_dict()
        inner["state"] = state
        self.inner.load_state_dict(inner)

    def resident_bytes(self) -> Dict[str, int]:
        """This rank's bytes of the optimized parameters (the shards, plus
        any full storage gathered on the device), their gradients (the
        shard gradients) and optimizer moments; ``followers`` the
        followers' shards."""
        def shards(units):
            return sum(u.size * 4 + (u.full_bytes if u.on_device else 0)
                       for u in units)
        return {"params": shards(self.units),
                "grads": sum(u.grad.numel() * 4 for u in self.units
                             if u.grad is not None),
                "moments": _moment_bytes(self.inner),
                "followers": shards(self.followers)}


def optimizer_params(opt) -> List[torch.Tensor]:
    """The full parameters an optimizer (plain or sharded) updates."""
    if isinstance(opt, (ShardedOptimizer, FSDPOptimizer)):
        return list(opt.params)
    return [p for g in opt.param_groups for p in g["params"]]


def materialize(opt) -> None:
    """Make an FSDP optimizer's whole model resident on its device (a
    collective; a no-op for any other optimizer)."""
    if isinstance(opt, FSDPOptimizer):
        opt.gather()
