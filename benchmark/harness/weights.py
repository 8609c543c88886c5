"""Seeded weights and generators.

A configuration file's ``init`` lists rules ``[pattern, kind, *args]``
over parameter names (``fnmatch``; the first match wins).  Every tensor of
one rule is drawn by one call into one flat buffer on the device, so a
model of a few hundred tensors costs a handful of launches, and the same
seed gives the same weights on every run and in the check afterwards.

kinds: ``trunc_normal`` (std; cut at 2 std), ``normal`` (mean, std),
``uniform_fan_in`` (U(-1/sqrt(fan_in), +): torch's ``nn.Linear`` and
``nn.Conv2d`` default, a bias taking its weight's fan-in), ``const``.
"""
from __future__ import annotations

import fnmatch
import math
import zlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def derive_seed(seed: int, *tags: str) -> int:
    """A 63-bit seed for the stream ``tags`` of run seed ``seed`` (any
    whole number; a large one or a negative one too)."""
    words = [seed % (1 << 64)] + [zlib.crc32(t.encode()) for t in tags]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)
    return int(state[0]) % (1 << 63)


def generator(seed: int, device, *tags: str) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(derive_seed(seed, *tags))
    return gen


def _fan_in(name: str, shapes: Dict[str, Tuple[int, ...]]) -> int:
    if name.endswith("bias"):
        name = name[: -len("bias")] + "weight"
    return math.prod(shapes[name][1:])


def make_weights(shapes: Dict[str, Tuple[int, ...]], rules: Sequence,
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors of ``shapes`` on ``device``, drawn from ``seed`` by
    ``rules`` (see the module docstring)."""
    groups = [[] for _ in rules]
    for name in shapes:
        for i, rule in enumerate(rules):
            if fnmatch.fnmatchcase(name, rule[0]):
                groups[i].append(name)
                break
        else:
            raise ValueError(f"no init rule matches {name!r}")
    gen = generator(seed, device, "weights")
    out: Dict[str, torch.Tensor] = {}
    for rule, names in zip(rules, groups):
        if not names:
            continue
        kind, args = rule[1], rule[2:]
        total = sum(math.prod(shapes[n]) for n in names)
        buf = torch.empty(total, dtype=torch.float32, device=device)
        if kind == "trunc_normal":
            std = float(args[0])
            torch.nn.init.trunc_normal_(buf, 0.0, std, -2 * std, 2 * std,
                                        generator=gen)
        elif kind == "normal":
            buf.normal_(float(args[0]), float(args[1]), generator=gen)
        elif kind == "uniform_fan_in":
            buf.uniform_(-1.0, 1.0, generator=gen)
        elif kind == "const":
            buf.fill_(float(args[0]))
        else:
            raise ValueError(f"unknown init kind {kind!r}")
        start = 0
        for n in names:
            size = math.prod(shapes[n])
            t = buf[start:start + size].view(shapes[n])
            if kind == "uniform_fan_in":
                t.mul_(1.0 / math.sqrt(_fan_in(n, shapes)))
            out[n] = t
            start += size
    return {n: out[n] for n in shapes}
