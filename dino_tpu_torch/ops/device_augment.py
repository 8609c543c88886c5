"""Training augmentation on the device: the port of ``dino_tpu``'s
``ops/device_augment.py``, which backs ``fit(augment_backend='device')``.

The host draws every random parameter (``data/augment.py:draw_params``,
packed as ``float32[24]``) and stages the affine warp of the 25% of samples
where it fires (``data/augment.py:prepare_device_batch``); the device runs
the rest of the chain on the uint8 batch: RandomResizedCrop, HorizontalFlip,
ColorJitter and GaussianBlur.  Each op is PyTorch on the whole batch with
per-sample parameters.  Every decision (which samples crop, flip, jitter in
which order, blur with which k) is read from the packed array on the host,
so the device work is planned without reading anything back from the card,
and the per-sample numbers of each op go to the card in one pinned,
non-blocking copy: a blocking copy would wait for the train step queued
before it.

Numerics (held against ``dino_tpu`` and the host recipe by
``tests/test_torch_port_device_augment.py``):

  * flip and the identity: the same bits;
  * jitter: the same bits.  Each op is the recipe's single-rounded float32
    op (eager PyTorch runs every op as its own kernel, so no product is
    contracted into an fma with the add after it) or exact integer
    arithmetic: the fixed-point gray, cv2's integer RGB->HSV through its
    division tables, the two-rounding float32 HSV->RGB, the contrast mean
    as the exact integer split q + fl(r / n) (a division by a tensor: CUDA
    turns a division by a host scalar into a product with its reciprocal);
  * blur: the same bits for every k.  The taps are dyadic (q/256), so every
    product and partial sum of both passes is an exact float32 and the
    order of the sums does not matter; each pass pads its axis by a
    reflect-101 gather and accumulates the shifted slices times the taps
    (no matmul, so no TF32);
  * crop-resize: two taps per axis, fl(fl(w0 * x0) + fl(w1 * x1)), rows
    first, each pass's result rounded to float32 before the next, then
    floor(v + 0.5).  The coordinates and weights are ``dino_tpu``'s float32
    arithmetic (:145-148) as XLA runs it (the division by the size is a
    product with its float32 reciprocal), each op rounded once, computed on
    the host.  ``dino_tpu`` on XLA:CPU sums the taps inside a float32 dot
    and contracts the coordinate's ``* fl(1 / size) - 0.5`` into an fma,
    which moves a coordinate by up to one ulp, so a pixel may differ from
    it by one level where the exact value lies within ``CROP_TIE_EPS`` of
    k + 0.5; both stay within the host recipe's gates.

The card and the CPU give the same bits for the same staged batch: every op
above is exact or rounded once by IEEE float32 arithmetic on both.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

from dino_tpu_torch.data.augment import (HDIV_TABLE, PARAMS_LEN, SDIV_TABLE,
                                         _gaussian_taps, _invert_affine,
                                         _reflect101_idx)
from dino_tpu_torch.ops.resize import nearest_resize_indices
from dino_tpu_torch.utils.device import resolve_device

MAX_BLUR = 41  # albumentations' blur_limit upper bound
# crop-resize against dino_tpu: a pixel may differ by one level only where
# the exact bilinear value lies within this distance of k + 0.5.  A one-ulp
# move of a coordinate below 512 (2^-15) moves a tap weight by as much and
# the value by at most 255 * 2^-15 per axis; the rounding of the two passes
# adds a few float32 ulps of 255
CROP_TIE_EPS = 2.0 ** -5
# HSV->RGB: which of the four sector terms (v, p, q, t) each of R, G, B
# takes, per hue sector
_SECTOR_TERMS = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0],
                          [3, 1, 0], [0, 1, 2]], np.int64)


@functools.lru_cache(maxsize=1)
def _blur_taps_table() -> np.ndarray:
    """(20, MAX_BLUR) float32: row (k-3)//2 holds the taps for odd kernel
    size k, centred in the MAX_BLUR window (zeros beyond)."""
    tab = np.zeros(((MAX_BLUR - 3) // 2 + 1, MAX_BLUR), np.float64)
    for i, k in enumerate(range(3, MAX_BLUR + 1, 2)):
        t = _gaussian_taps(k)
        lo = (MAX_BLUR - k) // 2
        tab[i, lo:lo + k] = t / t.sum()
    return tab.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The HSV division tables and the sector map, on ``device`` (made
    once per device)."""
    return tuple(torch.from_numpy(a).to(device) for a in
                 (SDIV_TABLE.astype(np.int32), HDIV_TABLE.astype(np.int32),
                  _SECTOR_TERMS))


def _upload(device: torch.device, *arrays: np.ndarray) -> List[torch.Tensor]:
    """Small host arrays as tensors on ``device``: one copy per dtype,
    pinned and non-blocking on the card."""
    out: List[Optional[torch.Tensor]] = [None] * len(arrays)
    for dtype in sorted({a.dtype.str for a in arrays}):
        idx = [i for i, a in enumerate(arrays) if a.dtype.str == dtype]
        flat = torch.from_numpy(np.concatenate(
            [np.ravel(arrays[i]) for i in idx]))
        if device.type == "cuda":
            flat = flat.pin_memory().to(device, non_blocking=True)
        off = 0
        for i in idx:
            n = arrays[i].size
            out[i] = flat[off:off + n].view(arrays[i].shape)
            off += n
    return out


def _per_sample(v: torch.Tensor) -> torch.Tensor:
    """(n,) -> (n, 1, 1, 1): one number per sample over (H, W, C)."""
    return v[:, None, None, None]


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


# ---------------------------------------------------------------------------
# RandomResizedCrop
# ---------------------------------------------------------------------------

def crop_taps(packed: np.ndarray, size: int):
    """Per sample, the two source indices and weights of each output row
    and column (host numpy, float32 as ``dino_tpu``'s :145-148 run, each op
    rounded): src = clip((d + .5) * c * fl(1 / size) - .5, 0, c - 1) +
    offset inside the crop (half-pixel, taps clamped to the crop), src = d
    where the crop is off.
    Returns (lo_y, hi_y, w0_y, w1_y, lo_x, hi_x, w0_x, w1_x), each
    (B, size)."""
    f = np.float32
    d = np.arange(size, dtype=f)
    on = packed[:, 0:1] > 0.5
    out = []
    for off, extent in ((packed[:, 2:3], packed[:, 4:5]),
                        (packed[:, 1:2], packed[:, 3:4])):
        # XLA lowers dino_tpu's `/ size` to a product with fl(1 / size)
        src = np.clip((d + f(0.5)) * extent * f(1.0 / size) - f(0.5),
                      f(0.0), extent - f(1.0)) + off
        src = np.where(on, src, d)
        i0 = np.floor(src)
        t = (src - i0).astype(f)
        out += [np.clip(i0, 0, size - 1).astype(np.int64),
                np.clip(i0 + 1, 0, size - 1).astype(np.int64),
                (f(1.0) - t).astype(f), t]
    return out


def _two_taps(x: torch.Tensor, lo, hi, w0, w1) -> torch.Tensor:
    """Resample dim 1 of (B, H, W, C): fl(fl(w0 * x[lo]) + fl(w1 * x[hi]))
    per sample."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return ((x[b, lo] * w0[:, :, None, None])
            + (x[b, hi] * w1[:, :, None, None]))


def crop_resize(x: torch.Tensor, packed: np.ndarray) -> torch.Tensor:
    """RandomResizedCrop of a float (B, S, S, 3) batch back to S x S (rows,
    then columns, then round half up); samples whose crop is off pass
    through unchanged (weights 1 and 0)."""
    if not (packed[:, 0] > 0.5).any():
        return x
    ly, hy, w0y, w1y, lx, hx, w0x, w1x = _upload(
        x.device, *crop_taps(packed, x.shape[1]))
    x = _two_taps(x, ly, hy, w0y, w1y)
    x = _two_taps(x.transpose(1, 2), lx, hx, w0x, w1x).transpose(1, 2)
    return _round_u8(x)


# ---------------------------------------------------------------------------
# HorizontalFlip
# ---------------------------------------------------------------------------

def flip(x: torch.Tensor, packed: np.ndarray) -> torch.Tensor:
    rows = np.flatnonzero(packed[:, 12] > 0.5)
    if rows.size == len(packed):
        return x.flip(2)
    if not rows.size:
        return x
    (rows_t,) = _upload(x.device, rows)
    return x.index_copy(0, rows_t, x.index_select(0, rows_t).flip(2))


# ---------------------------------------------------------------------------
# ColorJitter
# ---------------------------------------------------------------------------

def _gray(x: torch.Tensor) -> torch.Tensor:
    """cv2 RGB2GRAY of the truncated uint8 values of x (in [0, 255]): the
    shift-15 fixed point (9798, 19235, 3735) rounded half up, int32."""
    xi = torch.floor(x).to(torch.int32)
    return (xi[..., 0] * 9798 + xi[..., 1] * 19235 + xi[..., 2] * 3735
            + 16384) >> 15


def _brightness(x, b):
    return x * _per_sample(b)


def _contrast(x, c, one_minus_c, n_pix):
    """Blend toward the mean gray, the mean as the exact split q + fl(r/n)
    of the integer gray sum."""
    total = _gray(x).sum(dim=(1, 2))
    n = x.shape[1] * x.shape[2]
    q = torch.div(total, n, rounding_mode="floor")
    r = total - q * n
    mean = q.to(torch.float32) + (r.to(torch.float32) / n_pix)
    add = mean * one_minus_c
    return (x * _per_sample(c)) + _per_sample(add)


def _saturation(x, s, one_minus_s):
    gy = _gray(x).to(torch.float32) * one_minus_s[:, None, None]
    return (x * _per_sample(s)) + gy[..., None]


def rgb_to_hsv(xi: torch.Tensor):
    """cv2 RGB2HSV on uint8 values held in int32 (..., 3): the
    hsv_shift=12 division-table path; H in [0, 180)."""
    sdiv, hdiv, _ = _tables(xi.device)
    r, g, b = xi.unbind(-1)
    v = xi.amax(-1)
    diff = v - xi.amin(-1)
    s = (diff * sdiv[v] + 2048) >> 12
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + 2048) >> 12
    return torch.where(h < 0, h + 180, h), s, v


def hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """cv2-shaped HSV2RGB: float32 sector math with two-rounding 1 - s*f
    terms and a truncating output; float-held uint8 (..., 3)."""
    _, _, terms = _tables(h.device)
    hf = h.to(torch.float32) * (6.0 / 180.0)
    sf = s.to(torch.float32) * (1.0 / 255.0)
    vf = v.to(torch.float32) * (1.0 / 255.0)
    sector = torch.floor(hf)
    f = hf - sector
    tabs = torch.stack([vf, vf * (1.0 - sf), vf * (1.0 - (sf * f)),
                        vf * (1.0 - (sf * (1.0 - f)))], dim=-1)
    idx = terms[sector.to(torch.int64) % 6]
    return torch.floor(torch.gather(tabs, -1, idx) * 255.0)


def _hue(x, shift):
    h, s, v = rgb_to_hsv(torch.floor(x).to(torch.int32))
    h = torch.remainder(h + shift[:, None, None], 180)
    return hsv_to_rgb(h, s, v)


_JITTER_OPS = (_brightness, _contrast, _saturation, _hue)


def jitter(x: torch.Tensor, packed: np.ndarray) -> torch.Tensor:
    """ColorJitter in each sample's own order of the four ops, clipped to
    [0, 255] after every op and truncated at the end.  At each of the four
    steps the jittered samples are grouped by the op they run there (the
    groups are read from the packed array on the host)."""
    on = np.flatnonzero(packed[:, 13] > 0.5)
    if not on.size:
        return x
    f = np.float32
    p = packed[on]
    order = p[:, 14:18].astype(np.int64)
    c, s = p[:, 19], p[:, 20]
    args = ((p[:, 18],), (c, (f(1.0) - c).astype(f)),
            (s, (f(1.0) - s).astype(f)),
            (np.rint(p[:, 21] * f(180.0)).astype(np.int64),))
    # host arrays: the jittered rows, the pixel count (the contrast mean's
    # divisor), then per step and op the group's rows and its numbers
    arrays = [on, np.full(1, x.shape[1] * x.shape[2], f)]
    plan = []
    for step in range(4):
        groups = []
        for op in range(4):
            rows = np.flatnonzero(order[:, step] == op)
            if rows.size:
                groups.append((op, rows.size == on.size, len(arrays)))
                arrays += [rows] + [a[rows] for a in args[op]]
        plan.append(groups)
    dev = _upload(x.device, *arrays)
    on_t, n_pix = dev[0], dev[1]
    every = on.size == len(packed)
    xj = x if every else x.index_select(0, on_t)
    for groups in plan:
        for op, whole, at in groups:
            rows_t = dev[at]
            op_args = dev[at + 1:at + 1 + len(args[op])]
            if op == 1:
                op_args.append(n_pix)
            if whole:
                xj = _JITTER_OPS[op](xj, *op_args)
            else:
                xj = xj.index_copy(0, rows_t, _JITTER_OPS[op](
                    xj.index_select(0, rows_t), *op_args))
        xj = torch.clamp(xj, 0.0, 255.0)
    xj = torch.floor(xj)
    return xj if every else x.index_copy(0, on_t, xj)


# ---------------------------------------------------------------------------
# GaussianBlur
# ---------------------------------------------------------------------------

def blur(x: torch.Tensor, packed: np.ndarray) -> torch.Tensor:
    """GaussianBlur(k, sigma=0) with reflect-101 borders: each pass pads
    its axis once (a gather of reflect-101 indices) and adds the shifted
    slices times the sample's taps into one accumulator, so the memory is
    two frames' worth whatever k.  The window is the widest k of the
    batch; a sample's taps are zero beyond its own k.  Every product and
    partial sum is an exact float32, so ``addcmul``'s fused multiply-add
    gives the bits of a rounded product and add."""
    on = np.flatnonzero(packed[:, 22] > 0.5)
    if not on.size:
        return x
    k = np.clip(packed[on, 23], 3.0, float(MAX_BLUR))
    row = np.rint((k - 3.0) / 2.0).astype(np.int64)
    kmax = 2 * int(row.max()) + 3
    lo = (MAX_BLUR - kmax) // 2
    taps = _blur_taps_table()[row, lo:lo + kmax]
    size = x.shape[1]
    pad = _reflect101_idx(np.arange(-(kmax // 2), size + kmax // 2), size)
    on_t, taps_t, pad_t = _upload(x.device, on, taps, pad.astype(np.int64))
    every = on.size == len(packed)
    y = x if every else x.index_select(0, on_t)
    for axis in (1, 2):
        padded = y.index_select(axis, pad_t)
        y = torch.zeros_like(y)
        for j in range(kmax):
            y.addcmul_(padded.narrow(axis, j, size), _per_sample(taps_t[:, j]))
    y = _round_u8(y)
    return y if every else x.index_copy(0, on_t, y)


# ---------------------------------------------------------------------------
# The batch entry point
# ---------------------------------------------------------------------------

def _check_packed(packed) -> np.ndarray:
    """The packed parameters as a (B, 24) float32 host array; raises for
    another shape or a live affine flag (the device runs no warp, while
    ``augment_grid_mask`` would apply it to the labels)."""
    if torch.is_tensor(packed):
        raise TypeError("packed params must be a host array: a tensor on "
                        "the card would be read back, stalling the stream")
    packed = np.asarray(packed, np.float32)
    if packed.ndim != 2 or packed.shape[1] != PARAMS_LEN:
        raise ValueError(f"packed params must be (B, {PARAMS_LEN}); got "
                         f"{packed.shape}")
    if np.any(packed[:, 5] > 0.5):
        raise ValueError(
            "packed params carry a live affine flag; stage the batch "
            "through data.augment.prepare_device_batch first (the device "
            "augmentation applies no warp)")
    return packed


def device_augment_batch(imgs_u8, packed,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """(B, S, S, 3) uint8 frames (host array or tensor) and (B, 24) packed
    parameters (a host array) -> (B, S, S, 3) uint8 on ``device`` (the card when None;
    raises without one).  The frames must come through
    ``data.augment.prepare_device_batch``, which applies the affine on the
    host and clears its flag.  ``device_augment_batch.calls`` counts the
    calls."""
    packed = _check_packed(packed)
    device = resolve_device(device)
    imgs = (imgs_u8 if torch.is_tensor(imgs_u8)
            else torch.from_numpy(np.ascontiguousarray(imgs_u8)))
    b, s = len(packed), imgs.shape[1]
    if imgs.dtype != torch.uint8 or tuple(imgs.shape) != (b, s, s, 3):
        raise ValueError(f"frames must be uint8 ({b}, S, S, 3); got "
                         f"{imgs.dtype} {tuple(imgs.shape)}")
    if device.type == "cuda" and imgs.device.type == "cpu":
        imgs = imgs.pin_memory().to(device, non_blocking=True)
    else:
        imgs = imgs.to(device)
    device_augment_batch.calls += 1
    x = imgs.to(torch.float32)
    x = crop_resize(x, packed)
    x = flip(x, packed)
    x = jitter(x, packed)
    x = blur(x, packed)
    return x.to(torch.uint8).contiguous()


device_augment_batch.calls = 0


# ---------------------------------------------------------------------------
# Grid labels on the host
# ---------------------------------------------------------------------------

def augment_grid_mask(mask, p: dict, size: int, grid: int) -> np.ndarray:
    """Token-grid labels of one augmented sample: the nearest samplings
    (grid downsample <- flip <- affine <- crop-resize) composed into one
    gather on the resized full-size mask.  Each stage is an integer index
    map, so the composition equals transforming the full-size mask and
    then downsampling it; the affine stage is the warp recipe's own
    float32 index map (``data/augment.py:warp_affine_mask``).  mask:
    (size, size) int; returns (grid * grid,) int32."""
    g = nearest_resize_indices(size, grid)
    ys = np.broadcast_to(g[:, None], (grid, grid)).astype(np.int64)
    xs = np.broadcast_to(g[None, :], (grid, grid)).astype(np.int64)
    if p["flip"]:
        xs = size - 1 - xs
    if p["affine"] is not None:
        f = np.float32
        inv = _invert_affine(np.asarray(p["affine"], np.float32
                                        ).astype(np.float64))
        bx = (f(inv[0, 1]) * ys.astype(f)) + f(inv[0, 2])
        by = (f(inv[1, 1]) * ys.astype(f)) + f(inv[1, 2])
        fx = (f(inv[0, 0]) * xs.astype(f)) + bx
        fy = (f(inv[1, 0]) * xs.astype(f)) + by
        xs = _reflect101_idx(np.floor(fx.astype(np.float64) + 0.5
                                      ).astype(np.int64), size)
        ys = _reflect101_idx(np.floor(fy.astype(np.float64) + 0.5
                                      ).astype(np.int64), size)
    if p["crop"] is not None:
        x0, y0, cw, ch = p["crop"]
        xs = np.clip(np.floor(xs * (cw / size)), 0, max(cw - 1, 0)
                     ).astype(np.int64) + x0
        ys = np.clip(np.floor(ys * (ch / size)), 0, max(ch - 1, 0)
                     ).astype(np.int64) + y0
    return np.asarray(mask)[np.clip(ys, 0, size - 1),
                            np.clip(xs, 0, size - 1)
                            ].reshape(-1).astype(np.int32)
