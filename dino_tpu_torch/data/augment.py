"""Host-side training augmentation: the numpy recipe of ``dino_tpu``'s
``data/augment.py``, with no cv2.

    Resize(480) -> RandomResizedCrop(480, scale=(.25,1), ratio=(.9,1.1), p=.75)
    -> ShiftScaleRotate(shift=.4, scale=.1, rotate=15, p=.25)
    -> HorizontalFlip(p=.5) -> ColorJitter(brightness=.5, p=.5)
    -> GaussianBlur(blur_limit=(3,41), p=.25)

Every random parameter is drawn here (``draw_params``) from a numpy
Generator, in ``dino_tpu``'s order, so the same seed gives the same
decisions.  Every pixel operation is an exact recipe that the native C++
loader (``native/dtloader.cpp``, bound by ``data/native_loader.py``)
computes bit for bit:

  * ``resize_pair``: cv2's INTER_LINEAR fixed-point arithmetic for images
    (``native/dtloader.cpp:resize_bilinear_u8_cv2``) and cv2's
    INTER_NEAREST for masks, in numpy.  Not the float resize of the
    predict path (``ops/resize.py:resize_bilinear``), which rounds
    differently;
  * warp (two-rounding f32 coordinates and blend), blur (dyadic /256 taps),
    gray/HSV conversions and the jitter chain, copied from ``dino_tpu``.

The warp and blur take the native library when it is built (the same
bits); the numpy code below is each recipe's definition.  Normalization is
not done here: batches stay uint8 and are normalized on the device.  For
the device augmentation (``ops/device_augment.py``), ``stage_device_sample``
and ``prepare_device_batch`` apply the affine warp on the host and clear
its flags.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from dino_tpu_torch.data import native_loader

INTER_RESIZE_COEF_BITS = 11  # cv2's fixed-point weights: 2048 = 1.0


def _linear_taps(n_in: int, n_out: int):
    """cv2 INTER_LINEAR taps of one axis: (lower index, upper index, lower
    weight, upper weight), the weights in 1/2048.  The source coordinate is
    computed in double and cast to float before the floor; both indices
    clamp to the edge while the fraction is kept."""
    scale = n_in / n_out
    c = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
         ).astype(np.float32)
    s = np.floor(c)
    frac = (c - s).astype(np.float64)
    one = float(1 << INTER_RESIZE_COEF_BITS)
    i0 = np.clip(s.astype(np.int64), 0, n_in - 1)
    i1 = np.clip(s.astype(np.int64) + 1, 0, n_in - 1)
    return (i0, i1, np.rint((1.0 - frac) * one).astype(np.int32),
            np.rint(frac * one).astype(np.int32))


def resize_linear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(img, (out_w, out_h), INTER_LINEAR) of a uint8 (H, W, C)
    image, bit for bit: the horizontal pass in int32, then cv2's vertical
    pass (((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2."""
    x0, x1, a0, a1 = _linear_taps(img.shape[1], out_w)
    y0, y1, b0, b1 = _linear_taps(img.shape[0], out_h)

    def horizontal(rows):
        r = img[rows].astype(np.int32)
        return (r[:, x0] * a0[None, :, None]) + (r[:, x1] * a1[None, :, None])

    top = horizontal(y0) >> 4
    bottom = horizontal(y1) >> 4
    v = (((b0[:, None, None] * top) >> 16)
         + ((b1[:, None, None] * bottom) >> 16))
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """cv2 INTER_NEAREST: min(floor(x / (n_out / n_in)), n_in - 1)."""
    ifx = 1.0 / (n_out / n_in)
    return np.minimum(np.floor(np.arange(n_out) * ifx).astype(np.int64),
                      n_in - 1)


def resize_pair(img: np.ndarray, mask: Optional[np.ndarray],
                size: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Image bilinear and mask nearest to size x size, as cv2.resize with
    INTER_LINEAR and INTER_NEAREST (the mask as int32)."""
    img = resize_linear_u8(np.ascontiguousarray(img), size, size)
    if mask is not None:
        mask = np.asarray(mask).astype(np.int32)[
            np.ix_(_nearest_index(mask.shape[0], size),
                   _nearest_index(mask.shape[1], size))]
    return img, mask


# GaussianBlur(k, sigma=0) taps for the blur recipe: cv2's tables for k <= 7
# and /256 fixed point for every k >= 9 (cv2's own treatment at k = 9), so
# every product and partial sum of both separable passes is an exact float
# and the result does not depend on the order of the sums.  The port's copy
# of dino_tpu/ops/device_augment.py:_gaussian_taps.
_SMALL_GAUSSIAN_TAB = {
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def _gaussian_taps(k: int) -> np.ndarray:
    """GaussianBlur(k, sigma=0) taps (float64, sum 1); odd k only."""
    if k <= 7:
        return np.asarray(_SMALL_GAUSSIAN_TAB[k], np.float64)
    s = 0.3 * ((k - 1) * 0.5 - 1.0) + 0.8
    x = np.arange(k, dtype=np.float64) - (k - 1) / 2
    g = np.exp(-x * x / (2 * s * s))
    g /= g.sum()
    q = np.floor(g * 256 + 0.5)
    q[k // 2] += 256 - q.sum()
    return q / 256


# ---------------------------------------------------------------------------
# Parameter drawing — the single source of randomness.  The numpy Generator is
# consumed here and only here, so the numpy path below and the native C++ path
# (native/dtloader.cpp dt_augment_batch) produce the same geometry/photometry
# from the same per-sample seed (the resume-determinism contract).
# ---------------------------------------------------------------------------

def _draw_crop(rng: np.random.Generator, size: int,
               scale=(0.25, 1.0), ratio=(0.9, 1.1)):
    """RandomResizedCrop rect on a size x size canvas (albumentations'
    rejection-sampling loop)."""
    h = w = size
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return x0, y0, cw, ch
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


def _draw_affine(rng: np.random.Generator, size: int,
                 shift_limit=0.4, scale_limit=0.1, rotate_limit=15):
    """ShiftScaleRotate forward 2x3 matrix (cv2.getRotationMatrix2D about the
    pixel-center (size/2-0.5, size/2-0.5), plus the shift)."""
    h = w = size
    angle = rng.uniform(-rotate_limit, rotate_limit)
    scale = 1.0 + rng.uniform(-scale_limit, scale_limit)
    dx = rng.uniform(-shift_limit, shift_limit)
    dy = rng.uniform(-shift_limit, shift_limit)
    cx, cy = w / 2 - 0.5, h / 2 - 0.5
    a = math.radians(angle)
    alpha, beta = scale * math.cos(a), scale * math.sin(a)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy + dx * w],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy + dy * h]],
                    np.float64)


def _draw_jitter(rng: np.random.Generator,
                 brightness=0.5, contrast=0.2, saturation=0.2, hue=0.2):
    b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    s = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    hshift = rng.uniform(-hue, hue)
    order = rng.permutation(4)
    return order, (b, c, s, hshift)


def draw_params(rng: np.random.Generator, size: int = 480) -> dict:
    """Consume the rng exactly once per sample and return every decision the
    pipeline needs: Resize -> RandomResizedCrop(p=.75) ->
    ShiftScaleRotate(p=.25) -> HFlip(p=.5) -> ColorJitter(p=.5) ->
    GaussianBlur(p=.25)."""
    p = {"crop": None, "affine": None, "flip": False, "jitter": None,
         "blur": None}
    if rng.random() < 0.75:
        p["crop"] = _draw_crop(rng, size)
    if rng.random() < 0.25:
        p["affine"] = _draw_affine(rng, size)
    p["flip"] = bool(rng.random() < 0.5)
    if rng.random() < 0.5:
        p["jitter"] = _draw_jitter(rng)
    if rng.random() < 0.25:
        p["blur"] = int(rng.integers(3 // 2, 41 // 2 + 1)) * 2 + 1
    return p


PARAMS_LEN = 24  # packed float32 layout consumed by the C++ pipeline


def pack_params(p: dict) -> np.ndarray:
    """dict -> float32[PARAMS_LEN] for native/dtloader.cpp:dt_augment_batch."""
    out = np.zeros((PARAMS_LEN,), np.float32)
    if p["crop"] is not None:
        out[0] = 1.0
        out[1:5] = p["crop"]
    if p["affine"] is not None:
        out[5] = 1.0
        out[6:12] = np.asarray(p["affine"], np.float64).ravel()
    out[12] = 1.0 if p["flip"] else 0.0
    if p["jitter"] is not None:
        order, factors = p["jitter"]
        out[13] = 1.0
        out[14:18] = order
        out[18:22] = factors
    if p["blur"] is not None:
        out[22] = 1.0
        out[23] = p["blur"]
    return out


# ---------------------------------------------------------------------------
# warpAffine as an exact f32 recipe.
#
# cv2's own float32 warp rounds by how its build associates and fuses the
# f32 chain, so the warp is defined as an exact two-rounding f32 recipe that
# numpy (here) and the C++ loader (-ffp-contract=off) compute identically:
#
#   coords:   bx = f32(m1*y) + m2 ;  sx = f32(m0*x) + bx   (per-op rounding)
#   bilinear: r0 = t00 + tx*(t01-t00); r1 = t10 + tx*(t11-t10)
#             v  = r0 + ty*(r1-r0);   out = floor(f64(v) + 0.5) clipped
#   nearest:  xi = floor(f64(sx) + 0.5)  (masks)
#   borders:  reflect-101, matrix inverted in f64 (cv2's expressions)
# ---------------------------------------------------------------------------

def _invert_affine(M: np.ndarray) -> np.ndarray:
    """Forward 2x3 -> sampling matrix, double precision, cv2's expressions
    (mirrors native/dtloader.cpp:invert_affine)."""
    M = np.asarray(M, np.float64)
    d = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    d = 1.0 / d if d != 0.0 else 0.0
    inv = np.empty((2, 3), np.float64)
    inv[0, 0] = M[1, 1] * d
    inv[0, 1] = -M[0, 1] * d
    inv[1, 0] = -M[1, 0] * d
    inv[1, 1] = M[0, 0] * d
    inv[0, 2] = -(inv[0, 0] * M[0, 2] + inv[0, 1] * M[1, 2])
    inv[1, 2] = -(inv[1, 0] * M[0, 2] + inv[1, 1] * M[1, 2])
    return inv


def _reflect101_idx(idx: np.ndarray, n: int) -> np.ndarray:
    if n <= 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx < n, idx, period - idx)


def _warp_coords_f32(inv: np.ndarray, out_h: int, out_w: int):
    """(sy, sx) f32 source-coordinate grids per the recipe above."""
    f = np.float32
    xs = np.arange(out_w, dtype=f)
    ys = np.arange(out_h, dtype=f)
    bx = (f(inv[0, 1]) * ys) + f(inv[0, 2])     # f32 mul then f32 add
    by = (f(inv[1, 1]) * ys) + f(inv[1, 2])
    sx = (f(inv[0, 0]) * xs)[None, :] + bx[:, None]
    sy = (f(inv[1, 0]) * xs)[None, :] + by[:, None]
    return sx, sy


def warp_affine_u8(img: np.ndarray, M: np.ndarray, size: int) -> np.ndarray:
    """Bilinear reflect-101 warp of a uint8 (H,W,3) image onto a
    size x size canvas, the exact f32 recipe above.  The matrix quantizes
    to f32 first (its precision in the packed-params layout, pack_params),
    so every backend inverts the same matrix.  Runs the native library's
    copy of the recipe when it is built; the numpy code is its
    definition."""
    img = np.ascontiguousarray(img)
    native = native_loader.warp_affine(img, M, size)
    if native is not None:
        return native
    f = np.float32
    h, w = img.shape[:2]
    M32 = np.asarray(M, np.float32).astype(np.float64)
    sx, sy = _warp_coords_f32(_invert_affine(M32), size, size)
    x0 = np.floor(sx).astype(np.int32)
    y0 = np.floor(sy).astype(np.int32)
    tx = (sx - x0.astype(f))[..., None]
    ty = (sy - y0.astype(f))[..., None]
    xa = _reflect101_idx(x0, w)
    xb = _reflect101_idx(x0 + 1, w)
    ya = _reflect101_idx(y0, h)
    yb = _reflect101_idx(y0 + 1, h)
    flat = img.reshape(-1, 3)
    t00 = np.take(flat, ya * w + xa, axis=0).astype(f)
    t01 = np.take(flat, ya * w + xb, axis=0).astype(f)
    t10 = np.take(flat, yb * w + xa, axis=0).astype(f)
    t11 = np.take(flat, yb * w + xb, axis=0).astype(f)
    t01 -= t00
    t01 *= tx
    t01 += t00          # r0 = t00 + tx*(t01-t00), in place
    t11 -= t10
    t11 *= tx
    t11 += t10          # r1
    t11 -= t01
    t11 *= ty
    t11 += t01          # v
    v = t11.astype(np.float64)
    v += 0.5
    np.floor(v, out=v)
    return np.clip(v, 0, 255).astype(np.uint8)


def warp_affine_mask(mask: np.ndarray, M: np.ndarray, size: int
                     ) -> np.ndarray:
    """Nearest reflect-101 warp of an integer mask (same f32 coords;
    native fast path when built, numpy definition otherwise)."""
    mask = np.ascontiguousarray(mask, dtype=np.int32)
    native = native_loader.warp_affine_nearest(mask, M, size)
    if native is not None:
        return native
    h, w = mask.shape[:2]
    M32 = np.asarray(M, np.float32).astype(np.float64)
    sx, sy = _warp_coords_f32(_invert_affine(M32), size, size)
    xi = _reflect101_idx(np.floor(sx.astype(np.float64) + 0.5
                                  ).astype(np.int64), w)
    yi = _reflect101_idx(np.floor(sy.astype(np.float64) + 0.5
                                  ).astype(np.int64), h)
    return mask[yi, xi]


def gaussian_blur_u8(img: np.ndarray, k: int) -> np.ndarray:
    """GaussianBlur(k, sigma=0), reflect-101, with the dyadic taps of
    _gaussian_taps: every product and partial sum of both separable passes
    is an exact float, so the result does not depend on the order of the
    sums and the native library's copy gives the same bits (it runs when
    built).  Equal to cv2's GaussianBlur for k <= 9, within one level for
    k >= 11, where cv2 keeps float taps."""
    img = np.ascontiguousarray(img, np.uint8)
    native = native_loader.gaussian_blur(img, k)
    if native is not None:
        return native
    t = _gaussian_taps(int(k))
    pad = int(k) // 2
    x = np.pad(img.astype(np.float64), ((pad, pad), (0, 0), (0, 0)),
               mode="reflect")
    h, w = img.shape[:2]
    acc = np.zeros((h, w, 3), np.float64)
    for i in range(int(k)):
        acc += t[i] * x[i:i + h]
    x = np.pad(acc, ((0, 0), (pad, pad), (0, 0)), mode="reflect")
    acc = np.zeros((h, w, 3), np.float64)
    for i in range(int(k)):
        acc += t[i] * x[:, i:i + w]
    return np.clip(np.floor(acc + 0.5), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# The application path
# ---------------------------------------------------------------------------

# The three colour conversions of the jitter chain as exact arithmetic
# recipes (cv2's cvtColor arithmetic), which the C++ loader reproduces bit
# for bit.

def gray_u8(u8: np.ndarray) -> np.ndarray:
    """cv2 RGB2GRAY on uint8: IPP's shift-15 fixed point
    (9798, 19235, 3735)/32768 with round-half-up descale."""
    r = u8[..., 0].astype(np.int64)
    g = u8[..., 1].astype(np.int64)
    b = u8[..., 2].astype(np.int64)
    return ((r * 9798 + g * 19235 + b * 3735 + 16384) >> 15).astype(np.uint8)


_HSV_SHIFT = 12
_IDX = np.arange(256)
_IDX[0] = 1
SDIV_TABLE = np.round((255 << _HSV_SHIFT) / _IDX.astype(np.float64)
                      ).astype(np.int64)
HDIV_TABLE = np.round((180 << _HSV_SHIFT) / (6.0 * _IDX)).astype(np.int64)
SDIV_TABLE[0] = HDIV_TABLE[0] = 0


def rgb_to_hsv_u8(u8: np.ndarray):
    """cv2 RGB2HSV on uint8 (H in [0,180)): the hsv_shift=12 div-table
    integer path.  Returns (h, s, v) int arrays."""
    r = u8[..., 0].astype(np.int64)
    g = u8[..., 1].astype(np.int64)
    b = u8[..., 2].astype(np.int64)
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = (diff * SDIV_TABLE[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * HDIV_TABLE[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    return np.where(h < 0, h + 180, h), s, v


def hsv_to_rgb_u8(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    """cv2-shaped HSV2RGB on uint8: float32 sector math with TRUNCATING
    output cast.  The ``1 - s*f`` terms are plain two-rounding f32 (mul,
    round, subtract), which numpy and the C++ loader (-ffp-contract=off)
    both compute, where a cv2 build may contract them into an fma."""
    ft = np.float32
    hf = h.astype(ft) * ft(6.0 / 180.0)
    sf = s.astype(ft) * ft(1.0 / 255.0)
    vf = v.astype(ft) * ft(1.0 / 255.0)
    sector = np.floor(hf).astype(np.int64)
    f = (hf - sector).astype(ft)
    sector = sector % 6
    one = ft(1.0)
    tabs = np.stack([vf, vf * (one - sf), vf * (one - sf * f),
                     vf * (one - sf * (one - f))], axis=-1).astype(ft)
    rsel = np.array([0, 2, 1, 1, 3, 0])
    gsel = np.array([3, 0, 0, 2, 1, 1])
    bsel = np.array([1, 1, 3, 0, 0, 2])
    flat = tabs.reshape(-1, 4)
    ar = np.arange(flat.shape[0])
    sec = sector.reshape(-1)
    out = np.stack([flat[ar, rsel[sec]], flat[ar, gsel[sec]],
                    flat[ar, bsel[sec]]], axis=-1) * ft(255.0)
    return np.floor(out).astype(np.uint8).reshape(h.shape + (3,))


def _u8(x: np.ndarray) -> np.ndarray:
    """clip + truncating uint8 cast (numpy astype semantics)."""
    return np.clip(x, 0, 255).astype(np.uint8)


def _apply_jitter(img, order, factors):
    """torchvision-style ColorJitter, defined as an exact f32 chain.

    Every operation below is a single-rounded float32 op on f32-cast
    factors (or exact integer arithmetic), so the C++ loader
    (native/dtloader.cpp:color_jitter) reproduces it bit for bit.  Chain: f32
    accumulator, clip to [0,255] after each op, uint8 conversions
    truncate; the contrast mean is the exact integer-sum split
    q + fl32(r/n) (both addends exactly representable; a naive f32 mean
    of 230k grays accumulates error past 2^24)."""
    fb, fc, fs, fh = [np.float32(v) for v in factors]
    one = np.float32(1.0)
    x = img.astype(np.float32)
    for i in order:
        if i == 0:
            x = x * fb
        elif i == 1:
            g = gray_u8(_u8(x))
            q, r = divmod(int(g.sum()), g.size)
            gray32 = np.float32(q) + np.float32(
                np.float32(r) / np.float32(g.size))
            add = gray32 * (one - fc)
            x = (x * fc) + add
        elif i == 2:
            g = gray_u8(_u8(x)).astype(np.float32)
            gy = g * (one - fs)
            x = (x * fs) + gy[..., None]
        else:
            h, s, v = rgb_to_hsv_u8(_u8(x))
            shift = int(np.rint(fh * np.float32(180.0)))
            h = (h.astype(np.int64) + shift) % 180
            x = hsv_to_rgb_u8(h, s, v).astype(np.float32)
        x = np.clip(x, 0, 255)
    return x.astype(np.uint8)


def apply_params(p: dict, img: np.ndarray, mask: Optional[np.ndarray],
                 size: int = 480) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Apply drawn parameters (images bilinear, masks nearest, affine
    borders reflect-101: albumentations' defaults)."""
    img, mask = resize_pair(img, mask, size)
    if p["crop"] is not None:
        x0, y0, cw, ch = p["crop"]
        img = img[y0:y0 + ch, x0:x0 + cw]
        mask = None if mask is None else mask[y0:y0 + ch, x0:x0 + cw]
        img, mask = resize_pair(img, mask, size)
    if p["affine"] is not None:
        m = np.asarray(p["affine"], np.float64)
        img = warp_affine_u8(img, m, size)
        if mask is not None:
            mask = warp_affine_mask(mask.astype(np.int32), m, size)
    if p["flip"]:
        img = img[:, ::-1].copy()
        mask = None if mask is None else mask[:, ::-1].copy()
    if p["jitter"] is not None:
        img = _apply_jitter(img, *p["jitter"])
    if p["blur"] is not None:
        img = gaussian_blur_u8(img, p["blur"])
    return img, mask


def augment(rng: np.random.Generator, img: np.ndarray, mask: np.ndarray,
            size: int = 480) -> Tuple[np.ndarray, np.ndarray]:
    """Full training augmentation. img uint8 (H,W,3), mask int (H,W)."""
    return apply_params(draw_params(rng, size), img, mask, size)


def stage_device_sample(img: np.ndarray, p: dict, size: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """One sample's host geometry for the device augmentation
    (``ops/device_augment.py``), which runs no warp: when the affine fires
    (25% of samples), apply its crop and warp here with the exact recipes
    and clear both flags.  Returns (image, packed float32[PARAMS_LEN])."""
    if p["affine"] is not None:
        if p["crop"] is not None:
            x0, y0, cw, ch = p["crop"]
            img, _ = resize_pair(img[y0:y0 + ch, x0:x0 + cw], None, size)
        img = warp_affine_u8(img, np.asarray(p["affine"], np.float64), size)
        p = dict(p, crop=None, affine=None)
    return img, pack_params(p)


def prepare_device_batch(imgs: np.ndarray, params: list, size: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """``stage_device_sample`` over a batch: (images with the host geometry
    applied where the affine fires, packed (B, PARAMS_LEN) float32).  Warped
    rows are written back into ``imgs`` in place."""
    imgs = np.ascontiguousarray(imgs)
    packed = np.empty((len(params), PARAMS_LEN), np.float32)
    for i, p in enumerate(params):
        staged, packed[i] = stage_device_sample(imgs[i], p, size)
        if p["affine"] is not None:
            imgs[i] = staged
    return imgs, packed
