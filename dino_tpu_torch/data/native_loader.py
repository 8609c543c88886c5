"""ctypes binding of the native C++ loader (``native/dtloader.cpp``).

The port builds the repository's ``native/dtloader.cpp`` into its own build
directory (``dino_tpu_torch/_build/``, or ``$DINO_TPU_TORCH_BUILD_DIR``) at
first use, with the flags ``dino_tpu``'s loader uses, and writes nothing
under ``native/``.  The library name carries the host's CPU tag
(``-march=native`` makes the binary CPU-specific).  Every function returns
``None`` when the library cannot be built or loaded (no ``g++``, no libjpeg
headers): callers then take the numpy recipe (``data/augment.py``) or the
Pillow decoder, and ``backend='native'`` raises.  Nothing runs at import.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from dino_tpu_torch.utils.hostcpu import cpu_tag

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dtloader.cpp"
# dino_tpu/data/native_loader.py's flags; -ffp-contract=off keeps every f32
# operation singly rounded, which the recipes' bit-exactness depends on
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-ffp-contract=off",
             "-fPIC", "-shared", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")
PARAMS_LEN = 24  # data/augment.py:pack_params

_lock = threading.Lock()
_lib = None
_tried = False
build_error: Optional[str] = None  # why the library is unavailable

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_intp = ctypes.POINTER(ctypes.c_int)
_charpp = ctypes.POINTER(ctypes.c_char_p)
_SIGNATURES = {
    "dt_decode_jpeg_file": ((ctypes.c_char_p, _u8p, _intp, _intp,
                             ctypes.c_int, ctypes.c_int), ctypes.c_int),
    "dt_decode_resize_file": ((ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                               _u8p), ctypes.c_int),
    "dt_load_batch": ((_charpp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       _u8p, ctypes.c_int), ctypes.c_int),
    "dt_jpeg_dims": ((_u8p, ctypes.c_longlong, _intp, _intp), ctypes.c_int),
    "dt_decode_jpeg_mem": ((_u8p, ctypes.c_longlong, _u8p, ctypes.c_int,
                            ctypes.c_int), ctypes.c_int),
    "dt_decode_resize_mem": ((_u8p, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_int, _u8p), ctypes.c_int),
    "dt_augment_batch": ((_charpp, ctypes.c_int, ctypes.c_int, _f32p,
                          ctypes.POINTER(_i32p), _intp, _intp, _u8p, _i32p,
                          ctypes.c_int), ctypes.c_int),
    "dt_warp_affine_u8": ((_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           _f32p, _u8p), None),
    "dt_warp_affine_i32": ((_i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            _f32p, _i32p), None),
    "dt_gaussian_blur_u8": ((_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int),
                            None),
}


def build_dir() -> Path:
    return Path(os.environ.get("DINO_TPU_TORCH_BUILD_DIR",
                               Path(__file__).resolve().parents[1] / "_build"))


def library_path() -> Path:
    return build_dir() / f"libdtloader.{cpu_tag()}.so"


def _build() -> Optional[Path]:
    """The library, built if missing or older than the source; None (and
    ``build_error`` set) when the toolchain or libjpeg is missing."""
    global build_error
    so = library_path()
    if so.exists() and so.stat().st_mtime >= SOURCE.stat().st_mtime:
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    # a process-private name, renamed into place: a process racing this
    # one never loads a half-written library
    tmp = so.with_name(f"{so.name}.build.{os.getpid()}")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                        *LIBS], check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError) as exc:
        build_error = (getattr(exc, "stderr", None) or str(exc)).strip()
        tmp.unlink(missing_ok=True)
        return None
    return so


def get_lib():
    """Load (building at first use) the native library, or None."""
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not SOURCE.exists():
            build_error = f"{SOURCE} not found"
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as exc:
            build_error = str(exc)
            return None
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _paths(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def decode(path: str, max_h: int = 4096, max_w: int = 4096
           ) -> Optional[np.ndarray]:
    """Decode one JPEG file at full resolution, (H, W, 3) uint8; None on
    failure."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.empty(max_h * max_w * 3, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.dt_decode_jpeg_file(path.encode(), _ptr(buf, _u8p), ctypes.byref(h),
                               ctypes.byref(w), max_h, max_w) != 0:
        return None
    return buf[:h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def decode_resize(path: str, out_h: int, out_w: int) -> Optional[np.ndarray]:
    """Decode and resize one JPEG file (the eval path's resize); None on
    failure."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.dt_decode_resize_file(path.encode(), out_h, out_w,
                                   _ptr(out, _u8p))
    return out if rc == 0 else None


def _jpeg_dims_checked(lib, data: bytes, max_h: int, max_w: int):
    """(h, w, pointer) of in-memory JPEG bytes, or None for a body that is
    not a JPEG or declares a frame over max_h x max_w (a few-KB JPEG can
    declare a frame whose decode would commit tens of GB)."""
    if lib is None or len(data) < 4 or data[:2] != b"\xff\xd8":
        return None
    buf = np.frombuffer(data, np.uint8)
    src = _ptr(buf, _u8p)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.dt_jpeg_dims(src, len(data), ctypes.byref(h), ctypes.byref(w)):
        return None
    if not (0 < h.value <= max_h and 0 < w.value <= max_w):
        return None
    return h.value, w.value, buf, src


def decode_bytes(data: bytes, max_h: int = 4096, max_w: int = 4096
                 ) -> Optional[np.ndarray]:
    """Decode in-memory JPEG bytes (a request body); None on failure or a
    frame over max_h x max_w.  The native call releases the GIL."""
    lib = get_lib()
    dims = _jpeg_dims_checked(lib, data, max_h, max_w)
    if dims is None:
        return None
    h, w, buf, src = dims
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.dt_decode_jpeg_mem(src, len(data), _ptr(out, _u8p), h, w)
    return out if rc == 0 else None


def decode_resize_bytes(data: bytes, out_h: int, out_w: int,
                        max_h: int = 4096, max_w: int = 4096
                        ) -> Optional[np.ndarray]:
    """Decode and resize in-memory JPEG bytes; None on failure or a frame
    over max_h x max_w."""
    lib = get_lib()
    dims = _jpeg_dims_checked(lib, data, max_h, max_w)
    if dims is None:
        return None
    _, _, buf, src = dims
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.dt_decode_resize_mem(src, len(data), out_h, out_w,
                                  _ptr(out, _u8p))
    return out if rc == 0 else None


def load_batch(paths: List[str], out_h: int, out_w: int,
               n_threads: int = 0) -> Optional[np.ndarray]:
    """Decode and resize a batch on the C++ thread pool, (n, h, w, 3)
    uint8; None on any failure."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    failures = lib.dt_load_batch(_paths(paths), n, out_h, out_w,
                                 _ptr(out, _u8p),
                                 n_threads or min(n, os.cpu_count() or 1))
    return out if failures == 0 else None


def augment_batch(paths: List[str], masks: List[np.ndarray], res: int,
                  params: np.ndarray, n_threads: int = 0):
    """The training augmentation of a batch on the C++ thread pool.

    ``params`` is (n, PARAMS_LEN) float32 from ``data.augment.pack_params``
    (all randomness is drawn in Python).  Returns (images uint8 (n, res,
    res, 3), masks int32 (n, res, res)), or None on any failure."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    n = len(paths)
    params = np.ascontiguousarray(params, np.float32)
    if params.shape != (n, PARAMS_LEN):
        raise ValueError(f"params of shape {params.shape}, want "
                         f"({n}, {PARAMS_LEN})")
    masks = [np.ascontiguousarray(m, np.int32) for m in masks]
    out_imgs = np.empty((n, res, res, 3), np.uint8)
    out_masks = np.empty((n, res, res), np.int32)
    mptrs = (_i32p * n)(*[_ptr(m, _i32p) for m in masks])
    mh = (ctypes.c_int * n)(*[m.shape[0] for m in masks])
    mw = (ctypes.c_int * n)(*[m.shape[1] for m in masks])
    failures = lib.dt_augment_batch(
        _paths(paths), n, res, _ptr(params, _f32p), mptrs, mh, mw,
        _ptr(out_imgs, _u8p), _ptr(out_masks, _i32p),
        n_threads or min(n, os.cpu_count() or 1))
    return (out_imgs, out_masks) if failures == 0 else None


def warp_affine(img: np.ndarray, M, size: int) -> Optional[np.ndarray]:
    """Bilinear reflect-101 warp (the f32 recipe of
    ``data/augment.py:warp_affine_u8``); None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    m = np.ascontiguousarray(np.asarray(M, np.float32).ravel())
    out = np.empty((size, size, 3), np.uint8)
    lib.dt_warp_affine_u8(_ptr(img, _u8p), img.shape[0], img.shape[1], size,
                          _ptr(m, _f32p), _ptr(out, _u8p))
    return out


def warp_affine_nearest(mask: np.ndarray, M, size: int
                        ) -> Optional[np.ndarray]:
    """Nearest reflect-101 warp of an int32 mask; None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, np.int32)
    m = np.ascontiguousarray(np.asarray(M, np.float32).ravel())
    out = np.empty((size, size), np.int32)
    lib.dt_warp_affine_i32(_ptr(mask, _i32p), mask.shape[0], mask.shape[1],
                           size, _ptr(m, _f32p), _ptr(out, _i32p))
    return out


def gaussian_blur(img: np.ndarray, k: int) -> Optional[np.ndarray]:
    """Gaussian blur with the dyadic taps of
    ``data/augment.py:gaussian_blur_u8``, into a new array; None without
    the library."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.ascontiguousarray(img, np.uint8).copy()
    lib.dt_gaussian_blur_u8(_ptr(out, _u8p), out.shape[0], out.shape[1],
                            int(k))
    return out
