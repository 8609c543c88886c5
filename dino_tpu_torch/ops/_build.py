"""Build and load the CUDA kernels of ``dino_tpu_torch/csrc``.

Each ``.cu`` file has a plain C interface.  At first use every source is
compiled by its own ``nvcc`` process (all started together), the objects are
linked into one shared library, and the library is loaded with ctypes.  The
library is keyed by a hash of the sources and flags and kept in the build
directory (``dino_tpu_torch/_build/``, or ``$DINO_TPU_TORCH_BUILD_DIR``), so a
second process reuses it.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("flash_attn_fwd.cu", "flash_attn_bwd.cu", "fused_ln_mlp.cu",
           "bias_gelu.cu", "qkv_rope.cu", "swiglu.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: (argtypes), every function returns cudaGetLastError() (but
# dtt_bias_gelu_slabs, which returns a count)
_SIGNATURES = {
    # q, k, v, out, lse (or NULL), bh, n, hd, is_bf16, scale, stream
    "dtt_flash_attn_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # q, k, v, out, lse, bh, nq, nk, valid, hd, is_bf16, scale, stream
    "dtt_flash_attn_fwd_dyn": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                               _P),
    # q, k, v, dout, lse, dsum, dq, dk, dv, bh, n, hd, is_bf16, scale, stream
    "dtt_flash_attn_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _F, _P),
    # q, k, v, dout, lse, dsum, dq, dk, dv, bh, nq, nk, valid, hd, is_bf16,
    # scale, stream
    "dtt_flash_attn_bwd_dyn": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _F, _P),
    # x, w1 (H, D), b1, w2 (D, H), b2, ln weight, ln bias, out, m, d, h, eps,
    # stream
    "dtt_fused_ln_mlp": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # y, b1, h, rows, hidden, stream
    "dtt_bias_gelu_fwd": (_P, _P, _P, _I, _I, _P),
    # dh, y, b1, du, partial (slabs, hidden), db, rows, hidden, slabs, stream
    "dtt_bias_gelu_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # rows, hidden -> the backward's slabs (negative: a CUDA error)
    "dtt_bias_gelu_slabs": (_I, _I),
    # y, bias, cos, sin, out, batch, n, heads, prefix, stream
    "dtt_qkv_rope": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # y, b12, h, rows, hidden, stream
    "dtt_swiglu": (_P, _P, _P, _I, _I, _P),
}

_LIB: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build
# nvcc's output (ptxas register and shared-memory report), kept beside the
# library
build_log = ""


def build_dir() -> Path:
    return Path(os.environ.get("DINO_TPU_TORCH_BUILD_DIR", _PKG / "_build"))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "dino_tpu_torch are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    global build_seconds
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, Path(src).stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        so_tmp = os.path.join(tmp, target.name)
        link = subprocess.run([nvcc, "-shared", "-o", so_tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        target.with_suffix(".log").write_text("\n".join(logs))
        os.replace(so_tmp, target)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from the sources on first call."""
    global _LIB, build_log
    if _LIB is None:
        target = build_dir() / f"libdino_tpu_torch_{_digest()}.so"
        if not target.exists():
            _build(target)
        build_log = target.with_suffix(".log").read_text()
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def ptxas_report(log: str) -> dict:
    """{entry function (mangled): {"registers", "spill_stores",
    "spill_loads", and "wgmma_serialized" where ptxas warned C7512}} from
    ptxas's -v report in ``log`` (nvcc's output).  C7512 ("wgmma ...
    serialized due to insufficient register resources") names its function
    and came with spills in every build of this repository."""
    report, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"C7512.*'(\w+)'", line)
        if m:
            report.setdefault(m.group(1), {})["wgmma_serialized"] = True
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            report.setdefault(entry, {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[entry].update(spill_stores=int(m.group(1)),
                                 spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[entry]["registers"] = int(m.group(1))
    return report


def check_launch(name: str, rc: int) -> None:
    """Raise if the C launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
