"""Time build variants of the bf16 flash forward and of the fused LN+MLP
against each other, on the card, in one process.

    python -m dino_tpu_torch.cli.kernel_variants [--out DIR]
        [--kernels flash mlp] [--trace]

Each variant is a copy of a kernel's source with other values of its tile
constants or one edit, compiled by nvcc into its own library under DIR
(default ``kernel_variants/`` in the kernels' build directory,
``_build.build_dir()``; all variants at once, ptxas's
report in ``nvcc.log`` beside each) and loaded with ctypes; the csrc files
themselves are left as they are.  Times are CUDA events around bursts of
10 calls, median of 5, taken in turns: every variant, then again in
reverse order.  One JSON line per variant, with ptxas's registers and
spills and the card's name and power limit.

The bf16 flash forward (``csrc/flash_attn_fwd.cu``): ``FB_CONSUMERS``
consumer warpgroups of 64 query rows, ``FB_BK`` keys per tile,
``FB_BLOCKS`` blocks per SM and, for ``expf``, the softmax as
``exp(S*scale - m)`` in place of the kernel's one FMA and ``ex2``.  Each is
first held against the plain version (``FLASH_TOL[bf16]``, ``LSE_ATOL`` of
chip_smoke.py) at the edge shapes, then timed at the 480px batch-3 predict
shape (B*nh 18, N 3,601) and the 2-rank 960px ring hop (B*nh 12, N 7,201,
valid 7,200), beside SDPA on the same inputs and the main library's
wrapper (``flash_attention``, without and with the LSE).

The fused MLP (``csrc/fused_ln_mlp.cu``): MLP_VARIANTS below.  Each that
computes the function is held to the plain version under chip_smoke.py's
tolerance (2 bf16 ulps of max(|x|, |ref|, |h|) plus one of rms(h)) and to
the same bits twice at M in {1, 64, 65, 129, 3,601, 10,803, 57,616}, then
timed at M = 10,803 (480px batch 3), 3,601 (one frame) and 64 (one row
block: the latency of one block).  ``--trace`` builds the kernel once more
with clock64 stamps at the phases of its chunk loop in block 0 and prints,
per consumer warpgroup, the cycles of its LayerNorm and the median cycles
of each phase of a chunk (TRACE_PHASES) at M = 10,803.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from dino_tpu_torch.cli import bench
from dino_tpu_torch.ops import _build
from dino_tpu_torch.models.vit import Block, ViTConfig
from dino_tpu_torch.ops.attention import attention_dyn_plain, flash_attention
from dino_tpu_torch.ops.fused_mlp import fused_ln_mlp_residual_plain

# (consumers, keys per tile, blocks per SM, softmax exp)
VARIANTS = ((2, 64, 1, "ex2"), (2, 128, 1, "ex2"), (3, 64, 1, "ex2"),
            (3, 128, 1, "ex2"), (2, 64, 2, "ex2"), (2, 128, 1, "expf"))
# (name, constants, source edit) of the fused MLP: HSPLIT blocks of a
# cluster splitting the hidden dimension of one row block; "frcp" takes the GELU's reciprocal
# correctly rounded (the kernel takes the MUFU's, within 1 ulp); the "cut_*"
# builds take one part out (wrong results, timing only: what that part
# costs where it stands)
MLP_VARIANTS = (
    ("kernel", {}, None),
    ("hsplit1", {"HSPLIT": 1}, None),
    ("frcp", {}, "frcp"),
    ("cut_gelu", {}, "gelu"),
    ("cut_fc1", {}, "fc1"),
    ("cut_fc2", {}, "fc2"),
    ("cut_stream", {}, "stream"))
# the softmax of the ``expf`` variants: p = exp(S*scale - m)
EXPF_SOFTMAX = """template <bool MASK, int NR>
__device__ __forceinline__ void softmax_tile(float (&s)[NR], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int valid, int t,
                                             float scale) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NR / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale;
      if (MASK && k0 + j * 8 + 2 * t + (e & 1) >= valid) x = NEG_INF;
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NR / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = expf(s[4 * j + e] - m[e >> 1]);
      rsum[e >> 1] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
}

"""
SCALE = 64 ** -0.5
FLASH_TOL = (1e-2, 1e-2)  # chip_smoke.FLASH_TOL[bf16]
LSE_ATOL = 1e-5


def _set_consts(src: str, consts) -> str:
    for name, val in consts:
        old = f"constexpr int {name} = "
        i = src.index(old) + len(old)
        src = src[:i] + str(val) + src[src.index(";", i):]
    return src


def _source(consumers: int, bk: int, blocks: int, exp: str) -> str:
    src = _set_consts((_build.CSRC / "flash_attn_fwd.cu").read_text(),
                      (("FB_CONSUMERS", consumers), ("FB_BK", bk),
                       ("FB_BLOCKS", blocks)))
    if exp == "expf":
        i = src.index("template <bool MASK, int NR>")
        j = src.index("template <int NR>", i)
        src = src[:i] + EXPF_SOFTMAX + src[j:]
    return src


def launch_regs(consumers: int, blocks: int) -> int:
    """The registers a thread that ptxas must report for the variant (the
    kernel's setmaxnreg split assumes them)."""
    return 65536 // (blocks * 128 * (consumers + 1)) // 8 * 8


def _compile(jobs):
    """{key: (ctypes library, ptxas report)} of {key: (dir, source file
    name, source text)}, compiled at once; failures are reported and left
    out."""
    nvcc = _build._nvcc()
    procs = {}
    for key, (d, name, text) in jobs.items():
        d.mkdir(parents=True, exist_ok=True)
        (d / name).write_text(text)
        procs[key] = (d, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
             "-o", str(d / "lib.so"), str(d / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (d, p) in procs.items():
        log, _ = p.communicate()
        (d / "nvcc.log").write_text(log)
        if p.returncode != 0:
            print(json.dumps({"variant": key, "build": "failed",
                              "log": log[-3000:]}), flush=True)
            continue
        libs[key] = (ctypes.CDLL(str(d / "lib.so")),
                     _build.ptxas_report(log))
    return libs


def _entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = list(_build._SIGNATURES[name])
    fn.restype = ctypes.c_int
    return fn


def build(out: Path):
    """{variant: (dtt_flash_attn_fwd_dyn, ptxas report of flash_fwd_bf16)}."""
    libs = _compile({v: (out / "c{}_bk{}_b{}_{}".format(*v),
                         "flash_attn_fwd.cu", _source(*v))
                     for v in VARIANTS})
    fns = {}
    for v, (lib, report) in libs.items():
        ptxas = [r for k, r in report.items() if "flash_fwd_bf16" in k][0]
        if ptxas.get("registers") != launch_regs(v[0], v[2]):
            print(json.dumps({"variant": v, "build": "unexpected registers",
                              "ptxas": ptxas}), flush=True)
            continue
        fns[v] = (_entry(lib, "dtt_flash_attn_fwd_dyn"), ptxas)
    return fns


def call(fn, q, k, v, valid):
    b, nh, n, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * nh, n), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * nh, n, k.shape[2], valid, hd, 1, SCALE,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("variant", rc)
    return out, lse


def inputs(bh, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh // 6 or 1, min(bh, 6), n, 64, generator=g,
                        device="cuda").to(torch.bfloat16) for _ in range(3)]


def agrees(fn, bh, n, valid, seed):
    q, k, v = inputs(bh, n, seed)
    out, lse = call(fn, q, k, v, valid)
    torch.cuda.synchronize()
    ref, ref_lse = attention_dyn_plain(q, k, v, SCALE, valid)
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= FLASH_TOL[0] + FLASH_TOL[1] * ref.float().abs()).all())
    if valid:
        ok &= (lse - ref_lse).abs().max().item() <= LSE_ATOL
    else:
        ok &= lse.max().item() <= -1e29
    return ok, err.max().item()


def init_vit_params_block(block, gen):
    """The model's own init (models/vit.py:init_vit_params) on one block."""
    with torch.no_grad():
        for lin in (block.attn.qkv, block.attn.proj, block.mlp.fc1,
                    block.mlp.fc2):
            torch.nn.init.trunc_normal_(lin.weight, std=0.02, a=-0.04, b=0.04,
                                        generator=gen)
            torch.nn.init.zeros_(lin.bias)


def mlp_within_tolerance(out, ref, x):
    """chip_smoke.py's mlp_err rule: |out - ref| <= 2 bf16 ulps of
    max(|x|, |ref|, |ref - x|) + 1 bf16 ulp of rms(ref - x)."""
    def ulp(mag):
        mag = mag.abs().clamp_min(2.0 ** -126)
        return torch.exp2(torch.floor(torch.log2(mag)) - 7)
    out, ref, x = out.float(), ref.float(), x.float()
    h = ref - x
    scale = torch.maximum(torch.maximum(x.abs(), ref.abs()), h.abs())
    tol = 2 * ulp(scale) + ulp(h.pow(2).mean().sqrt())
    return bool(((out - ref).abs() <= tol).all())


def event_ms(fn, rounds=5, burst=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / burst)
    return sorted(times)[len(times) // 2]


def flash_variants(out: Path, card: str):
    libs = build(out)
    shapes = {"row1": (18, 3601, 3601), "row5": (12, 7201, 7200)}
    data = {name: inputs(bh, n, seed=i)
            for i, (name, (bh, n, _)) in enumerate(shapes.items())}
    recs = {}
    for v, (fn, ptxas) in libs.items():
        bq = 64 * v[0]
        checks = [(1, n, valid) for n in (bq - 1, bq, bq + 1, 3601)
                  for valid in sorted({0, 1, 63, 64, 65, n}) if valid <= n]
        bad = [c for c in checks if not agrees(fn, *c, seed=sum(c))[0]]
        recs[v] = {"variant": {"consumers": v[0], "bk": v[1], "bq": bq,
                               "blocks_per_sm": v[2], "exp": v[3]},
                   "ptxas": ptxas, "checks": len(checks), "failed": bad}
    # time in turns: every variant, then again in reverse order
    order = [v for v in libs if not recs[v]["failed"]]
    for turn in (order, order[::-1]):
        for v in turn:
            fn = libs[v][0]
            for name, (bh, n, valid) in shapes.items():
                q, k, vv = data[name]
                recs[v].setdefault(name + "_ms", []).append(event_ms(
                    lambda: call(fn, q, k, vv, valid)))
    q, k, v = data["row1"]
    print(json.dumps({"wrapper": "flash_attention", "row1_ms": event_ms(
        lambda: flash_attention(q, k, v, SCALE)), "row1_lse_ms": event_ms(
        lambda: flash_attention(q, k, v, SCALE, return_lse=True)),
        "card": card}), flush=True)
    for name, (bh, n, valid) in shapes.items():
        q, k, v = data[name]
        kv = [t[:, :, :valid].contiguous() for t in (k, v)]
        sdpa = event_ms(lambda: F.scaled_dot_product_attention(
            q, *kv, scale=SCALE))
        print(json.dumps({"sdpa": name, "ms": sdpa, "card": card}),
              flush=True)
    for rec in recs.values():
        print(json.dumps(dict(rec, card=card)), flush=True)


def _mlp_source(src: str, consts: dict, edit) -> str:
    src = _set_consts(src, consts.items())
    if edit is None:
        return src
    old, new = {
        "frcp": ("rcp_approx(1.f + 0.3275911f * az)",
                 "__frcp_rn(1.f + 0.3275911f * az)"),
        "gelu": ("hv[e] = x1 * 0.5f * (1.f + erf_as(z));", "hv[e] = x1 + z;"),
        "fc1": ("    fc1_issue(hacc, Xn, Ws + (more ? s1 : s2) * W_SLOT, cc);",
                ""),
        "fc2": ("    fc2_issue(acc, Hs, Ws + s2 * W_SLOT, c, cc);", ""),
        # after the ring's first fill, slots are marked full unloaded
        "stream": ("      mbar_arrive_expect_tx(&full[s], W_SLOT);",
                   "      if (it >= W_STAGES) { mbar_arrive(&full[s]); ++it; "
                   "continue; }\n"
                   "      mbar_arrive_expect_tx(&full[s], W_SLOT);")}[edit]
    assert old in src, edit
    return src.replace(old, new)


# clock64 stamps of consumer threads 0 and 128 (one per warpgroup) of block
# 0 at the phases of the chunk loop: (anchor in the source, code after it)
TRACE_POINTS = (
    ("  __syncthreads();\n\n  const int warp = tid / 32, lane = tid % 32;\n",
     "  DTT_STAMP(0);\n"),
    ("  fence_proxy_async();  // LN(x) -> visible to wgmma\n"
     "  named_barrier(BAR_CONSUMERS, CONSUMERS);\n", "  DTT_STAMP(1);\n"),
    ("    const bool more = c + 1 < c_end;\n",
     "    DTT_STAMP(8 + 8 * (c - c_begin));\n"),
    ("    mbar_wait(&full[s2], (it / W_STAGES) & 1);\n    ++it;\n",
     "    DTT_STAMP(9 + 8 * (c - c_begin));\n"),
    ("    fc2_issue(acc, Hs, Ws + s2 * W_SLOT, c, cc);\n",
     "    DTT_STAMP(10 + 8 * (c - c_begin));\n"),
    ("    wgmma_wait<1>();\n    reg_fence(hacc);\n",
     "    DTT_STAMP(11 + 8 * (c - c_begin));\n"),
    ("      fence_proxy_async();\n    }\n",
     "    DTT_STAMP(12 + 8 * (c - c_begin));\n"),
    ("    wgmma_wait<0>();\n    reg_fence(acc);\n",
     "    DTT_STAMP(13 + 8 * (c - c_begin));\n"),
    ("    named_barrier(BAR_CONSUMERS, CONSUMERS);\n  }\n}\n",
     None))  # the loop's end: stamp 14, inside the loop
TRACE_PHASES = ("wait_weights", "issue", "wait_fc1", "gelu", "wait_fc2",
                "barrier")


def _trace_source(src: str) -> str:
    """The source with clock64 stamps (DTT_STAMP) and a reader entry."""
    src = src.replace('#include "hopper.cuh"\n', '#include "hopper.cuh"\n\n'
                      "__device__ long long dtt_stamps[1024];\n"
                      "#define DTT_STAMP(k) do { if (blockIdx.x == 0 && "
                      "threadIdx.x < 256 && (threadIdx.x & 127) == 0) "
                      "dtt_stamps[(threadIdx.x >> 7) * 512 + (k)] = "
                      "clock64(); } while (0)\n", 1)
    for old, new in TRACE_POINTS:
        assert old in src, old
        if new is None:
            src = src.replace(old, old.replace(
                "CONSUMERS);\n  }", "CONSUMERS);\n    DTT_STAMP(14 + 8 * "
                "(c - c_begin));\n  }"), 1)
        else:
            src = src.replace(old, old + new, 1)
    return src + (
        '\nextern "C" int dtt_stamps_read(void* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, dtt_stamps, "
        "sizeof(dtt_stamps));\n}\n")


def mlp_trace(out: Path, card: str, run_inputs):
    """Per-phase clock64 cycles of block 0's chunk loop (median over the
    chunks after the first), for each consumer warpgroup, at M = 10,803."""
    src = (_build.CSRC / "fused_ln_mlp.cu").read_text()
    libs = _compile({"trace": (out / "mlp_trace", "fused_ln_mlp.cu",
                               _trace_source(src))})
    if "trace" not in libs:
        return
    lib = libs["trace"][0]
    run, x = run_inputs
    fn = _entry(lib, "dtt_fused_ln_mlp")
    for _ in range(3):
        run(fn, x)
    torch.cuda.synchronize()
    buf = np.zeros(1024, dtype=np.int64)
    lib.dtt_stamps_read.argtypes = [ctypes.c_void_p]
    _build.check_launch("stamps", lib.dtt_stamps_read(buf.ctypes.data))
    for wg in (0, 1):
        st = buf[wg * 512:(wg + 1) * 512]
        n = int(np.count_nonzero(st[8::8]))
        it = np.array([st[8 + 8 * i:15 + 8 * i] for i in range(n)])
        d = np.diff(it, axis=1)[1:]
        print(json.dumps({"trace": "fused_ln_mlp", "warpgroup": wg,
                          "m": int(x.shape[0]), "chunks": n,
                          "ln_cycles": int(st[1] - st[0]),
                          "first_chunk_cycles": int(st[8] - st[1]),
                          "loop_cycles": int(it[-1, -1] - it[0, 0]),
                          "per_chunk_median_cycles": dict(zip(
                              TRACE_PHASES, np.median(d, axis=0).tolist())),
                          "card": card}), flush=True)


def mlp_variants(out: Path, card: str, trace: bool = False):
    src = (_build.CSRC / "fused_ln_mlp.cu").read_text()
    libs = _compile({name: (out / f"mlp_{name}", "fused_ln_mlp.cu",
                            _mlp_source(src, consts, edit))
                     for name, consts, edit in MLP_VARIANTS})
    block = Block(ViTConfig())
    init_vit_params_block(block, torch.Generator().manual_seed(0))
    block = block.cuda()
    norm, mlp = block.norm2, block.mlp
    w1, w2 = (t.detach().to(torch.bfloat16).contiguous()
              for t in (mlp.fc1.weight, mlp.fc2.weight))
    vecs = [t.detach().float().contiguous() for t in (
        mlp.fc1.bias, mlp.fc2.bias, norm.weight, norm.bias)]
    g = torch.Generator(device="cuda").manual_seed(1)
    xs = {m: (torch.randn(m, 384, generator=g, device="cuda") * 0.5).to(
        torch.bfloat16) for m in (1, 64, 65, 129, 3601, 10803, 57616)}

    def run(fn, x):
        o = torch.empty_like(x)
        rc = fn(x.data_ptr(), w1.data_ptr(), vecs[0].data_ptr(),
                w2.data_ptr(), vecs[1].data_ptr(), vecs[2].data_ptr(),
                vecs[3].data_ptr(), o.data_ptr(), x.shape[0], 384,
                w1.shape[0], 1e-6, torch.cuda.current_stream().cuda_stream)
        _build.check_launch("mlp variant", rc)
        return o

    recs = {}
    with torch.no_grad():
        for name, consts, edit in MLP_VARIANTS:
            if name not in libs:
                continue
            lib, report = libs[name]
            fn = _entry(lib, "dtt_fused_ln_mlp")
            ok = name.startswith("cut_") or all(
                mlp_within_tolerance(run(fn, x), fused_ln_mlp_residual_plain(
                    norm, mlp, x, 1e-6), x)
                and torch.equal(run(fn, x), run(fn, x)) for x in xs.values())
            recs[name] = {"mlp_variant": dict(consts, name=name),
                          "agrees": ok,
                          "ptxas": [r for k, r in report.items()
                                    if "fused_ln_mlp" in k][0], "fn": fn}
        order = [c for c in recs if recs[c]["agrees"]]
        for turn in (order, order[::-1]):
            for c in turn:
                for m in (10803, 3601, 64):
                    recs[c].setdefault(f"m{m}_ms", []).append(event_ms(
                        lambda: run(recs[c]["fn"], xs[m])))
    for rec in recs.values():
        rec.pop("fn")
        print(json.dumps(dict(rec, card=card)), flush=True)
    if trace:
        with torch.no_grad():
            mlp_trace(out, card, (run, xs[10803]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="build and output directory (default: "
                         "kernel_variants/ in the kernels' build directory)")
    ap.add_argument("--kernels", nargs="+", default=["flash", "mlp"],
                    choices=["flash", "mlp"])
    ap.add_argument("--trace", action="store_true",
                    help="clock64 phases of the fused MLP's chunk loop")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    card = bench.card_name_and_power_limit()
    out = (Path(args.out) if args.out
           else _build.build_dir() / "kernel_variants").resolve()
    if "flash" in args.kernels:
        flash_variants(out, card)
    if "mlp" in args.kernels:
        mlp_variants(out, card, args.trace)


if __name__ == "__main__":
    main()
