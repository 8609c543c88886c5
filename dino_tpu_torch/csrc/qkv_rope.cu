// The qkv epilogue of a RoPE attention layer (DINOv3), one pass (sm_90a).
//
// Replaces no Pallas kernel: dino_tpu has no RoPE model.  In eager
// PyTorch the epilogue of qkv's float32 product is a pass for the bias, a
// pass each for the rotation's two products, its negation and cat, its
// sum, the rounding to bf16 and the head-major copy.  Here, per element of
// the (B * N, 3C) product y (C = heads x 64):
//
//   t = y + bias                     (bias of the k third read as 0)
//   q, k of row n >= prefix:  t[d] * cos[n', d] + r[d] * sin[n', d],
//       r = rotate_half(t) = [-t[32:64] | t[0:32]],  n' = n - prefix
//   out[which][b][h][n][d] = bf16(t)   (3, B, heads, N, 64), head-major
//
// in f32 with each add and product rounded on its own (__fadd_rn,
// __fmul_rn: no fma contraction), as PyTorch's elementwise passes round
// them, so the result has the plain composition's bits
// (ops/qkv_rope.py:qkv_rope_plain); the rounding is round to nearest
// even, as c10::BFloat16's.
//
// What bounds it: bytes.  4 B read and 2 B written an element (the cos
// and sin tables, (N - prefix) x 64 f32 each, stay in L2).  Design: a
// thread takes 4 columns d..d+3 of one head's first half and d+32..d+35 of
// its second (a float4 of y each), so both halves of the rotation are in
// its registers; 8 threads cover a head's 64 columns, a warp 4 heads of
// one row, reading 1 KB of y in order.  A flat grid, one thread per
// (row, which of q/k/v, head, quad).
//
// Layout: y (B * N, 3C) f32 row-major, rows b-major; bias (3C) f32; cos,
// sin (N - prefix, 64) f32; out (3, B, heads, N, 64) bf16; all contiguous,
// 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;
constexpr int HALF = HD / 2;
constexpr int QUADS = HALF / 4;  // threads a head
constexpr int THREADS = 256;

__device__ __forceinline__ float4 ld4(const float* __restrict__ p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4_bf16(__nv_bfloat16* p, float a, float b,
                                         float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// x * c + r * s with each operation rounded on its own
__device__ __forceinline__ float rot(float x, float c, float r, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(r, s));
}

__global__ void __launch_bounds__(THREADS)
qkv_rope_kernel(const float* __restrict__ y, const float* __restrict__ bias,
                const float* __restrict__ cosv,
                const float* __restrict__ sinv,
                __nv_bfloat16* __restrict__ out, int batch, int n, int heads,
                int prefix) {
  const int64_t total = static_cast<int64_t>(batch) * n * 3 * heads * QUADS;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int quad = static_cast<int>(idx % QUADS);
  int64_t t = idx / QUADS;
  const int head = static_cast<int>(t % heads);
  t /= heads;
  const int which = static_cast<int>(t % 3);
  const int64_t row = t / 3;
  const int b = static_cast<int>(row / n);
  const int tok = static_cast<int>(row % n);
  const int c = heads * HD;
  const int col = which * c + head * HD + quad * 4;
  const float* src = y + row * 3 * c + col;
  float4 lo = ld4(src), hi = ld4(src + HALF);
  if (which != 1) {  // the k third's bias is held at 0: t + 0
    const float4 bl = ld4(bias + col), bh = ld4(bias + col + HALF);
    lo.x = __fadd_rn(lo.x, bl.x); lo.y = __fadd_rn(lo.y, bl.y);
    lo.z = __fadd_rn(lo.z, bl.z); lo.w = __fadd_rn(lo.w, bl.w);
    hi.x = __fadd_rn(hi.x, bh.x); hi.y = __fadd_rn(hi.y, bh.y);
    hi.z = __fadd_rn(hi.z, bh.z); hi.w = __fadd_rn(hi.w, bh.w);
  } else {
    lo.x = __fadd_rn(lo.x, 0.0f); lo.y = __fadd_rn(lo.y, 0.0f);
    lo.z = __fadd_rn(lo.z, 0.0f); lo.w = __fadd_rn(lo.w, 0.0f);
    hi.x = __fadd_rn(hi.x, 0.0f); hi.y = __fadd_rn(hi.y, 0.0f);
    hi.z = __fadd_rn(hi.z, 0.0f); hi.w = __fadd_rn(hi.w, 0.0f);
  }
  if (which < 2 && tok >= prefix) {
    const int64_t at = static_cast<int64_t>(tok - prefix) * HD + quad * 4;
    const float4 cl = ld4(cosv + at), ch = ld4(cosv + at + HALF);
    const float4 sl = ld4(sinv + at), sh = ld4(sinv + at + HALF);
    // first half: t * cos + (-t2) * sin; second: t2 * cos + t * sin
    const float4 l = lo, h = hi;
    lo.x = rot(l.x, cl.x, -h.x, sl.x); lo.y = rot(l.y, cl.y, -h.y, sl.y);
    lo.z = rot(l.z, cl.z, -h.z, sl.z); lo.w = rot(l.w, cl.w, -h.w, sl.w);
    hi.x = rot(h.x, ch.x, l.x, sh.x); hi.y = rot(h.y, ch.y, l.y, sh.y);
    hi.z = rot(h.z, ch.z, l.z, sh.z); hi.w = rot(h.w, ch.w, l.w, sh.w);
  }
  __nv_bfloat16* dst =
      out + (((static_cast<int64_t>(which) * batch + b) * heads + head) * n +
             tok) * HD + quad * 4;
  st4_bf16(dst, lo.x, lo.y, lo.z, lo.w);
  st4_bf16(dst + HALF, hi.x, hi.y, hi.z, hi.w);
}

}  // namespace

extern "C" int dtt_qkv_rope(const void* y, const void* bias, const void* cosv,
                            const void* sinv, void* out, int batch, int n,
                            int heads, int prefix, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0 || prefix < 0 || prefix > n ||
      (reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(bias) |
       reinterpret_cast<uintptr_t>(cosv) | reinterpret_cast<uintptr_t>(sinv) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(batch) * n * 3 * heads * QUADS;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  qkv_rope_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(bias),
      static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<__nv_bfloat16*>(out), batch, n, heads, prefix);
  return (int)cudaGetLastError();
}
