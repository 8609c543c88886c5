// SwiGLU's epilogue (DINOv3's SwiGLUFFN), one pass (sm_90a).
//
// Replaces no Pallas kernel: dino_tpu has no SwiGLU model.  w1 and w2 run
// as one cuBLAS product with an f32 result, y = [a | b] (rows, 2H); eager
// PyTorch would then make a pass for each bias, one for silu, one for the
// product and one for the rounding.  Here, per (row, column j < H):
//
//   h[row][j] = bf16(silu(a + b1[j]) * (b + b2[j])),  silu(x) = x / (1 + e^-x)
//
// in f32, silu as PyTorch's CUDA silu_kernel writes it (expf, an IEEE
// division: no --use_fast_math), adds and the product rounded on their own
// (__fadd_rn, __fmul_rn), the rounding to nearest even as c10::BFloat16's:
// the bits of the plain composition (ops/swiglu.py:swiglu_plain).
//
// What bounds it: bytes, 8 B read and 2 B written an output element.
// Design: a thread takes 8 columns (two float4 of a, two of b, one 16-byte
// bf16 vector of h), a warp 256 contiguous columns of a row; a flat grid,
// one thread per (row, 8-column vector).
//
// Layout: y (rows, 2H) f32; b12 (2H) f32 = [b1 | b2]; h (rows, H) bf16;
// row-major, contiguous, 16-byte aligned, H % 8 == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;
constexpr int THREADS = 256;

__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float (&v)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(THREADS)
swiglu_kernel(const float* __restrict__ y, const float* __restrict__ b12,
              __nv_bfloat16* __restrict__ h, int rows, int hidden) {
  const int vecs = hidden / VEC;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= static_cast<int64_t>(rows) * vecs) return;
  const int64_t row = idx / vecs;
  const int col = static_cast<int>(idx % vecs) * VEC;
  const float* src = y + row * 2 * hidden + col;
  float a[VEC], b[VEC], ba[VEC], bb[VEC];
  load8(src, a);
  load8(src + hidden, b);
  load8(b12 + col, ba);
  load8(b12 + hidden + col, bb);
  __nv_bfloat162 p[VEC / 2];
#pragma unroll
  for (int i = 0; i < VEC; i += 2) {
    const float r0 = __fmul_rn(silu(__fadd_rn(a[i], ba[i])),
                               __fadd_rn(b[i], bb[i]));
    const float r1 = __fmul_rn(silu(__fadd_rn(a[i + 1], ba[i + 1])),
                               __fadd_rn(b[i + 1], bb[i + 1]));
    p[i / 2] = __floats2bfloat162_rn(r0, r1);
  }
  uint4 out;
  out.x = *reinterpret_cast<uint32_t*>(&p[0]);
  out.y = *reinterpret_cast<uint32_t*>(&p[1]);
  out.z = *reinterpret_cast<uint32_t*>(&p[2]);
  out.w = *reinterpret_cast<uint32_t*>(&p[3]);
  *reinterpret_cast<uint4*>(h + row * hidden + col) = out;
}

}  // namespace

extern "C" int dtt_swiglu(const void* y, const void* b12, void* h, int rows,
                          int hidden, void* stream) {
  if (rows <= 0 || hidden <= 0 || hidden % VEC != 0 ||
      (reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(b12) |
       reinterpret_cast<uintptr_t>(h)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks =
      (static_cast<int64_t>(rows) * (hidden / VEC) + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  swiglu_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(b12),
      static_cast<__nv_bfloat16*>(h), rows, hidden);
  return (int)cudaGetLastError();
}
