// Warp-level building blocks shared by the kernels of this directory:
// shared-memory addresses, plain row loads of (n, 64) f32 tiles, the
// shared-memory matrix load ldmatrix, and the bf16 pair packing of mma and
// wgmma fragments.
#pragma once

#include <cuda_bf16.h>

namespace dtt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// rows [r0, r0+ROWS) of a row-major (n, 64) float32 matrix -> shared memory
// (row stride ld) by NT threads with 16-byte loads; rows past n are
// zero-filled, so padded rows are finite (0 * garbage could be NaN)
template <int ROWS, int NT>
__device__ __forceinline__ void load_rows64_f32(float* dst, int ld,
                                                const float* src, int r0,
                                                int n) {
  for (int i = threadIdx.x; i < ROWS * 16; i += NT) {
    const int r = i / 16, c = (i % 16) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * 64 + c);
    float* d = dst + r * ld + c;
    d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
  }
}

// four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 address matrix i
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// two floats -> bf16x2 (round to nearest); lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

}  // namespace dtt
