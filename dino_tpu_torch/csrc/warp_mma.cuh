// Warp-level building blocks shared by the kernels of this directory:
// asynchronous global->shared copies (cp.async), shared-memory matrix loads
// (ldmatrix) and the bf16 tensor-core product mma.sync m16n8k16 with f32
// accumulation, plus the fragment layout they imply.  sm_80 and later.
#pragma once

#include <cuda_bf16.h>

namespace dtt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0+ROWS) of a row-major (n, 64) bf16 matrix -> shared memory
// (row stride ld), one cp.async per 16 bytes by NT threads; rows past n are
// zero-filled, so padded rows are finite (0 * garbage could be NaN)
template <int ROWS, int NT>
__device__ __forceinline__ void load_rows64_bf16(bf16* dst, int ld,
                                                 const bf16* src, int r0,
                                                 int n) {
  for (int i = threadIdx.x; i < ROWS * 8; i += NT) {
    const int r = i / 8, c = (i % 8) * 8;
    const bool valid = r0 + r < n;
    cp_async16(dst + r * ld + c, src + (size_t)(valid ? r0 + r : 0) * 64 + c,
               valid);
  }
}

// the same for float32 with plain 16-byte loads (synchronous)
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
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// ldmatrix.x4 lane addresses (ld = row stride in elements):
// the A operand (a[0..3] of mma_bf16) of the 16x16 tile at (row0, k0) of a
// row-major [m][k] matrix
__device__ __forceinline__ const bf16* a_tile(const bf16* m, int ld, int row0,
                                              int k0, int lane) {
  return m + (row0 + lane % 8 + (lane / 8 % 2) * 8) * ld + k0 + (lane / 16) * 8;
}
// B operands of the two 8-wide n tiles n0 and n0+8 over k0..k0+15, from a
// row-major [n][k] matrix with ldsm_x4: {r[0], r[1]} for n0, {r[2], r[3]}
// for n0+8
__device__ __forceinline__ const bf16* b_tiles_nk(const bf16* m, int ld,
                                                  int n0, int k0, int lane) {
  return m + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 + (lane / 8 % 2) * 8;
}
// the same from a row-major [k][n] matrix, with ldsm_x4_trans
__device__ __forceinline__ const bf16* b_tiles_kn(const bf16* m, int ld,
                                                  int k0, int n0, int lane) {
  return m + (k0 + lane % 8 + (lane / 8 % 2) * 8) * ld + n0 + (lane / 16) * 8;
}

// d += a . b for one 16x8x16 tile (bf16 in, f32 accumulate).  Lane
// (g = lane/4, t = lane%4) holds d[0..1] at row g, cols 2t..2t+1 and
// d[2..3] at row g+8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 (round to nearest); lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

}  // namespace dtt
