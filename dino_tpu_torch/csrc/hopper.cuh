// Hopper (sm_90a) building blocks shared by the kernels of this directory:
// mbarriers, TMA tensor loads (cp.async.bulk.tensor) and the tensor maps
// that describe them (3-D per-head rows, 2-D matrices), named barriers, the
// warpgroup matrix product wgmma (bf16 with A from registers or from shared
// memory, N = 32 to 192; TF32) with its shared-memory descriptors (128-byte
// swizzle) and fragment helpers, MUFU math, and the 3-pass TF32 split.
//
// Tile layout used throughout: a tile of rows of exactly 128 bytes (64 bf16
// or 32 f32), as TMA writes it with CU_TENSOR_MAP_SWIZZLE_128B: row r at
// byte 128*r, its 16-byte chunk c at chunk position c ^ (r % 8).  Tiles
// start on 1024-byte boundaries, so the swizzle phase is the address's own.
// A wgmma operand over such a tile is either K-major (the product's K runs
// along the row: K-major A or B) or MN-major (K runs down the rows, the
// transpose bit set); in both the stride between groups of 8 rows is 1024
// bytes.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"  // smem_u32, pack_bf16

namespace dtt {

// ------------------------------------------------------------- mbarrier ---

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// makes the inits visible to the async proxy (TMA) and the other threads
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// announce `bytes` and arrive
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// spin until the barrier's phase with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// warp specialization: a warpgroup gives registers up or takes them (every
// thread of the group executes it; N a multiple of 8 in [24, 256])
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// generic-proxy shared-memory writes -> visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ TMA ---

// box at (c0 = column, c1 = row, c2 = batch) of a 3-D tensor map -> dst;
// completion (the box's bytes) is reported to `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// box at (c0 = column, c1 = row) of a 2-D tensor map -> dst; completion on
// `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// ------------------------------------------------------------- clusters ---

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster arrives and waits; orders the
// shared-memory accesses before it (any CTA's) before those after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// 16 bytes at `p`'s offset in the shared memory of CTA `cta` of the cluster
__device__ __forceinline__ float4 ld_dsmem_f4(const void* p, unsigned cta) {
  float4 v;
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %4, %5;\n"
      "ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [remote];\n}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(smem_u32(p)), "r"(cta)
      : "memory");
  return v;
}

// the `n` threads of the named barrier `id` (1..15; 0 is __syncthreads)
// wait for each other
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime's
// entry-point query so the library needs no -lcuda; NULL if absent
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map over a contiguous (bh, rows_alloc, 64) tensor of `elem` bytes
// per value, seen as (64 columns, rows, bh): rows past `rows` read as zeros
// (TMA's out-of-bounds fill).  Boxes are (box_cols, box_rows, 1), 128-byte
// swizzled, so box_cols * elem must be 128.  Returns a cudaError_t.
inline int make_rows_map(CUtensorMap* map, const void* base,
                         CUtensorMapDataType type, int elem, int bh,
                         int rows_alloc, int rows, int box_cols,
                         int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {64, (cuuint64_t)(rows > 0 ? rows : 1),
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)64 * elem,
                                 (cuuint64_t)rows_alloc * 64 * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides,
                      box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Tensor map over a contiguous row-major (rows, cols) bf16 matrix, boxes of
// 64 columns x box_rows, 128-byte swizzled: one box is one swizzled atom.
// Rows past `rows` read as zeros.  Returns a cudaError_t.
inline int make_2d_map(CUtensorMap* map, const void* base, int rows, int cols,
                       int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                      const_cast<void*>(base), dims, strides, box, estr,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// byte offset of bf16 element (row, col < 64) in a 128-byte-swizzled atom
__device__ __forceinline__ int sw128_off(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// ----------------------------------------------------------------- wgmma ---

// shared-memory matrix descriptor of a 128-byte-swizzled operand starting
// at p (K-major or MN-major): 8-row groups 1024 bytes apart.  Both offset
// fields hold 1024: every operand here spans one 128-byte atom across its
// rows, so only the 8-row group stride is read.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of wgmma's registers
// across the fence/commit/wait above
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(unsigned (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The 64 x 64 f32 accumulator of one warpgroup: warp w of the group, lane
// (g = lane/4, t = lane%4) holds d[4j + e] at row 16w + g + 8*(e>>1),
// column 8j + 2t + (e&1).
#define DTT_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define DTT_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64) += A (64 x 8, tf32, registers) . B (8 x 64, tf32, K-major
// descriptor).  A fragment of warp w: a[0] (row 16w+g, col t), a[1] (row
// +8, col t), a[2] (row, col t+4), a[3] (row +8, col t+4).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const unsigned (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " DTT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : DTT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32) += A (64 x 8, tf32, K-major descriptor) . B (8 x 32, tf32,
// K-major descriptor).  The accumulator's layout is DTT_ACC32's at N = 32:
// d[4j + e] at row 16w + g + 8*(e>>1), column 8j + 2t + (e&1), j < 4.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}"
      ", %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64) += A (64 x 16, bf16 pairs in registers) . B (16 x 64, bf16,
// descriptor: K-major, or MN-major with TRANS_B = 1, the tile's rows then
// running along K).  A fragment of warp w: a[0] (row 16w+g, cols 2t, 2t+1),
// a[1] (row +8), a[2] (row, cols 2t+8, 2t+9), a[3] (row +8, cols 2t+8,
// 2t+9): mma.m16n8k16's A fragment, and the accumulator's columns 16c to
// 16c+15 packed into bf16 pairs.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32],
                                              const unsigned (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DTT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : DTT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

// d (64 x 64) += A (64 x 16, bf16, K-major descriptor) . B (16 x 64, bf16,
// K-major descriptor)
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[32], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128) += A (64 x 16, bf16, K-major descriptor) . B (16 x 128, bf16,
// K-major descriptor)
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 32) += A (64 x 16, bf16, K-major descriptor) . B (16 x 32, bf16,
// K-major descriptor)
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[16], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 192) += A (64 x 16, bf16, K-major descriptor) . B (16 x 192, bf16,
// K-major descriptor)
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[96], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}"
      ", %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
      "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

// the A fragment of columns [16c, 16c+16) of a warpgroup accumulator (the
// layout above, at any width N = 2 * NR), rounded to bf16
template <int NR>
__device__ __forceinline__ void acc_to_a(unsigned (&a)[4], const float (&x)[NR],
                                         int c) {
  a[0] = pack_bf16(x[8 * c], x[8 * c + 1]);
  a[1] = pack_bf16(x[8 * c + 2], x[8 * c + 3]);
  a[2] = pack_bf16(x[8 * c + 4], x[8 * c + 5]);
  a[3] = pack_bf16(x[8 * c + 6], x[8 * c + 7]);
}

// A fragments of warp w's 16 rows of a 64-row, 128-byte-swizzled bf16
// tile, one per 16 columns (ldmatrix from the swizzled rows)
__device__ __forceinline__ void load_a_frags(unsigned (&a)[4][4],
                                             const unsigned char* tile, int w,
                                             int lane) {
  const int row = 16 * w + lane % 8 + (lane / 8 % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int chunk = 2 * kk + lane / 16;
    ldsm_x4(a[kk], tile + row * 128 + ((chunk ^ (row & 7)) << 4));
  }
}

// ------------------------------------------------------------------ math ---

// 2^x (MUFU ex2; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// 1/x (MUFU rcp, within 1 ulp; subnormals flush to 0)
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------ 3-pass TF32 split ---

// x -> tf32 (round to nearest, ties away from zero), as its f32 bits
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x ~ hi + lo with hi = tf32(x), lo = tf32(x - hi): about 22 bits of x.
// a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b (lo.lo dropped).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// f32 tiles of `rows` rows x 64 columns as two 128-byte-swizzled atoms
// (columns 0-31, then 32-63; each rows * 128 bytes): the byte offset of
// element (row, col)
__device__ __forceinline__ int f32_tile_off(int row, int col, int rows) {
  return (col >> 5) * rows * 128 + row * 128 +
         ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4;
}

// A TF32 A fragment from a warpgroup accumulator without shuffles: lane
// (g, t) holds row g's values at columns 2t, 2t+1 of each 8-column slice,
// and the fragment wants them at k-indices t, t+4.  So the values are used
// where they sit, read as columns in the order 0,2,4,6,1,3,5,7 of each
// group of 8, and the B operand is written in that order: column r of the
// accumulator at k-position tf32_kpos(r).  A product sums over k, so the
// order does not change its terms.
__device__ __forceinline__ int tf32_kpos(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3);
}

// hi/lo A fragments of k-step j (columns 8j..8j+7) of an accumulator x in
// the layout above, at any width
template <int NR>
__device__ __forceinline__ void acc_to_tf32_a(unsigned (&hi)[4],
                                              unsigned (&lo)[4],
                                              const float (&x)[NR], int j) {
  // a[0], a[1]: rows g, g+8 at column 2t; a[2], a[3]: at column 2t+1
  split_tf32(x[4 * j], hi[0], lo[0]);
  split_tf32(x[4 * j + 2], hi[1], lo[1]);
  split_tf32(x[4 * j + 1], hi[2], lo[2]);
  split_tf32(x[4 * j + 3], hi[3], lo[3]);
}

}  // namespace dtt
