// Fused LayerNorm + MLP + residual for NVIDIA Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel dino_tpu/ops/fused_mlp.py:_kernel
// (launched by fused_ln_mlp_residual), the second half of every ViT block
// on the bf16 eval path:  out = x + fc2(gelu(fc1(LN(x)))).
//
// What bounds it: at 480px batch 3 (M = 10,803 token rows, D = 384,
// H = 1,536) the two products are 4*M*D*H = 2.5e10 FLOP against ~19 MB of
// x, out and weights, ~1,300 FLOP per byte: bound by operations.  The
// kernel runs both products on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulate) and never writes the (M, H) hidden activation to
// device memory: a block of 16 warps takes 64 rows, normalizes them into
// shared memory, then streams the hidden dimension in chunks of 64:
//     h_c  = bf16(gelu_as(LN(x) . W1[c]^T + b1[c]))     (64 x 64, smem)
//     acc += h_c . W2[:, c]^T                            (64 x 384, registers)
// each warp computing one 16x16 tile of h_c (bias and GELU applied in
// registers) and a 16x96 strip of acc.
// and finishes with  out = x + bf16(acc + b2),  added in bf16.  Each
// chunk's W1 and W2 slices (48 KB each; 2.4 MB in all, L2-resident) are
// staged into shared memory once per block with cp.async, one slice ahead:
// W2[c] loads behind the fc1 product, W1[c+1] behind GELU and the fc2
// product.  wgmma and TMA are later work.
//
// Numerics follow the JAX kernel: LN statistics in f32 (two-pass mean and
// variance, eps from the caller), LN output cast to bf16 (fused_mlp.py:45);
// fc1 + b1 in f32; GELU with the Abramowitz & Stegun 7.1.26 erf in f32, cast
// to bf16 (:48); fc2 + b2 in f32, cast to bf16; the residual add in bf16
// (:50).
//
// Layout: x, out (M, 384) bf16; w1 (H, 384) and w2 (384, H) bf16 in torch's
// (out, in) layout; b1 (H), b2, ln weight, ln bias (384) f32.  H % 64 == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "warp_mma.cuh"

namespace {

using namespace dtt;

constexpr int D = 384;          // embed dim
constexpr int BM = 64;          // token rows per block
constexpr int HC = 64;          // hidden chunk
constexpr int NWARPS = 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int XS = D + 8;       // padded smem strides (bank spread)
constexpr int HS = HC + 8;
constexpr int COL_GROUPS = NWARPS / 4;       // warps per 16-row strip
constexpr int OUT_COLS = D / COL_GROUPS;     // 96 output columns per warp
constexpr int OUT_TILES = OUT_COLS / 8;      // 12 8-wide accumulator tiles
static_assert(HC / 16 == COL_GROUPS, "fc1: one 16x16 tile per warp");
constexpr unsigned FULL = 0xffffffffu;

constexpr int SMEM = BM * XS * (int)sizeof(bf16)      // LN(x)
                     + HC * XS * (int)sizeof(bf16)    // W1 chunk (HC x D)
                     + D * HS * (int)sizeof(bf16)     // W2 chunk (D x HC)
                     + BM * HS * (int)sizeof(bf16);   // gelu chunk, bf16

// rows [c0, c0+HC) of w1 (H x D) -> W1s (HC x XS); one cp.async group
__device__ __forceinline__ void load_w1_chunk(bf16* W1s, const bf16* w1,
                                              int c0) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < HC * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    cp_async16(W1s + r * XS + c, w1 + (size_t)(c0 + r) * D + c);
  }
  cp_async_commit();
}

// columns [c0, c0+HC) of w2 (D x H) -> W2s (D x HS); one cp.async group
__device__ __forceinline__ void load_w2_chunk(bf16* W2s, const bf16* w2,
                                              int c0, int h) {
  constexpr int VPR = HC / 8;
  for (int i = threadIdx.x; i < D * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    cp_async16(W2s + r * HS + c, w2 + (size_t)r * h + c0 + c);
  }
  cp_async_commit();
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Abramowitz & Stegun 7.1.26 (|err| < 1.5e-7), as fused_mlp.py:_erf_as
__device__ __forceinline__ float erf_as(float z) {
  const float sign = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  const float az = fabsf(z);
  const float t = 1.f / (1.f + 0.3275911f * az);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return sign * (1.f - poly * expf(-az * az));
}

__global__ void __launch_bounds__(NTHREADS)
fused_ln_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const float* __restrict__ b1, const bf16* __restrict__ w2,
                    const float* __restrict__ b2,
                    const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b, bf16* __restrict__ out,
                    int m, int h, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xn = reinterpret_cast<bf16*>(smem);  // BM x XS
  bf16* W1s = Xn + BM * XS;                   // HC x XS
  bf16* W2s = W1s + HC * XS;                  // D x HS
  bf16* Hb = W2s + D * HS;                    // BM x HS

  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row / column pair

  load_w1_chunk(W1s, w1, 0);  // lands while the rows are normalized

  // 1. LayerNorm of the block's rows into shared memory (warp per row)
  for (int r = warp; r < BM; r += NWARPS) {
    bf16* dst = Xn + r * XS;
    const int gr = m0 + r;
    if (gr >= m) {
      for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* src = x + (size_t)gr * D;
    float xv[D / 32];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      xv[i] = __bfloat162float(src[lane + 32 * i]);
      sum += xv[i];
    }
    const float mu = warp_sum(sum) / D;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const float dv = xv[i] - mu;
      ss += dv * dv;
    }
    const float rstd = 1.f / sqrtf(warp_sum(ss) / D + eps);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int c = lane + 32 * i;
      const float y = __fadd_rn(
          __fmul_rn(__fmul_rn(xv[i] - mu, rstd), ln_w[c]), ln_b[c]);
      dst[c] = __float2bfloat16(y);
    }
  }
  __syncthreads();

  // warp roles in the products: row strip rs (16 rows), column group cg
  const int rs = warp % 4, cg = warp / 4;
  float acc[OUT_TILES][4] = {};  // rows rs*16 + {g, g+8}, cols cg*96 + 8j + 2t

  for (int c0 = 0; c0 < h; c0 += HC) {
    load_w2_chunk(W2s, w2, c0, h);  // lands behind the fc1 product
    cp_async_wait<1>();             // W1[c0] has arrived
    __syncthreads();

    // 2. fc1 tile (16 x 16 of the chunk) = Xn strip . W1 chunk^T, then
    //    + b1 and GELU (A&S erf) in f32, cast to bf16 into Hb
    {
      float hacc[2][4] = {};
#pragma unroll 4
      for (int kc = 0; kc < D / 16; ++kc) {
        unsigned a[4], b[4];
        ldsm_x4(a, a_tile(Xn, XS, rs * 16, kc * 16, lane));
        ldsm_x4(b, b_tiles_nk(W1s, XS, cg * 16, kc * 16, lane));
        mma_bf16(hacc[0], a, b[0], b[1]);
        mma_bf16(hacc[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = cg * 16 + nt * 8 + 2 * t;
        float hv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x1 = hacc[nt][e] + b1[c0 + col + (e & 1)];
          const float z = x1 * 0.7071067811865476f;
          hv[e] = x1 * 0.5f * (1.f + erf_as(z));
        }
        bf16* dst = Hb + (rs * 16 + g) * HS + col;
        *reinterpret_cast<unsigned*>(dst) = pack_bf16(hv[0], hv[1]);
        *reinterpret_cast<unsigned*>(dst + 8 * HS) = pack_bf16(hv[2], hv[3]);
      }
    }
    cp_async_wait<0>();  // W2[c0] has arrived
    __syncthreads();     // Hb complete, W2s visible, every warp done with W1s
    if (c0 + HC < h) load_w1_chunk(W1s, w1, c0 + HC);  // behind the fc2 product

    // 3. acc (16 x 96 per warp) += Hb strip . W2 chunk^T
#pragma unroll
    for (int kc = 0; kc < HC / 16; ++kc) {
      unsigned a[4];
      ldsm_x4(a, a_tile(Hb, HS, rs * 16, kc * 16, lane));
#pragma unroll
      for (int np = 0; np < OUT_TILES / 2; ++np) {
        unsigned b[4];
        ldsm_x4(b, b_tiles_nk(W2s, HS, cg * OUT_COLS + np * 16, kc * 16, lane));
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with W2s and Hb
  }

  // 4. epilogue: out = x + bf16(acc + b2), added in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = m0 + rs * 16 + g + 8 * r;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < OUT_TILES; ++j) {
      const int col = cg * OUT_COLS + j * 8 + 2 * t;
      const size_t off = (size_t)gr * D + col;
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + off);
      const __nv_bfloat162 hb = __floats2bfloat162_rn(
          acc[j][2 * r] + b2[col], acc[j][2 * r + 1] + b2[col + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(
          __low2float(xv) + __low2float(hb), __high2float(xv) + __high2float(hb));
    }
  }
}

}  // namespace

extern "C" int dtt_fused_ln_mlp(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const void* ln_w, const void* ln_b, void* out,
                                int m, int d,
                                int h, float eps, void* stream) {
  if (d != D || h <= 0 || h % HC != 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_ln_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  fused_ln_mlp_kernel<<<(m + BM - 1) / BM, NTHREADS, SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<bf16*>(out), m, h, eps);
  return (int)cudaGetLastError();
}
