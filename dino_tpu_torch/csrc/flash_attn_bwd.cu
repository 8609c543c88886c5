// Flash-attention backward for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of dino_tpu/ops/attention.py, and the K/V
// residency splits around them (the loops below stream any N):
//   _flash_bwd_kernel (launched by _flash_bwd_pallas from the custom_vjp
//     rule _flash_bwd_rule): entry dtt_flash_attn_bwd;
//   _flash_bwd_kernel_dyn (launched by _dyn_bwd_call from
//     flash_attention_bwd_dyn, once per hop of the ring-attention backward):
//     entry dtt_flash_attn_bwd_dyn, where Q and dO have nq rows, K and V nk
//     rows, lse and D are the caller's (the ring's global ones), and a
//     runtime bound `valid` kills every key >= valid.  Key tiles wholly past
//     the bound write exact zeros to dK/dV and stop; the dQ loop stops at
//     the last key tile that holds a valid key.  dK/dV rows >= valid are
//     stored as exact zeros (the outputs come from torch.empty).
//
// Given Q, K, V, dO (B*nh, N, 64), the forward's row log-sum-exp lse and
// D = rowsum(dO * O) (B*nh, N) f32, it computes, per (bh) row:
//   P  = exp(S*scale - lse),  S = Q.K^T      (keys >= valid give P = 0)
//   dV = cast(P)^T . dO       dP = dO . V^T
//   dS = cast(P * (dP - D) * scale)
//   dK = dS^T . Q             dQ = dS . K
// with f32 accumulation everywhere, P kept in f32 and rounded to the input
// dtype only as the dV operand, and dq, dk, dv written in f32.
//
// Design.  The TPU kernel walks the q-blocks of one bh in order and keeps
// dK/dV in an output block that stays resident across that walk; CUDA
// blocks run concurrently, so that carry would race.  Here the work is split
// FlashAttention-2 style into two kernels that need no atomics and give the
// same bits on every run:
//   (a) dkdv: one block per (bh, 64-key tile).  K_j and V_j stay in shared
//       memory (and as mma A fragments in registers); the block loops over
//       the q-tiles, recomputes S^T and P^T from the saved lse, and
//       accumulates dK_j and dV_j in registers.
//   (b) dq:   one block per (bh, 64-query tile), the forward's layout.  It
//       loops over the key tiles, recomputes S, P and dP, and accumulates
//       dQ_i in registers.
// (b) recomputes S and dP, so the pair does 7 N^2 hd-sized products where
// one kernel with atomic dQ would do 5.
//
// What bounds it: at the bench's microbatch shapes (B*nh = 12, N = 3,601,
// hd = 64) the function is 10*N^2*hd*B*nh = 1.0e11 FLOP against ~18 MB of
// inputs and outputs: bound by operations.  The bf16 path runs every product
// on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate) with each
// warp's 16-row strips of S, P, dP and dS in registers; the next q (or K/V)
// tile streams in with cp.async, double buffered, while the current one is
// used.  The f32 path (the parity mode) runs on the CUDA cores in full
// float32, with P and dS staged through shared memory.  wgmma/TMA are later
// work.
//
// Layout: all tensors contiguous, (B*nh, nq|nk, 64) and (B*nh, nq); grids
// (ceil(nk/64), B*nh) for dK/dV and (ceil(nq/64), B*nh) for dQ; 128 threads.
// Query rows past nq and key rows past valid are zero-filled on load; query
// rows past nq also get P = 0 and are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace dtt;

constexpr int HD = 64;          // head dim
constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 128;   // 4 warps
constexpr int LD = HD + 8;      // bf16 smem row stride (ldmatrix rows hit
                                // distinct banks)
constexpr int KS = HD + 1;      // f32 smem row stride

// lse and D of query rows [q0, q0+64) -> smem; 0 past n (those rows get
// P = 0 anyway).  Threads 0..63 load lse, 64..127 load D.
__device__ __forceinline__ void load_rowstats(float* ls, float* ds,
                                              const float* lse,
                                              const float* dsum, int q0,
                                              int n) {
  const int i = threadIdx.x % BQ, r = q0 + i;
  if (threadIdx.x < BQ)
    ls[i] = r < n ? lse[r] : 0.f;
  else
    ds[i] = r < n ? dsum[r] : 0.f;
}

// p = exp(s*scale - lse), ds = p*(dp - D)*scale, rounded as the plain
// version's separate tensor ops round (no FMA contraction)
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  return expf(__fsub_rn(__fmul_rn(s, scale), lse));
}
__device__ __forceinline__ float dscore(float p, float dp, float d,
                                        float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, d)), scale);
}

// the A fragment of columns [16c, 16c+16) of a 16-row strip held as mma
// accumulators (x[j] = columns 8j..8j+7), rounded to bf16
__device__ __forceinline__ void acc_to_a(unsigned (&a)[4],
                                         const float (&x)[8][4], int c) {
  a[0] = pack_bf16(x[2 * c][0], x[2 * c][1]);
  a[1] = pack_bf16(x[2 * c][2], x[2 * c][3]);
  a[2] = pack_bf16(x[2 * c + 1][0], x[2 * c + 1][1]);
  a[3] = pack_bf16(x[2 * c + 1][2], x[2 * c + 1][3]);
}

// a warp's 16 x 64 accumulator strip (rows row0 + g, row0 + g + 8) -> f32
// rows of dst that are < n; rows >= zero_from get exact zeros
__device__ __forceinline__ void store_strip(float* dst, const float (&x)[8][4],
                                            int row0, int n, int zero_from,
                                            int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    const bool live = row < zero_from;
    float* d = dst + (size_t)row * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(d + 8 * j) =
          live ? make_float2(x[j][2 * r], x[j][2 * r + 1])
               : make_float2(0.f, 0.f);
  }
}

// ---------------------------------------------------------------- bf16 ---

// K, V once; 2 x (Q, dO) tiles; 2 x (lse, D) rows
constexpr int SMEM_DKDV_BF16 =
    (2 * BK + 4 * BQ) * LD * (int)sizeof(bf16) + 4 * BQ * (int)sizeof(float);

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, float* __restrict__ dk,
                    float* __restrict__ dv, int nq, int nk, int valid,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // BK x LD
  bf16* Vs = Ks + BK * LD;                   // BK x LD
  bf16* Qs = Vs + BK * LD;                   // 2 buffers of BQ x LD
  bf16* Gs = Qs + 2 * BQ * LD;               // 2 buffers of BQ x LD (dO)
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BQ * LD);  // 2 x BQ
  float* Ds = Ls + 2 * BQ;                                 // 2 x BQ

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const size_t qbase = (size_t)bh * nq * HD, kbase = (size_t)bh * nk * HD;
  const float* lse_bh = lse + (size_t)bh * nq;
  const float* d_bh = dsum + (size_t)bh * nq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float dka[HD / 8][4] = {}, dva[HD / 8][4] = {};
  if (k0 >= valid) {  // a dead key tile: exact zeros, no work
    store_strip(dk + kbase, dka, k0 + warp * 16, nk, valid, lane);
    store_strip(dv + kbase, dva, k0 + warp * 16, nk, valid, lane);
    return;
  }
  const bool key_ok[2] = {k0 + warp * 16 + g < valid,
                          k0 + warp * 16 + g + 8 < valid};

  load_rows64_bf16<BK, NTHREADS>(Ks, LD, k + kbase, k0, valid);
  load_rows64_bf16<BK, NTHREADS>(Vs, LD, v + kbase, k0, valid);
  load_rows64_bf16<BQ, NTHREADS>(Qs, LD, q + qbase, 0, nq);
  load_rows64_bf16<BQ, NTHREADS>(Gs, LD, dout + qbase, 0, nq);
  cp_async_commit();
  load_rowstats(Ls, Ds, lse_bh, d_bh, 0, nq);

  unsigned ka[HD / 16][4], va[HD / 16][4];  // this warp's K, V strips

  const int ntiles = (nq + BQ - 1) / BQ;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < ntiles) {  // prefetch the next q-tile
      const int nq0 = (tile + 1) * BQ;
      load_rows64_bf16<BQ, NTHREADS>(Qs + (buf ^ 1) * BQ * LD, LD, q + qbase,
                                     nq0, nq);
      load_rows64_bf16<BQ, NTHREADS>(Gs + (buf ^ 1) * BQ * LD, LD,
                                     dout + qbase, nq0, nq);
      load_rowstats(Ls + (buf ^ 1) * BQ, Ds + (buf ^ 1) * BQ, lse_bh, d_bh,
                    nq0, nq);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) have landed
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        ldsm_x4(ka[kc], a_tile(Ks, LD, warp * 16, kc * 16, lane));
        ldsm_x4(va[kc], a_tile(Vs, LD, warp * 16, kc * 16, lane));
      }
    }
    const bf16* Qt = Qs + buf * BQ * LD;
    const bf16* Gt = Gs + buf * BQ * LD;
    const float* Lt = Ls + buf * BQ;
    const float* Dt = Ds + buf * BQ;

    // S^T = K.Q^T and dP^T = V.dO^T, 16 keys x 64 queries per warp; Q and
    // dO row-major are the column-major B operands
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        unsigned b[4];
        ldsm_x4(b, b_tiles_nk(Qt, LD, np * 16, kc * 16, lane));
        mma_bf16(s[2 * np], ka[kc], b[0], b[1]);
        mma_bf16(s[2 * np + 1], ka[kc], b[2], b[3]);
        ldsm_x4(b, b_tiles_nk(Gt, LD, np * 16, kc * 16, lane));
        mma_bf16(dp[2 * np], va[kc], b[0], b[1]);
        mma_bf16(dp[2 * np + 1], va[kc], b[2], b[3]);
      }
    }

    // P^T and dS^T in place (s <- P, dp <- dS); element e of tile j sits at
    // key row g + 8*(e>>1), query column 8j + 2t + (e&1)
    const int q0 = tile * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        float p = prob(s[j][e], scale, Lt[qc]);
        if (!key_ok[e >> 1] || q0 + qc >= nq) p = 0.f;
        dp[j][e] = dscore(p, dp[j][e], Dt[qc], scale);
        s[j][e] = p;
      }
    }

    // dV += bf16(P^T).dO and dK += bf16(dS^T).Q, contracting the 64 queries
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      unsigned pa[4], da[4];
      acc_to_a(pa, s, kc);
      acc_to_a(da, dp, kc);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        unsigned b[4];
        ldsm_x4_trans(b, b_tiles_kn(Gt, LD, kc * 16, np * 16, lane));
        mma_bf16(dva[2 * np], pa, b[0], b[1]);
        mma_bf16(dva[2 * np + 1], pa, b[2], b[3]);
        ldsm_x4_trans(b, b_tiles_kn(Qt, LD, kc * 16, np * 16, lane));
        mma_bf16(dka[2 * np], da, b[0], b[1]);
        mma_bf16(dka[2 * np + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }
  store_strip(dk + kbase, dka, k0 + warp * 16, nk, valid, lane);
  store_strip(dv + kbase, dva, k0 + warp * 16, nk, valid, lane);
}

// Q, dO once; 2 x (K, V) tiles
constexpr int SMEM_DQ_BF16 = (2 * BQ + 4 * BK) * LD * (int)sizeof(bf16);

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum, float* __restrict__ dq,
                  int nq, int nk, int valid, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // BQ x LD
  bf16* Gs = Qs + BQ * LD;                   // BQ x LD (dO)
  bf16* Ks = Gs + BQ * LD;                   // 2 buffers of BK x LD
  bf16* Vs = Ks + 2 * BK * LD;               // 2 buffers of BK x LD

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t qbase = (size_t)bh * nq * HD, kbase = (size_t)bh * nk * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  load_rows64_bf16<BQ, NTHREADS>(Qs, LD, q + qbase, q0, nq);
  load_rows64_bf16<BQ, NTHREADS>(Gs, LD, dout + qbase, q0, nq);
  load_rows64_bf16<BK, NTHREADS>(Ks, LD, k + kbase, 0, valid);
  load_rows64_bf16<BK, NTHREADS>(Vs, LD, v + kbase, 0, valid);
  cp_async_commit();

  // this lane's query rows g and g+8 of the warp's strip
  bool row_ok[2];
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    row_ok[r] = row < nq;
    lse_r[r] = row_ok[r] ? lse[(size_t)bh * nq + row] : 0.f;
    d_r[r] = row_ok[r] ? dsum[(size_t)bh * nq + row] : 0.f;
  }

  unsigned qa[HD / 16][4], ga[HD / 16][4];  // this warp's Q, dO strips
  float dqa[HD / 8][4] = {};

  const int ntiles = (valid + BK - 1) / BK;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < ntiles) {  // prefetch the next K/V tile
      load_rows64_bf16<BK, NTHREADS>(Ks + (buf ^ 1) * BK * LD, LD, k + kbase,
                                     (tile + 1) * BK, valid);
      load_rows64_bf16<BK, NTHREADS>(Vs + (buf ^ 1) * BK * LD, LD, v + kbase,
                                     (tile + 1) * BK, valid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        ldsm_x4(qa[kc], a_tile(Qs, LD, warp * 16, kc * 16, lane));
        ldsm_x4(ga[kc], a_tile(Gs, LD, warp * 16, kc * 16, lane));
      }
    }
    const bf16* Kt = Ks + buf * BK * LD;
    const bf16* Vt = Vs + buf * BK * LD;

    // S = Q.K^T and dP = dO.V^T, 16 queries x 64 keys per warp
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        unsigned b[4];
        ldsm_x4(b, b_tiles_nk(Kt, LD, np * 16, kc * 16, lane));
        mma_bf16(s[2 * np], qa[kc], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kc], b[2], b[3]);
        ldsm_x4(b, b_tiles_nk(Vt, LD, np * 16, kc * 16, lane));
        mma_bf16(dp[2 * np], ga[kc], b[0], b[1]);
        mma_bf16(dp[2 * np + 1], ga[kc], b[2], b[3]);
      }
    }

    // dS in place of dP; element e of tile j: query row g + 8*(e>>1), key
    // column 8j + 2t + (e&1)
    const int k0 = tile * BK;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = prob(s[j][e], scale, lse_r[r]);
        if (!row_ok[r] || k0 + 8 * j + 2 * t + (e & 1) >= valid) p = 0.f;
        dp[j][e] = dscore(p, dp[j][e], d_r[r], scale);
      }
    }

    // dQ += bf16(dS).K, contracting the 64 keys; K row-major is the
    // row-major [k][n] B operand
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      unsigned da[4];
      acc_to_a(da, dp, kc);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        unsigned b[4];
        ldsm_x4_trans(b, b_tiles_kn(Kt, LD, kc * 16, np * 16, lane));
        mma_bf16(dqa[2 * np], da, b[0], b[1]);
        mma_bf16(dqa[2 * np + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // valid = 0 visits no tile: drain the first loads
  store_strip(dq + qbase, dqa, q0 + warp * 16, nq, nq, lane);
}

// ----------------------------------------------------------------- f32 ---
// Same two kernels on the CUDA cores.  Thread (row = tid/2, half = tid%2)
// owns one key (dkdv) or query (dq) row of the tile, the tile columns
// 2c + half of S/dP, and the output columns 2i + half.

constexpr int TILE_F32 = BQ * KS;  // floats per f32 smem tile

// K, V, Q, dO, P^T, dS^T tiles + lse, D rows
constexpr int SMEM_DKDV_F32 = (6 * TILE_F32 + 2 * BQ) * (int)sizeof(float);

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, float* __restrict__ dk,
                   float* __restrict__ dv, int nq, int nk, int valid,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + TILE_F32;
  float* Qs = Vs + TILE_F32;
  float* Gs = Qs + TILE_F32;
  float* Ps = Gs + TILE_F32;  // P^T  [key][query]
  float* Ss = Ps + TILE_F32;  // dS^T [key][query]
  float* Ls = Ss + TILE_F32;
  float* Ds = Ls + BQ;

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const size_t qbase = (size_t)bh * nq * HD, kbase = (size_t)bh * nk * HD;
  const int row = threadIdx.x / 2, half = threadIdx.x % 2;
  const bool key_ok = k0 + row < valid;
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;

  // a dead key tile (k0 >= valid) skips the loop and stores its zeros
  const int ntiles = k0 < valid ? (nq + BQ - 1) / BQ : 0;
  if (ntiles > 0) {
    load_rows64_f32<BK, NTHREADS>(Ks, KS, k + kbase, k0, valid);
    load_rows64_f32<BK, NTHREADS>(Vs, KS, v + kbase, k0, valid);
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    const int q0 = tile * BQ;
    load_rows64_f32<BQ, NTHREADS>(Qs, KS, q + qbase, q0, nq);
    load_rows64_f32<BQ, NTHREADS>(Gs, KS, dout + qbase, q0, nq);
    load_rowstats(Ls, Ds, lse + (size_t)bh * nq, dsum + (size_t)bh * nq, q0,
                  nq);
    __syncthreads();

    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int c = 0; c < BQ / 2; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float kd = Ks[row * KS + d], vd = Vs[row * KS + d];
#pragma unroll
      for (int c = 0; c < BQ / 2; ++c) {
        const int qc = 2 * c + half;
        s[c] = fmaf(kd, Qs[qc * KS + d], s[c]);
        dp[c] = fmaf(vd, Gs[qc * KS + d], dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < BQ / 2; ++c) {
      const int qc = 2 * c + half;
      float p = prob(s[c], scale, Ls[qc]);
      if (!key_ok || q0 + qc >= nq) p = 0.f;
      Ps[row * KS + qc] = p;
      Ss[row * KS + qc] = dscore(p, dp[c], Ds[qc], scale);
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      const float p = Ps[row * KS + qq], ds = Ss[row * KS + qq];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        dva[i] = fmaf(p, Gs[qq * KS + 2 * i + half], dva[i]);
        dka[i] = fmaf(ds, Qs[qq * KS + 2 * i + half], dka[i]);
      }
    }
    __syncthreads();  // Q, dO, P, dS are refilled next tile
  }
  if (k0 + row < nk) {
    float* dkr = dk + kbase + (size_t)(k0 + row) * HD + half;
    float* dvr = dv + kbase + (size_t)(k0 + row) * HD + half;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      dkr[2 * i] = key_ok ? dka[i] : 0.f;
      dvr[2 * i] = key_ok ? dva[i] : 0.f;
    }
  }
}

// Q, dO, K, V, dS tiles
constexpr int SMEM_DQ_F32 = 5 * TILE_F32 * (int)sizeof(float);

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, float* __restrict__ dq,
                 int nq, int nk, int valid, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + TILE_F32;
  float* Ks = Gs + TILE_F32;
  float* Vs = Ks + TILE_F32;
  float* Ss = Vs + TILE_F32;  // dS [query][key]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t qbase = (size_t)bh * nq * HD, kbase = (size_t)bh * nk * HD;
  const int row = threadIdx.x / 2, half = threadIdx.x % 2;
  const bool row_ok = q0 + row < nq;
  const float lse_r = row_ok ? lse[(size_t)bh * nq + q0 + row] : 0.f;
  const float d_r = row_ok ? dsum[(size_t)bh * nq + q0 + row] : 0.f;

  load_rows64_f32<BQ, NTHREADS>(Qs, KS, q + qbase, q0, nq);
  load_rows64_f32<BQ, NTHREADS>(Gs, KS, dout + qbase, q0, nq);
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;

  const int ntiles = (valid + BK - 1) / BK;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BK;
    load_rows64_f32<BK, NTHREADS>(Ks, KS, k + kbase, k0, valid);
    load_rows64_f32<BK, NTHREADS>(Vs, KS, v + kbase, k0, valid);
    __syncthreads();

    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[row * KS + d], gd = Gs[row * KS + d];
#pragma unroll
      for (int c = 0; c < BK / 2; ++c) {
        const int kc = 2 * c + half;
        s[c] = fmaf(qd, Ks[kc * KS + d], s[c]);
        dp[c] = fmaf(gd, Vs[kc * KS + d], dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      const int kc = 2 * c + half;
      float p = prob(s[c], scale, lse_r);
      if (!row_ok || k0 + kc >= valid) p = 0.f;
      Ss[row * KS + kc] = dscore(p, dp[c], d_r, scale);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float ds = Ss[row * KS + kk];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i)
        dqa[i] = fmaf(ds, Ks[kk * KS + 2 * i + half], dqa[i]);
    }
    __syncthreads();  // K, V, dS are refilled next tile
  }
  if (row_ok) {
    float* dqr = dq + qbase + (size_t)(q0 + row) * HD + half;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dqr[2 * i] = dqa[i];
  }
}

int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* dsum, void* dq, void* dk, void* dv,
           int bh, int nq, int nk, int valid, int hd, int is_bf16,
           float scale, void* stream) {
  if (hd != HD || nq <= 0 || nk <= 0 || valid < 0 || valid > nk || bh <= 0 ||
      bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid_k((nk + BK - 1) / BK, bh), grid_q((nq + BQ - 1) / BQ, bh);
  const float* L = static_cast<const float*>(lse);
  const float* D = static_cast<const float*>(dsum);
  float *dQ = static_cast<float*>(dq), *dK = static_cast<float*>(dk),
        *dV = static_cast<float*>(dv);
  cudaError_t err;
  if (is_bf16) {
    // above 48 KB, dynamic shared memory needs an opt-in per kernel
    if ((err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SMEM_DKDV_BF16)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(flash_bwd_dq_bf16,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SMEM_DQ_BF16)) != cudaSuccess)
      return (int)err;
    const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k),
               *V = static_cast<const bf16*>(v),
               *G = static_cast<const bf16*>(dout);
    flash_bwd_dkdv_bf16<<<grid_k, NTHREADS, SMEM_DKDV_BF16, s>>>(
        Q, K, V, G, L, D, dK, dV, nq, nk, valid, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    flash_bwd_dq_bf16<<<grid_q, NTHREADS, SMEM_DQ_BF16, s>>>(
        Q, K, V, G, L, D, dQ, nq, nk, valid, scale);
  } else {
    if ((err = cudaFuncSetAttribute(flash_bwd_dkdv_f32,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SMEM_DKDV_F32)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(flash_bwd_dq_f32,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SMEM_DQ_F32)) != cudaSuccess)
      return (int)err;
    const float *Q = static_cast<const float*>(q),
                *K = static_cast<const float*>(k),
                *V = static_cast<const float*>(v),
                *G = static_cast<const float*>(dout);
    flash_bwd_dkdv_f32<<<grid_k, NTHREADS, SMEM_DKDV_F32, s>>>(
        Q, K, V, G, L, D, dK, dV, nq, nk, valid, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    flash_bwd_dq_f32<<<grid_q, NTHREADS, SMEM_DQ_F32, s>>>(
        Q, K, V, G, L, D, dQ, nq, nk, valid, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// _flash_bwd_kernel: every tensor of n rows, every key valid.  Launches (a)
// and (b) on one stream; dq, dk, dv are f32 (B*nh, N, 64).
extern "C" int dtt_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* dsum, void* dq, void* dk,
                                  void* dv, int bh, int n, int hd,
                                  int is_bf16, float scale, void* stream) {
  return launch(q, k, v, dout, lse, dsum, dq, dk, dv, bh, n, n, n, hd,
                is_bf16, scale, stream);
}

// _flash_bwd_kernel_dyn: q, dout, lse, dsum, dq of nq rows; k, v, dk, dv of
// nk rows; keys >= valid dead (their dk, dv rows exact zeros)
extern "C" int dtt_flash_attn_bwd_dyn(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dsum,
                                      void* dq, void* dk, void* dv, int bh,
                                      int nq, int nk, int valid, int hd,
                                      int is_bf16, float scale, void* stream) {
  return launch(q, k, v, dout, lse, dsum, dq, dk, dv, bh, nq, nk, valid, hd,
                is_bf16, scale, stream);
}
