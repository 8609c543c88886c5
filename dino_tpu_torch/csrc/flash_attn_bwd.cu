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
// FlashAttention-2 style into two kinds of blocks that need no atomics and
// give the same bits on every run (the remat contract and repeated SP steps
// rely on it):
//   (a) dkdv: one block per (bh, 128 keys; 64 in f32).  K and V stay in
//       shared memory (in bf16 also as wgmma A fragments in registers); the
//       block loops over the 64-query tiles, recomputes S^T and P^T from the
//       saved lse, and accumulates dK and dV in registers.
//   (b) dq:   one block per (bh, 128 queries; 64 in f32).  It loops over the
//       64-key tiles below `valid`, recomputes S, P and dP, and accumulates
//       dQ.
// (b) recomputes S and dP, so the pair executes 7 N^2 hd-sized products
// where one kernel with atomic dQ would do 5.  The bf16 blocks of (a) and
// (b) go out as one grid, (a)'s first: the shorter (b) blocks fill the last
// wave of (a)'s.
//
// What bounds it: at the bench's microbatch shapes (B*nh = 12, N = 3,601,
// hd = 64) the function is 10*N^2*hd*B*nh = 1.0e11 FLOP against ~18 MB of
// inputs and outputs: bound by operations, on the tensor cores for the
// products and on the f32 pipe for the exp and dS arithmetic between them
// (about 15 instructions per score element, twice: once in each kernel).
// The bf16 kernels therefore keep the tensor cores fed by Hopper's own
// means: every product is wgmma (m64n64k16, bf16 in, f32 accumulate) over
// 128-byte-swizzled tiles that a producer warp keeps in flight by TMA
// (a 3-stage ring, mbarriers); two consumer warpgroups of 64 rows each take
// 240 registers (setmaxnreg) so P, dP, dS and both accumulators stay in
// registers; and each warpgroup issues tile j's gradient products and tile
// j+1's score products back to back, so one wgmma wait per tile overlaps
// the next tile's products.  The tensor maps are encoded on the host
// (hopper.cuh make_rows_map) with K/V extents of `valid` rows and Q/dO
// extents of nq rows: TMA's out-of-bounds fill supplies the zero rows.  The
// f32 path (the parity mode) runs on the CUDA cores in full float32, with P
// and dS staged through shared memory.
//
// Layout: all tensors contiguous, (B*nh, nq|nk, 64) and (B*nh, nq).  bf16:
// grid (ceil(nk/128) + ceil(nq/128), B*nh), 384 threads.  f32:
// grids (ceil(nk/64), B*nh) and (ceil(nq/64), B*nh), 128 threads, rows
// zero-filled on load.  Query rows past nq get P = 0 (a zero Q row gives
// S = 0, which the padded lse of 0 would turn into P = 1) and are never
// stored; key rows past valid get P = 0 and are stored as exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace {

using namespace dtt;

constexpr int HD = 64;          // head dim
constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 128;   // 4 warps
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

// ---------------------------------------------------------------- bf16 ---
// Every product takes its A operand from registers: the score-like products
// S^T = K.Q^T, dP^T = V.dO^T (dkdv) or S = Q.K^T, dP = dO.V^T (dq) the block's
// own rows, loaded once, against K-major [row][hd] tiles; the gradient
// products P^T, dS^T or dS (the accumulator packed into bf16 pairs is the A
// fragment) against dO, Q or K as MN-major B operands (a [row][hd] tile, K
// running down its rows).  The producer warp fills a ring of B_STAGES tiles
// (and, for dkdv, their lse and D rows) behind a full and an empty mbarrier
// per stage.

constexpr int B_TILE = 64 * 128;   // 64 rows x 64 bf16, 128-byte swizzled
constexpr int B_ROWS = 128;        // keys (dkdv) or queries (dq) per block
constexpr int B_STAGES = 3;
// 2 consumer warpgroups, then a producer warpgroup of which one warp
// works: the producer gives its registers up (setmaxnreg) so that each
// consumer thread can hold its 4 accumulators and fragments (240 registers)
constexpr int B_THREADS = 384;
constexpr int B_PRODUCER = 8;      // the producer's warp index
constexpr int B_REGS_PRODUCER = 24, B_REGS_CONSUMER = 240;

// P^T, dS^T of one 64 x 64 dkdv tile in place (st <- P, dpt <- dS); MASK
// zeroes P of dead keys and of query columns >= nq
template <bool MASK>
__device__ __forceinline__ void dkdv_scores(float (&st)[32], float (&dpt)[32],
                                            const float* Lt, const float* Dt,
                                            const bool (&key_ok)[2], int q0,
                                            int nq, int t, float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * t);
    const float2 d2 = *reinterpret_cast<const float2*>(Dt + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = prob(st[4 * j + e], scale, (e & 1) ? l2.y : l2.x);
      if (MASK && (!key_ok[e >> 1] || q0 + 8 * j + 2 * t + (e & 1) >= nq))
        p = 0.f;
      dpt[4 * j + e] = dscore(p, dpt[4 * j + e], (e & 1) ? d2.y : d2.x, scale);
      st[4 * j + e] = p;
    }
  }
}

// dS of one 64 x 64 dq tile in place of dP; MASK zeroes P of rows >= nq and
// of keys >= valid
template <bool MASK>
__device__ __forceinline__ void dq_scores(const float (&sa)[32],
                                          float (&dpa)[32],
                                          const float (&lse_r)[2],
                                          const float (&d_r)[2],
                                          const bool (&row_ok)[2], int k0,
                                          int valid, int t, float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = prob(sa[4 * j + e], scale, lse_r[r]);
      if (MASK && (!row_ok[r] || k0 + 8 * j + 2 * t + (e & 1) >= valid))
        p = 0.f;
      dpa[4 * j + e] = dscore(p, dpa[4 * j + e], d_r[r], scale);
    }
  }
}

// K, V (2 tiles each); stages of Q, dO tiles and lse, D rows; barriers
constexpr int SMEM_DKDV_BF16 = 4 * B_TILE + B_STAGES * 2 * B_TILE +
                               B_STAGES * 2 * 64 * 4 +
                               (1 + 2 * B_STAGES) * 8 + 1024;
// Q, dO (2 tiles each); stages of K, V tiles; barriers
constexpr int SMEM_DQ_BF16 =
    4 * B_TILE + B_STAGES * 2 * B_TILE + (1 + 2 * B_STAGES) * 8 + 1024;
constexpr int SMEM_BWD_BF16 =
    SMEM_DKDV_BF16 > SMEM_DQ_BF16 ? SMEM_DKDV_BF16 : SMEM_DQ_BF16;

// a warp's 16 rows of a warpgroup accumulator (rows row0 + g, row0 + g + 8)
// -> f32 rows of dst that are < n; rows >= zero_from get exact zeros
__device__ __forceinline__ void store_acc(float* dst, const float (&x)[32],
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
          live ? make_float2(x[4 * j + 2 * r], x[4 * j + 2 * r + 1])
               : make_float2(0.f, 0.f);
  }
}

// the score-like products of one tile, issued as one wgmma group: s = A.B^T
// and dp = A2.B2^T over hd, A and A2 (64 rows) in registers, B and B2 tiles
// [row][hd] (K-major)
__device__ __forceinline__ void score_products(float (&s)[32], float (&dp)[32],
                                               const unsigned (&a)[4][4],
                                               const unsigned (&a2)[4][4],
                                               const unsigned char* b,
                                               const unsigned char* b2) {
  const uint64_t db = sw128_desc(b), db2 = sw128_desc(b2);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  reg_fence(s);
  reg_fence(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)  // 32 bytes per k-step
    wgmma_bf16_rs<0>(s, a[kk], db + 2 * kk);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_bf16_rs<0>(dp, a2[kk], db2 + 2 * kk);
  wgmma_commit();
}

// (a) dK/dV of the 128 keys of block kb, looping over the 64-query tiles
__device__ __forceinline__ void dkdv_block(
    const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
    const CUtensorMap& gmap, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dk,
    float* __restrict__ dv, int nq, int nk, int valid, float scale,
    unsigned char* smem_raw, int kb) {
  unsigned char* Ks = align1024(smem_raw);     // keys k0.., k0+64..
  unsigned char* Vs = Ks + 2 * B_TILE;
  unsigned char* Qs = Vs + 2 * B_TILE;         // B_STAGES tiles
  unsigned char* Gs = Qs + B_STAGES * B_TILE;  // B_STAGES tiles (dO)
  float* Ls = reinterpret_cast<float*>(Gs + B_STAGES * B_TILE);
  float* Ds = Ls + B_STAGES * 64;
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(Ds + B_STAGES * 64);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + B_STAGES;

  const int bh = blockIdx.y, k0 = kb * B_ROWS, tid = threadIdx.x;
  const size_t kbase = (size_t)bh * nk * HD;
  if (k0 >= valid) {  // a dead key block: exact zeros, no work
    const int rows = min(B_ROWS, nk - k0);
    for (int i = tid; i < rows * (HD / 4); i += B_THREADS) {
      const size_t off = kbase + (size_t)(k0 + i / (HD / 4)) * HD + (i % (HD / 4)) * 4;
      *reinterpret_cast<float4*>(dk + off) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dv + off) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 8);  // one lane per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int ntiles = (nq + 63) / 64;
  const int warp = tid / 32, lane = tid % 32;
  if (warp >= B_PRODUCER) {
    setmaxnreg_dec<B_REGS_PRODUCER>();
    if (warp != B_PRODUCER) return;
    if (lane == 0) {  // K, V rows [k0, k0+128) once; rows >= valid are 0
      mbar_arrive_expect_tx(kv_bar, 4 * B_TILE);
      tma_load_3d(Ks, &kmap, kv_bar, 0, k0, bh);
      tma_load_3d(Ks + B_TILE, &kmap, kv_bar, 0, k0 + 64, bh);
      tma_load_3d(Vs, &vmap, kv_bar, 0, k0, bh);
      tma_load_3d(Vs + B_TILE, &vmap, kv_bar, 0, k0 + 64, bh);
    }
    const float* lse_bh = lse + (size_t)bh * nq;
    const float* d_bh = dsum + (size_t)bh * nq;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int s = tile % B_STAGES, q0 = tile * 64;
      mbar_wait(&empty[s], ((tile / B_STAGES) & 1) ^ 1);
      for (int i = lane; i < 64; i += 32) {  // 0 past nq (P = 0 there)
        const int r = q0 + i;
        Ls[s * 64 + i] = r < nq ? lse_bh[r] : 0.f;
        Ds[s * 64 + i] = r < nq ? d_bh[r] : 0.f;
      }
      if (lane == 0) {  // Q, dO rows [q0, q0+64); rows >= nq are 0
        mbar_arrive_expect_tx(&full[s], 2 * B_TILE);
        tma_load_3d(Qs + s * B_TILE, &qmap, &full[s], 0, q0, bh);
        tma_load_3d(Gs + s * B_TILE, &gmap, &full[s], 0, q0, bh);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {  // consumer warpgroup c: keys k0 + 64c + [0, 64)
    setmaxnreg_inc<B_REGS_CONSUMER>();
    const int c = warp / 4, w = warp % 4, t = lane % 4;
    const int krow = k0 + 64 * c + 16 * w + lane / 4;  // and krow + 8
    const bool key_ok[2] = {krow < valid, krow + 8 < valid};
    const bool keys_live = k0 + 64 * c + 64 <= valid;
    float dka[32], dva[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kv_bar, 0);
    unsigned ka[4][4], va[4][4];  // this warp's K and V rows, A fragments
    load_a_frags(ka, Ks + c * B_TILE, w, lane);
    load_a_frags(va, Vs + c * B_TILE, w, lane);

    // S^T = K.Q^T and dP^T = V.dO^T (64 keys x 64 queries) of tile 0; each
    // iteration then issues tile j's gradient products and, behind them,
    // tile j+1's score products
    float st[32], dpt[32];
    unsigned pa[4][4], da[4][4];
    mbar_wait(&full[0], 0);
    score_products(st, dpt, ka, va, Qs, Gs);
    for (int tile = 0; tile < ntiles; ++tile) {
      const int s = tile % B_STAGES, q0 = tile * 64;
      const unsigned char* Qt = Qs + s * B_TILE;
      const unsigned char* Gt = Gs + s * B_TILE;
      wgmma_wait<0>();
      reg_fence(st);
      reg_fence(dpt);

      // P^T and dS^T in place (st <- P, dpt <- dS); element 4j+e sits at
      // key row krow + 8*(e>>1), query column 8j + 2t + (e&1)
      if (keys_live && q0 + 64 <= nq)  // a whole tile: no mask
        dkdv_scores<false>(st, dpt, Ls + s * 64, Ds + s * 64, key_ok, q0, nq,
                           t, scale);
      else
        dkdv_scores<true>(st, dpt, Ls + s * 64, Ds + s * 64, key_ok, q0, nq,
                          t, scale);

      // dV += bf16(P^T).dO and dK += bf16(dS^T).Q, contracting the queries
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        acc_to_a(pa[kc], st, kc);
        acc_to_a(da[kc], dpt, kc);
      }
      const uint64_t dg = sw128_desc(Gt), dq_ = sw128_desc(Qt);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)  // 16 rows, 2048 bytes per k-step
        wgmma_bf16_rs<1>(dva, pa[kc], dg + 128 * kc);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_bf16_rs<1>(dka, da[kc], dq_ + 128 * kc);
      wgmma_commit();
      if (tile + 1 < ntiles) {
        const int s1 = (tile + 1) % B_STAGES;
        mbar_wait(&full[s1], ((tile + 1) / B_STAGES) & 1);
        score_products(st, dpt, ka, va, Qs + s1 * B_TILE, Gs + s1 * B_TILE);
        wgmma_wait<1>();  // tile's gradient products are done
      } else {
        wgmma_wait<0>();
      }
      reg_fence(dva);
      reg_fence(dka);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        reg_fence(pa[kc]);
        reg_fence(da[kc]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with it
    }
    const int row0 = k0 + 64 * c + 16 * w;
    store_acc(dk + kbase, dka, row0, nk, valid, lane);
    store_acc(dv + kbase, dva, row0, nk, valid, lane);
  }
}

// (b) dQ of the 128 queries of block qb, looping over the 64-key tiles
// below `valid`
__device__ __forceinline__ void dq_block(
    const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
    const CUtensorMap& gmap, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dq, int nq, int valid,
    float scale, unsigned char* smem_raw, int qb) {
  unsigned char* Qs = align1024(smem_raw);     // queries q0.., q0+64..
  unsigned char* Gs = Qs + 2 * B_TILE;         // dO, the same rows
  unsigned char* Ks = Gs + 2 * B_TILE;         // B_STAGES tiles
  unsigned char* Vs = Ks + B_STAGES * B_TILE;  // B_STAGES tiles
  uint64_t* qg_bar = reinterpret_cast<uint64_t*>(Vs + B_STAGES * B_TILE);
  uint64_t* full = qg_bar + 1;
  uint64_t* empty = full + B_STAGES;

  const int bh = blockIdx.y, q0 = qb * B_ROWS, tid = threadIdx.x;
  const int ntiles = (valid + 63) / 64;  // valid = 0: no tile, dQ = 0
  if (tid == 0) {
    mbar_init(qg_bar, 1);
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (warp >= B_PRODUCER) {
    setmaxnreg_dec<B_REGS_PRODUCER>();
    if (warp == B_PRODUCER && lane == 0 && ntiles > 0) {
      mbar_arrive_expect_tx(qg_bar, 4 * B_TILE);
      tma_load_3d(Qs, &qmap, qg_bar, 0, q0, bh);
      tma_load_3d(Qs + B_TILE, &qmap, qg_bar, 0, q0 + 64, bh);
      tma_load_3d(Gs, &gmap, qg_bar, 0, q0, bh);
      tma_load_3d(Gs + B_TILE, &gmap, qg_bar, 0, q0 + 64, bh);
      for (int tile = 0; tile < ntiles; ++tile) {
        const int s = tile % B_STAGES;
        mbar_wait(&empty[s], ((tile / B_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * B_TILE);
        tma_load_3d(Ks + s * B_TILE, &kmap, &full[s], 0, tile * 64, bh);
        tma_load_3d(Vs + s * B_TILE, &vmap, &full[s], 0, tile * 64, bh);
      }
    }
  } else {  // consumer warpgroup c: queries q0 + 64c + [0, 64)
    setmaxnreg_inc<B_REGS_CONSUMER>();
    const int c = warp / 4, w = warp % 4, t = lane % 4;
    // this lane's query rows qrow and qrow + 8
    const int qrow = q0 + 64 * c + 16 * w + lane / 4;
    const bool rows_live = q0 + 64 * c + 64 <= nq;
    bool row_ok[2];
    float lse_r[2], d_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + 8 * r;
      row_ok[r] = row < nq;
      lse_r[r] = row_ok[r] ? lse[(size_t)bh * nq + row] : 0.f;
      d_r[r] = row_ok[r] ? dsum[(size_t)bh * nq + row] : 0.f;
    }
    float dqa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
    if (ntiles > 0) {
      mbar_wait(qg_bar, 0);
      unsigned qa[4][4], ga[4][4];  // this warp's Q and dO rows
      load_a_frags(qa, Qs + c * B_TILE, w, lane);
      load_a_frags(ga, Gs + c * B_TILE, w, lane);

      // S = Q.K^T and dP = dO.V^T (64 queries x 64 keys) of tile 0; each
      // iteration then issues tile j's dQ product and, behind it, tile
      // j+1's score products
      float sa[32], dpa[32];
      unsigned da[4][4];
      mbar_wait(&full[0], 0);
      score_products(sa, dpa, qa, ga, Ks, Vs);
      for (int tile = 0; tile < ntiles; ++tile) {
        const int s = tile % B_STAGES, k0 = tile * 64;
        wgmma_wait<0>();
        reg_fence(sa);
        reg_fence(dpa);

        // dS in place of dP; element 4j+e: query row qrow + 8*(e>>1), key
        // column 8j + 2t + (e&1)
        if (rows_live && k0 + 64 <= valid)  // a whole tile: no mask
          dq_scores<false>(sa, dpa, lse_r, d_r, row_ok, k0, valid, t, scale);
        else
          dq_scores<true>(sa, dpa, lse_r, d_r, row_ok, k0, valid, t, scale);

        // dQ += bf16(dS).K, contracting the keys
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a(da[kc], dpa, kc);
        const uint64_t dk_ = sw128_desc(Ks + s * B_TILE);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)  // 16 rows, 2048 bytes per k-step
          wgmma_bf16_rs<1>(dqa, da[kc], dk_ + 128 * kc);
        wgmma_commit();
        if (tile + 1 < ntiles) {
          const int s1 = (tile + 1) % B_STAGES;
          mbar_wait(&full[s1], ((tile + 1) / B_STAGES) & 1);
          score_products(sa, dpa, qa, ga, Ks + s1 * B_TILE, Vs + s1 * B_TILE);
          wgmma_wait<1>();  // tile's dQ product is done
        } else {
          wgmma_wait<0>();
        }
        reg_fence(dqa);
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) reg_fence(da[kc]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
    store_acc(dq + (size_t)bh * nq * HD, dqa, q0 + 64 * c + 16 * w, nq, nq,
              lane);
  }
}

// (a) and (b) in one grid: blocks [0, nkb) of x are dK/dV blocks, the rest
// dQ blocks, so that the dQ blocks fill the last wave of the longer dK/dV
// blocks
__global__ void __launch_bounds__(B_THREADS, 1)
flash_bwd_bf16(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap gmap,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               float* __restrict__ dq, float* __restrict__ dk,
               float* __restrict__ dv, int nq, int nk, int valid, int nkb,
               float scale) {
  extern __shared__ unsigned char smem_raw[];
  if ((int)blockIdx.x < nkb)
    dkdv_block(qmap, kmap, vmap, gmap, lse, dsum, dk, dv, nq, nk, valid, scale,
               smem_raw, blockIdx.x);
  else
    dq_block(qmap, kmap, vmap, gmap, lse, dsum, dq, nq, valid, scale,
             smem_raw, blockIdx.x - nkb);
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
    // Q/dO seen as nq rows and K/V as `valid` rows of each head: TMA
    // zero-fills the rows past them
    CUtensorMap qm, km, vm, gm;
    int rc;
    const CUtensorMapDataType bt = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if ((rc = make_rows_map(&qm, q, bt, 2, bh, nq, nq, 64, 64)) != 0 ||
        (rc = make_rows_map(&gm, dout, bt, 2, bh, nq, nq, 64, 64)) != 0 ||
        (rc = make_rows_map(&km, k, bt, 2, bh, nk, valid, 64, 64)) != 0 ||
        (rc = make_rows_map(&vm, v, bt, 2, bh, nk, valid, 64, 64)) != 0)
      return rc;
    // above 48 KB, dynamic shared memory needs an opt-in per kernel
    if ((err = cudaFuncSetAttribute(flash_bwd_bf16,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SMEM_BWD_BF16)) != cudaSuccess)
      return (int)err;
    const int nkb = (nk + B_ROWS - 1) / B_ROWS, nqb = (nq + B_ROWS - 1) / B_ROWS;
    flash_bwd_bf16<<<dim3(nkb + nqb, bh), B_THREADS, SMEM_BWD_BF16, s>>>(
        qm, km, vm, gm, L, D, dQ, dK, dV, nq, nk, valid, nkb, scale);
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
