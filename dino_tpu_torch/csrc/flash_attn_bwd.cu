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
//   (a) dkdv: one block per (bh, 128 keys).  K and V stay in shared memory
//       (in bf16 also as wgmma A fragments in registers); the block loops
//       over the query tiles, recomputes S^T and P^T from the saved lse, and
//       accumulates dK and dV in registers.
//   (b) dq:   one block per (bh, 128 queries).  It loops over the key tiles
//       below `valid`, recomputes S, P and dP, and accumulates dQ.
// (b) recomputes S and dP, so the pair executes 7 N^2 hd-sized products
// where one kernel with atomic dQ would do 5.  The blocks of (a) and (b) go
// out as one grid, (a)'s first: the shorter (b) blocks fill the last wave
// of (a)'s.
//
// What bounds it: at the bench's microbatch shapes (B*nh = 12, N = 3,601,
// hd = 64) the function is 10*N^2*hd*B*nh = 1.0e11 FLOP against ~18 MB of
// inputs and outputs: bound by operations, on the tensor cores for the
// products and on the f32 pipe for the exp and dS arithmetic between them
// (about 15 instructions per score element, twice: once in each kernel).
// Both dtypes therefore keep the tensor cores fed by Hopper's own means:
// every product is wgmma over 128-byte-swizzled tiles that a producer warp
// keeps in flight by TMA (a ring of stages, mbarriers), and two consumer
// warpgroups of 64 rows each take 240 registers (setmaxnreg) so the score
// tiles and the accumulators stay in registers.  bf16: m64n64k16, bf16 in,
// f32 accumulate; each warpgroup issues tile j's gradient products and tile
// j+1's score products back to back, so one wgmma wait per tile overlaps
// the next tile's products.  f32 (the parity mode): float32 on the CUDA
// cores peaks at 67 TFLOP/s, the TF32 tensor cores at 495, so every
// product runs as three TF32 products (hopper.cuh split_tf32), which keeps
// about 22 bits of every operand, as the f32 forward does; one TF32 pass
// would miss float32's tolerances (tests/test_torch_port_bwd_tf32x3.py).
// See the f32 section for its operand layouts.  The tensor maps are encoded
// on the host (hopper.cuh make_rows_map) with K/V extents of `valid` rows
// and Q/dO extents of nq rows: TMA's out-of-bounds fill supplies the zero
// rows.
//
// Layout: all tensors contiguous, (B*nh, nq|nk, 64) and (B*nh, nq); grid
// (ceil(nk/128) + ceil(nq/128), B*nh), 384 threads, in both dtypes.  Query
// rows past nq get P = 0 (a zero Q row gives S = 0, which the padded lse of
// 0 would turn into P = 1) and are never stored; key rows past valid get
// P = 0 and are stored as exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace dtt;

constexpr int HD = 64;          // head dim

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
// The same two block kinds in one grid, every product on the TF32 tensor
// cores as three passes (hopper.cuh split_tf32: a.b ~ lo_a.hi_b + hi_a.lo_b
// + hi_a.hi_b, small terms first), as the f32 forward runs its products.
// 128 rows per block (64 per consumer warpgroup), streamed tiles of F_T = 32
// rows, 384 threads (2 consumer warpgroups at 240 registers, a producer
// warp keeping an F_STAGES ring of raw f32 tiles in flight by TMA).
//
// TF32 wgmma takes only K-major operands, and A from registers or shared
// memory, B from shared memory:
//   score products (K = hd): S^T = K.Q^T, dP^T = V.dO^T (dkdv) and
//     S = Q.K^T, dP = dO.V^T (dq), m64n32k8.  A is the block's own 64 rows
//     of the warpgroup, resident in shared memory as hi and lo tiles; B the
//     streamed [row][hd] tile as TMA lands it (its hi split in place) and
//     its lo tile.
//   gradient products (K = the streamed rows): dV += P^T.dO, dK += dS^T.Q
//     (dkdv) and dQ += dS.K (dq), m64n64k8.  A is the score accumulator's
//     registers split into hi/lo fragments (hopper.cuh acc_to_tf32_a); B the
//     streamed tile transposed, [hd][row], its rows in the fragments' order
//     (tf32_kpos).
// So the split step writes, per streamed tile: the natural tile's hi in
// place and its lo; and for Q, dO (dkdv) or K (dq) the transposed hi and lo
// tiles.  V needs no transpose (dP = dO.V^T reads it as it is).  Shared
// memory: resident hi/lo 128 KB, the ring 2 x 16 KB, the split tiles 48 KB
// (dkdv) or 32 KB (dq): one split buffer, so the two warpgroups split each
// tile together between two named barriers and then run its products.
//
// The tensor cores' f32 accumulation truncates (the f32 forward drifted
// with it over long key loops), so every tile's gradient product goes into a fresh accumulator and
// is added to the running dK, dV or dQ by the CUDA cores in f32; dV's tile
// product runs before dK's so that they share one accumulator.

constexpr int F_T = 32;                // streamed rows per tile
constexpr int F_STAGES = 2;            // raw tiles in flight
constexpr int F_RES = 64 * 64 * 4;     // a warpgroup's 64 resident rows x 64
constexpr int F_ST = F_T * 64 * 4;     // a streamed 32 x 64 tile (or 64 x 32)
constexpr int F_STAGE = 2 * F_ST;      // one ring stage: two raw tiles

// the 128 resident rows [r0, r0+128) of a tensor map -> hi (two warpgroup
// tiles of 64 rows x two 32-column atoms, as 32-row boxes)
__device__ __forceinline__ void f32_resident_load(unsigned char* dst,
                                                  const CUtensorMap* map,
                                                  uint64_t* bar, int r0,
                                                  int bh) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        tma_load_3d(dst + c * F_RES + a * (F_RES / 2) + h * (F_ST / 2), map,
                    bar, 32 * a, r0 + 64 * c + F_T * h, bh);
}

// raw rows [r0, r0+32) of a tensor map -> one streamed tile (two atoms)
__device__ __forceinline__ void f32_tile_load(unsigned char* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int r0, int bh) {
  tma_load_3d(dst, map, bar, 0, r0, bh);
  tma_load_3d(dst + F_ST / 2, map, bar, 32, r0, bh);
}

// split a resident tile pair (128 rows) in place: hi over the raw values,
// lo into `lo`.  Thread ct of the 256 consumers takes 16-byte chunks with
// consecutive rows in a warp's lanes (conflict-free under the swizzle)
__device__ __forceinline__ void f32_split_resident(unsigned char* hi,
                                                   unsigned char* lo, int ct) {
  for (int i = ct; i < 2 * 64 * 16; i += 256) {
    const int r = i % 64, chunk = (i / 64) % 16, c = i / (64 * 16);
    const int off = c * F_RES + f32_tile_off(r, 4 * chunk, 64);
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// split a landed stage (raw tiles a, b) in place: hi over the raw values;
// lo of a, lo of b; for a, and for b when B_T, the transposed hi and lo
// tiles.  Lane = the row (0..31) of the streamed tile; warp wv of the 8
// consumer warps takes chunks wv, wv+8, wv+16, wv+24 of the 32 (tile,
// 4-column chunk) pairs.  A transposed store of a warp fills one 128-byte
// row (32 rows of one column), so it is conflict-free too.
template <bool B_T>
__device__ __forceinline__ void f32_split_stage(unsigned char* raw,
                                                unsigned char* lo,
                                                unsigned char* tr, int ct) {
  const int r = ct % 32, wv = ct / 32, kp = tf32_kpos(r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pair = wv + 8 * i, which = pair >> 4, col = 4 * (pair & 15);
    const int off = which * F_ST + f32_tile_off(r, col, F_T);
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    unsigned h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(xv[e], h[e], l[e]);
    *reinterpret_cast<uint4*>(raw + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    if (which == 0 || B_T) {  // warp-uniform
      unsigned char* t = tr + which * 2 * F_ST;  // [hd][row]: hi, then lo
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int to = f32_tile_off(col + e, kp, 64);  // one 32-column atom
        *reinterpret_cast<unsigned*>(t + to) = h[e];
        *reinterpret_cast<unsigned*>(t + F_ST + to) = l[e];
      }
    }
  }
}

// descriptor of k-step kk (8 of hd) of a [rows][64] tile
__device__ __forceinline__ uint64_t f32_hd_desc(const unsigned char* tile,
                                                int rows, int kk) {
  return sw128_desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32);
}

// s += a.b^T over hd in three TF32 passes: a (64 resident rows, hi/lo
// tiles), b (32 streamed rows, hi/lo tiles)
__device__ __forceinline__ void f32_score_passes(float (&s)[16],
                                                 const unsigned char* a_hi,
                                                 const unsigned char* a_lo,
                                                 const unsigned char* b_hi,
                                                 const unsigned char* b_lo) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
    wgmma_tf32_ss(s, f32_hd_desc(a_lo, 64, kk), f32_hd_desc(b_hi, F_T, kk));
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
    wgmma_tf32_ss(s, f32_hd_desc(a_hi, 64, kk), f32_hd_desc(b_lo, F_T, kk));
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
    wgmma_tf32_ss(s, f32_hd_desc(a_hi, 64, kk), f32_hd_desc(b_hi, F_T, kk));
}

// acc = x.B over the tile's 32 streamed rows in three TF32 passes, into a
// fresh accumulator: x's hi/lo fragments, B the transposed hi/lo tiles
__device__ __forceinline__ void f32_grad_passes(float (&acc)[32],
                                                const unsigned (&xh)[4][4],
                                                const unsigned (&xl)[4][4],
                                                const unsigned char* t_hi,
                                                const unsigned char* t_lo) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < F_T / 8; ++j)
    wgmma_tf32_rs(acc, xl[j], sw128_desc(t_hi + 32 * j));
#pragma unroll
  for (int j = 0; j < F_T / 8; ++j)
    wgmma_tf32_rs(acc, xh[j], sw128_desc(t_lo + 32 * j));
#pragma unroll
  for (int j = 0; j < F_T / 8; ++j)
    wgmma_tf32_rs(acc, xh[j], sw128_desc(t_hi + 32 * j));
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void f32_frags(unsigned (&h)[4][4],
                                          unsigned (&l)[4][4],
                                          const float (&x)[N]) {
#pragma unroll
  for (int j = 0; j < F_T / 8; ++j) acc_to_tf32_a(h[j], l[j], x, j);
}

// every consumer thread has finished with the split buffer, or has written
// its part of it
__device__ __forceinline__ void consumers_sync() { named_barrier(1, 256); }

// K, V hi and lo (2 warpgroup tiles each); the ring; Q lo, dO lo, Q^T hi/lo,
// dO^T hi/lo; lse, D rows per stage; barriers
constexpr int SMEM_DKDV_F32 = 8 * F_RES + F_STAGES * F_STAGE + 6 * F_ST +
                              F_STAGES * F_T * 2 * 4 +
                              (1 + 2 * F_STAGES) * 8 + 1024;
// Q, dO hi and lo; the ring; K lo, V lo, K^T hi/lo; barriers
constexpr int SMEM_DQ_F32 = 8 * F_RES + F_STAGES * F_STAGE + 4 * F_ST +
                            (1 + 2 * F_STAGES) * 8 + 1024;
constexpr int SMEM_BWD_F32 =
    SMEM_DKDV_F32 > SMEM_DQ_F32 ? SMEM_DKDV_F32 : SMEM_DQ_F32;

// (a) dK/dV of the 128 keys of block kb, looping over 32-query tiles
__device__ __forceinline__ void dkdv_f32_block(
    const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
    const CUtensorMap& gmap, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dk,
    float* __restrict__ dv, int nq, int nk, int valid, float scale,
    unsigned char* smem_raw, int kb) {
  unsigned char* Kh = align1024(smem_raw);  // per warpgroup: keys k0+64c..
  unsigned char* Kl = Kh + 2 * F_RES;
  unsigned char* Vh = Kl + 2 * F_RES;
  unsigned char* Vl = Vh + 2 * F_RES;
  unsigned char* ring = Vl + 2 * F_RES;      // F_STAGES x (Q, dO)
  unsigned char* lo = ring + F_STAGES * F_STAGE;  // Q lo, dO lo
  unsigned char* tr = lo + 2 * F_ST;         // Q^T hi, lo, dO^T hi, lo
  float* Ls = reinterpret_cast<float*>(tr + 4 * F_ST);
  float* Ds = Ls + F_STAGES * F_T;
  uint64_t* res_bar = reinterpret_cast<uint64_t*>(Ds + F_STAGES * F_T);
  uint64_t* full = res_bar + 1;
  uint64_t* empty = full + F_STAGES;

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
    mbar_init(res_bar, 1);
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 8);  // one lane per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int ntiles = (nq + F_T - 1) / F_T;
  const int warp = tid / 32, lane = tid % 32;
  if (warp >= B_PRODUCER) {
    setmaxnreg_dec<B_REGS_PRODUCER>();
    if (warp != B_PRODUCER) return;
    if (lane == 0) {  // K, V rows [k0, k0+128) once; rows >= valid are 0
      mbar_arrive_expect_tx(res_bar, 4 * F_RES);
      f32_resident_load(Kh, &kmap, res_bar, k0, bh);
      f32_resident_load(Vh, &vmap, res_bar, k0, bh);
    }
    const float* lse_bh = lse + (size_t)bh * nq;
    const float* d_bh = dsum + (size_t)bh * nq;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int s = tile % F_STAGES, q = tile * F_T + lane;
      mbar_wait(&empty[s], ((tile / F_STAGES) & 1) ^ 1);
      Ls[s * F_T + lane] = q < nq ? lse_bh[q] : 0.f;  // P = 0 past nq
      Ds[s * F_T + lane] = q < nq ? d_bh[q] : 0.f;
      if (lane == 0) {  // Q, dO rows [q0, q0+32); rows >= nq are 0
        unsigned char* st = ring + s * F_STAGE;
        mbar_arrive_expect_tx(&full[s], F_STAGE);
        f32_tile_load(st, &qmap, &full[s], tile * F_T, bh);
        f32_tile_load(st + F_ST, &gmap, &full[s], tile * F_T, bh);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }
  // consumer warpgroup c: keys k0 + 64c + [0, 64)
  setmaxnreg_inc<B_REGS_CONSUMER>();
  const int c = warp / 4, w = warp % 4, t = lane % 4;
  const int krow = k0 + 64 * c + 16 * w + lane / 4;  // and krow + 8
  const bool key_ok[2] = {krow < valid, krow + 8 < valid};
  const bool keys_live = k0 + 64 * c + 64 <= valid;
  const unsigned char *kh = Kh + c * F_RES, *kl = Kl + c * F_RES;
  const unsigned char *vh = Vh + c * F_RES, *vl = Vl + c * F_RES;
  float dka[32], dva[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(res_bar, 0);
  f32_split_resident(Kh, Kl, tid);
  f32_split_resident(Vh, Vl, tid);  // seen by all after the first barrier

  for (int tile = 0; tile < ntiles; ++tile) {
    const int s = tile % F_STAGES, q0 = tile * F_T;
    unsigned char* st = ring + s * F_STAGE;  // Q, dO: hi after the split
    mbar_wait(&full[s], (tile / F_STAGES) & 1);
    consumers_sync();  // the last tile's products are done
    f32_split_stage<true>(st, lo, tr, tid);
    fence_proxy_async();
    consumers_sync();

    // S^T = K.Q^T and dP^T = V.dO^T (64 keys x 32 queries); element 4j+e
    // sits at key row krow + 8*(e>>1), query column 8j + 2t + (e&1)
    float sc[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
    reg_fence(sc);
    reg_fence(dp);
    wgmma_fence();
    f32_score_passes(sc, kh, kl, st, lo);
    f32_score_passes(dp, vh, vl, st + F_ST, lo + F_ST);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    const bool whole = keys_live && q0 + F_T <= nq;
#pragma unroll
    for (int j = 0; j < F_T / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        float p = prob(sc[4 * j + e], scale, Ls[s * F_T + qc]);
        if (!whole && (!key_ok[e >> 1] || q0 + qc >= nq)) p = 0.f;
        dp[4 * j + e] = dscore(p, dp[4 * j + e], Ds[s * F_T + qc], scale);
        sc[4 * j + e] = p;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s

    // dV += P^T.dO, then dK += dS^T.Q, contracting the tile's queries
    unsigned xh[4][4], xl[4][4];
    f32_frags(xh, xl, sc);
    f32_grad_passes(acc, xh, xl, tr + 2 * F_ST, tr + 3 * F_ST);
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      reg_fence(xh[j]);
      reg_fence(xl[j]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dva[i] += acc[i];
    f32_frags(xh, xl, dp);
    f32_grad_passes(acc, xh, xl, tr, tr + F_ST);
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      reg_fence(xh[j]);
      reg_fence(xl[j]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] += acc[i];
  }
  const int row0 = k0 + 64 * c + 16 * w;
  store_acc(dk + kbase, dka, row0, nk, valid, lane);
  store_acc(dv + kbase, dva, row0, nk, valid, lane);
}

// (b) dQ of the 128 queries of block qb, looping over the 32-key tiles
// below `valid`
__device__ __forceinline__ void dq_f32_block(
    const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
    const CUtensorMap& gmap, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dq, int nq, int valid,
    float scale, unsigned char* smem_raw, int qb) {
  unsigned char* Qh = align1024(smem_raw);  // per warpgroup: queries q0+64c..
  unsigned char* Ql = Qh + 2 * F_RES;
  unsigned char* Gh = Ql + 2 * F_RES;       // dO, the same rows
  unsigned char* Gl = Gh + 2 * F_RES;
  unsigned char* ring = Gl + 2 * F_RES;     // F_STAGES x (K, V)
  unsigned char* lo = ring + F_STAGES * F_STAGE;  // K lo, V lo
  unsigned char* tr = lo + 2 * F_ST;        // K^T hi, lo
  uint64_t* res_bar = reinterpret_cast<uint64_t*>(tr + 2 * F_ST);
  uint64_t* full = res_bar + 1;
  uint64_t* empty = full + F_STAGES;

  const int bh = blockIdx.y, q0 = qb * B_ROWS, tid = threadIdx.x;
  const int ntiles = (valid + F_T - 1) / F_T;  // valid = 0: no tile, dQ = 0
  if (tid == 0) {
    mbar_init(res_bar, 1);
    for (int s = 0; s < F_STAGES; ++s) {
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
      mbar_arrive_expect_tx(res_bar, 4 * F_RES);
      f32_resident_load(Qh, &qmap, res_bar, q0, bh);
      f32_resident_load(Gh, &gmap, res_bar, q0, bh);
      for (int tile = 0; tile < ntiles; ++tile) {
        const int s = tile % F_STAGES;
        unsigned char* st = ring + s * F_STAGE;
        mbar_wait(&empty[s], ((tile / F_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], F_STAGE);
        f32_tile_load(st, &kmap, &full[s], tile * F_T, bh);
        f32_tile_load(st + F_ST, &vmap, &full[s], tile * F_T, bh);
      }
    }
    return;
  }
  // consumer warpgroup c: queries q0 + 64c + [0, 64)
  setmaxnreg_inc<B_REGS_CONSUMER>();
  const int c = warp / 4, w = warp % 4, t = lane % 4;
  const int qrow = q0 + 64 * c + 16 * w + lane / 4;  // and qrow + 8
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
  const unsigned char *qh = Qh + c * F_RES, *ql = Ql + c * F_RES;
  const unsigned char *gh = Gh + c * F_RES, *gl = Gl + c * F_RES;
  float dqa[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
  if (ntiles > 0) {
    mbar_wait(res_bar, 0);
    f32_split_resident(Qh, Ql, tid);
    f32_split_resident(Gh, Gl, tid);
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    const int s = tile % F_STAGES, k0 = tile * F_T;
    unsigned char* st = ring + s * F_STAGE;  // K, V: hi after the split
    mbar_wait(&full[s], (tile / F_STAGES) & 1);
    consumers_sync();  // the last tile's products are done
    f32_split_stage<false>(st, lo, tr, tid);
    fence_proxy_async();
    consumers_sync();

    // S = Q.K^T and dP = dO.V^T (64 queries x 32 keys); element 4j+e sits
    // at query row qrow + 8*(e>>1), key column 8j + 2t + (e&1)
    float sc[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
    reg_fence(sc);
    reg_fence(dp);
    wgmma_fence();
    f32_score_passes(sc, qh, ql, st, lo);
    f32_score_passes(dp, gh, gl, st + F_ST, lo + F_ST);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    const bool whole = rows_live && k0 + F_T <= valid;
#pragma unroll
    for (int j = 0; j < F_T / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = prob(sc[4 * j + e], scale, lse_r[r]);
        if (!whole && (!row_ok[r] || k0 + 8 * j + 2 * t + (e & 1) >= valid))
          p = 0.f;
        dp[4 * j + e] = dscore(p, dp[4 * j + e], d_r[r], scale);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s

    // dQ += dS.K, contracting the tile's keys
    unsigned xh[4][4], xl[4][4];
    f32_frags(xh, xl, dp);
    f32_grad_passes(acc, xh, xl, tr, tr + F_ST);
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      reg_fence(xh[j]);
      reg_fence(xl[j]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] += acc[i];
  }
  store_acc(dq + (size_t)bh * nq * HD, dqa, q0 + 64 * c + 16 * w, nq, nq,
            lane);
}

// (a) and (b) in one grid, as flash_bwd_bf16
__global__ void __launch_bounds__(B_THREADS, 1)
flash_bwd_f32(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap gmap,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv, int nq, int nk, int valid, int nkb,
              float scale) {
  extern __shared__ unsigned char smem_raw[];
  if ((int)blockIdx.x < nkb)
    dkdv_f32_block(qmap, kmap, vmap, gmap, lse, dsum, dk, dv, nq, nk, valid,
                   scale, smem_raw, blockIdx.x);
  else
    dq_f32_block(qmap, kmap, vmap, gmap, lse, dsum, dq, nq, valid, scale,
                 smem_raw, blockIdx.x - nkb);
}

int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* dsum, void* dq, void* dk, void* dv,
           int bh, int nq, int nk, int valid, int hd, int is_bf16,
           float scale, void* stream) {
  if (hd != HD || nq <= 0 || nk <= 0 || valid < 0 || valid > nk || bh <= 0 ||
      bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Q/dO seen as nq rows and K/V as `valid` rows of each head: TMA
  // zero-fills the rows past them.  Boxes of 128 bytes by 64 rows (bf16)
  // or 32 columns by F_T rows (f32)
  const bool b16 = is_bf16 != 0;
  const CUtensorMapDataType dt =
      b16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int el = b16 ? 2 : 4, box_cols = 128 / el, box_rows = b16 ? 64 : F_T;
  CUtensorMap qm, km, vm, gm;
  int rc;
  if ((rc = make_rows_map(&qm, q, dt, el, bh, nq, nq, box_cols, box_rows)) ||
      (rc = make_rows_map(&gm, dout, dt, el, bh, nq, nq, box_cols, box_rows)) ||
      (rc = make_rows_map(&km, k, dt, el, bh, nk, valid, box_cols, box_rows)) ||
      (rc = make_rows_map(&vm, v, dt, el, bh, nk, valid, box_cols, box_rows)))
    return rc;
  auto kernel = b16 ? flash_bwd_bf16 : flash_bwd_f32;
  const int smem = b16 ? SMEM_BWD_BF16 : SMEM_BWD_F32;
  // above 48 KB, dynamic shared memory needs an opt-in per kernel
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nkb = (nk + B_ROWS - 1) / B_ROWS, nqb = (nq + B_ROWS - 1) / B_ROWS;
  kernel<<<dim3(nkb + nqb, bh), B_THREADS, smem, s>>>(
      qm, km, vm, gm, static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), nq, nk, valid, nkb,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// _flash_bwd_kernel: every tensor of n rows, every key valid; dq, dk, dv
// are f32 (B*nh, N, 64).
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
