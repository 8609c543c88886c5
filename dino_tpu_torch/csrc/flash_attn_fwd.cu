// Flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of dino_tpu/ops/attention.py:
//   _flash_kernel (launched by _resident_call from flash_attention ->
//     _flash_fwd_impl) and the resident-split ladder around it: one
//     K/V-streaming loop covers any sequence length, so there is no
//     per-slice rerun and no partial merge;
//   _flash_kernel_chunked (the same forward past 8 resident slices, with the
//     running state carried across a K-chunk grid axis, no LSE): the same
//     streaming loop, entry dtt_flash_attn_fwd at any n;
//   _flash_kernel_dyn (launched by _dyn_fwd_call from
//     flash_attention_with_lse_dyn, once per ring-attention hop): entry
//     dtt_flash_attn_fwd_dyn, where q has nq rows, k/v have nk rows and a
//     runtime bound `valid` masks every key >= valid.  The bound is a kernel
//     argument, the counterpart of scalar prefetch; key tiles wholly past it
//     are not visited (a masked tile adds exactly 0 to l and acc), and the
//     LSE is always written.  At valid = 0 no tile is visited: O = 0 and
//     lse = -1e30 + log(1e-30) = -1e30, which the ring's merge weighs 0.
//
// What bounds it: at the ViT-S/8 480px shapes (B*nh = 18, N = 3,601,
// hd = 64) attention is 4*N^2*hd*B*nh = 6.0e10 FLOP against 33 MB of
// q/k/v/out, ~1,800 FLOP per byte, far above the card's ~295 FLOP/byte ridge:
// it is bound by operations, in both dtypes.
//
// bf16: both products on wgmma (bf16 in, f32 accumulate), warp-specialized
// as the bf16 backward: a producer warp keeps Q and a ring of K/V tiles in
// flight by TMA, and consumer warpgroups of 64 query rows keep their scores,
// probabilities and output accumulator in registers, so the softmax never
// touches shared memory; each warpgroup issues the next tile's Q.K^T ahead
// of this tile's P.V and runs the next softmax while P.V is in flight (see
// flash_fwd_bf16).  128 query rows per block halve the K/V traffic from L2
// against 64-row blocks (each block streams its head's whole K and V).
//
// f32 (the parity mode): float32 on the CUDA cores peaks at 67 TFLOP/s; the
// TF32 tensor cores at 495.  So both products run as three TF32 products
// each (the split below), which carries about 22 bits of every operand: the
// route PyTorch's own f32 attention takes (the memory-efficient CUTLASS
// kernel's OpMultiplyAddFastF32), and errors at float32's level, where one
// TF32 pass would not do (tests/test_torch_port_tf32x3.py).  wgmma (TF32,
// m64n64k8) with Q's halves as register operands, a TMA-fed K/V ring; see
// flash_fwd_f32.
//
// Contract (identical to the JAX kernel's numerics):
//   S = (Q.K^T) in f32, then * scale      (scale after the product)
//   keys >= valid are masked to -1e30      (ragged last tile; valid = n
//                                           for the single-device forward)
//   online softmax in f32; l sums the unrounded p; bf16 takes
//   p = 2^(S*(scale*log2 e) - m*log2 e) by one FMA and ex2 (within
//   FLASH_TOL and LSE_ATOL of exp(S*scale - m): tests/test_torch_port_fwd_mlp_emul.py),
//   f32 p = exp(S*scale - m)
//   P is rounded to the input dtype before P.V (bf16; in f32 it is split
//                                           into its two TF32 halves)
//   O = acc / max(l, 1e-30), stored in the input dtype
//   lse = m + log(max(l, 1e-30)), f32, (B*nh, N), optional
//
// Layout: q, o are (B*nh, nq, 64), k, v (B*nh, nk, 64), all contiguous;
// lse (B*nh, nq).  bf16: grid (ceil(nq/FB_BQ), B*nh), FB_THREADS threads
// (FB_CONSUMERS warpgroups of 64 query rows, one producer warpgroup).  f32:
// grid (ceil(nq/128), B*nh), 256 threads.  K/V rows >= valid (and, in
// bf16, Q rows >= nq) are zero-filled on load by TMA's out-of-bounds fill
// over tensor maps of `valid` (nq) rows; f32 Q rows >= nq load as zeros.
// Such rows are never used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace dtt;

constexpr int HD = 64;          // head dim
constexpr int BK = 64;          // keys per f32 tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- bf16 ---
// Warp-specialized: FB_CONSUMERS warpgroups of 64 query rows each, then a
// producer warpgroup of which one thread works.  The producer loads the
// block's Q tiles once and keeps a ring of FB_STAGES K/V tiles in flight by
// TMA (128-byte swizzle, a full and an empty mbarrier per stage; K/V maps of
// `valid` rows, so TMA zero-fills the ragged tile), and gives its registers
// up (setmaxnreg) to the consumers.  A consumer warpgroup keeps its Q rows
// as wgmma A fragments (ldmatrix, once), runs S = Q.K^T as wgmma
// m64n{FB_BK}k16 against the K-major K tile, and O += bf16(P).V as wgmma
// m64n64k16 with P's accumulator registers packed into bf16 pairs as the A
// fragment and V as the MN-major B operand.  Tile j+1's S product is issued
// before tile j's P.V, so tile j+1's softmax runs while P.V is on the tensor
// cores; O is rescaled by tile j+1's alpha once P.V has landed.  Interior
// key tiles skip the mask.

constexpr int FB_CONSUMERS = 2;   // consumer warpgroups, 64 query rows each
constexpr int FB_BK = 128;        // keys per tile
constexpr int FB_STAGES = 4;      // K/V ring depth
constexpr int FB_BLOCKS = 1;      // blocks per SM
constexpr int FB_BQ = 64 * FB_CONSUMERS;
constexpr int FB_THREADS = 128 * (FB_CONSUMERS + 1);
constexpr int FB_PRODUCER = 4 * FB_CONSUMERS;  // the producer's warp index
constexpr int FB_REGS_PRODUCER = 24;
// registers a thread: ptxas gives every thread the launch bound's share
// (FB_REGS_LAUNCH); the producer group gives all but 24 back and the
// consumers take them (setmaxnreg draws on the block's own registers)
constexpr int FB_REGS_LAUNCH = 65536 / (FB_BLOCKS * FB_THREADS) / 8 * 8;
constexpr int FB_REGS_CONSUMER_MAX =
    FB_REGS_LAUNCH + (FB_REGS_LAUNCH - FB_REGS_PRODUCER) / FB_CONSUMERS;
constexpr int FB_REGS_CONSUMER =
    FB_REGS_CONSUMER_MAX >= 240 ? 240 : FB_REGS_CONSUMER_MAX / 8 * 8;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int Q_TILE = 64 * 128;       // 64 rows x 64 bf16, swizzled
constexpr int KV_TILE = FB_BK * 128;   // FB_BK rows x 64 bf16, swizzled
constexpr int SMEM_BF16 = FB_CONSUMERS * Q_TILE + FB_STAGES * 2 * KV_TILE +
                          (1 + 2 * FB_STAGES) * 8 + 1024;  // + align

// online softmax of one tile's raw scores S = Q.K^T in place (s <- p,
// unrounded), rows g (e = 0, 1) and g+8 (e = 2, 3) of each 8-key slice; the
// row's four lanes (same g) combine their maxima with two shuffles.  MASK
// sets keys >= valid to -1e30.  The row max m is of the scaled scores
// (scale > 0, so max(S)*scale rounds as max(S*scale)), and
// p = 2^(S*(scale*log2 e) - m*log2 e): one FMA and one ex2 per score.
template <bool MASK, int NR>
__device__ __forceinline__ void softmax_tile(float (&s)[NR], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int valid, int t,
                                             float scale) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NR / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && k0 + j * 8 + 2 * t + (e & 1) >= valid) s[4 * j + e] = NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
  float ml[2];  // m * log2 e
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale);
    alpha[r] = ex2((m[r] - m_new) * LOG2E);
    m[r] = m_new;
    ml[r] = m_new * LOG2E;
  }
  const float sl = scale * LOG2E;
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NR / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl, -ml[e >> 1]));
      rsum[e >> 1] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
}

template <int NR>
__device__ __forceinline__ void softmax_any(float (&s)[NR], float (&m)[2],
                                            float (&l)[2], float (&alpha)[2],
                                            int k0, int valid, int t,
                                            float scale) {
  if (k0 + FB_BK <= valid)  // an interior tile: no mask
    softmax_tile<false>(s, m, l, alpha, k0, valid, t, scale);
  else
    softmax_tile<true>(s, m, l, alpha, k0, valid, t, scale);
}

// S (64 x FB_BK) = Q.K^T of one key tile, one wgmma group: Q rows and K
// rows from their swizzled tiles, both K-major (32 bytes per k-step)
template <int NR>
__device__ __forceinline__ void score_issue(float (&s)[NR], uint64_t dq,
                                            const unsigned char* kt) {
  const uint64_t dk = sw128_desc(kt);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_bf16_ss(s, dq + 2 * kk, dk + 2 * kk);
  wgmma_commit();
}

// O (64 x 64) += bf16(P) . V of one key tile, one wgmma group: P as register
// A fragments, V the MN-major B operand (16 key rows, 2048 bytes a k-step)
__device__ __forceinline__ void pv_issue(float (&oacc)[32],
                                         const unsigned (&pa)[FB_BK / 16][4],
                                         const unsigned char* vt) {
  const uint64_t dv = sw128_desc(vt);
#pragma unroll
  for (int kc = 0; kc < FB_BK / 16; ++kc)
    wgmma_bf16_rs<1>(oacc, pa[kc], dv + 128 * kc);
  wgmma_commit();
}

// K and V rows [tile*FB_BK, ..) of head bh -> stage st of the ring
__device__ __forceinline__ void kv_load(const CUtensorMap* kmap,
                                        const CUtensorMap* vmap,
                                        unsigned char* Ks, unsigned char* Vs,
                                        uint64_t* full, int tile, int bh) {
  const int st = tile % FB_STAGES;
  mbar_arrive_expect_tx(&full[st], 2 * KV_TILE);
  tma_load_3d(Ks + st * KV_TILE, kmap, &full[st], 0, tile * FB_BK, bh);
  tma_load_3d(Vs + st * KV_TILE, vmap, &full[st], 0, tile * FB_BK, bh);
}

__global__ void __launch_bounds__(FB_THREADS, FB_BLOCKS)
flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               bf16* __restrict__ o, float* __restrict__ lse, int nq,
               int valid, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);             // FB_CONSUMERS tiles
  unsigned char* Ks = Qs + FB_CONSUMERS * Q_TILE;      // FB_STAGES tiles
  unsigned char* Vs = Ks + FB_STAGES * KV_TILE;        // FB_STAGES tiles
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(Vs + FB_STAGES * KV_TILE);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + FB_STAGES;

  const int bh = blockIdx.y, q0 = blockIdx.x * FB_BQ, tid = threadIdx.x;
  const int ntiles = (valid + FB_BK - 1) / FB_BK;  // valid = 0: none
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < FB_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * FB_CONSUMERS);  // one lane per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  // Q first, ahead of the register hand-over below (the consumers'
  // setmaxnreg.inc waits for the producer's .dec), so its load latency
  // overlaps the hand-over
  if (tid == FB_PRODUCER * 32 && ntiles > 0) {
    mbar_arrive_expect_tx(q_bar, FB_CONSUMERS * Q_TILE);
    for (int c = 0; c < FB_CONSUMERS; ++c)  // rows >= nq are 0
      tma_load_3d(Qs + c * Q_TILE, &qmap, q_bar, 0, q0 + 64 * c, bh);
  }
  if (warp >= FB_PRODUCER) {
    setmaxnreg_dec<FB_REGS_PRODUCER>();
    if (tid == FB_PRODUCER * 32)
      for (int tile = 0; tile < ntiles; ++tile) {
        mbar_wait(&empty[tile % FB_STAGES], ((tile / FB_STAGES) & 1) ^ 1);
        kv_load(&kmap, &vmap, Ks, Vs, full, tile, bh);
      }
    return;
  }

  // consumer warpgroup c: query rows q0 + 64c + [0, 64)
  setmaxnreg_inc<FB_REGS_CONSUMER>();
  const int c = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of rows g, g+8
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum
  if (ntiles > 0) {
    mbar_wait(q_bar, 0);
    const uint64_t dq = sw128_desc(Qs + c * Q_TILE);  // this group's Q rows
    float s[FB_BK / 2], alpha[2];
    unsigned pa[FB_BK / 16][4];  // bf16(P) of the tile, A fragments

    // tile 0's scores and softmax
#pragma unroll
    for (int i = 0; i < FB_BK / 2; ++i) s[i] = 0.f;
    mbar_wait(&full[0], 0);
    reg_fence(s);
    wgmma_fence();
    score_issue(s, dq, Ks);
    wgmma_wait<0>();
    reg_fence(s);
    softmax_any(s, m, l, alpha, 0, valid, t, scale);
#pragma unroll
    for (int kc = 0; kc < FB_BK / 16; ++kc) acc_to_a(pa[kc], s, kc);

    for (int tile = 0; tile < ntiles; ++tile) {
      const int st = tile % FB_STAGES;
      if (tile + 1 < ntiles) {
        // tile+1's S ahead of tile's P.V; tile+1's softmax while P.V runs
        const int s1 = (tile + 1) % FB_STAGES;
#pragma unroll
        for (int i = 0; i < FB_BK / 2; ++i) s[i] = 0.f;
        mbar_wait(&full[s1], ((tile + 1) / FB_STAGES) & 1);
        reg_fence(s);
        reg_fence(oacc);
        wgmma_fence();
        score_issue(s, dq, Ks + s1 * KV_TILE);
        pv_issue(oacc, pa, Vs + st * KV_TILE);
        wgmma_wait<1>();
        reg_fence(s);
        softmax_any(s, m, l, alpha, (tile + 1) * FB_BK, valid, t, scale);
        wgmma_wait<0>();
      } else {
        reg_fence(oacc);
        wgmma_fence();
        pv_issue(oacc, pa, Vs + st * KV_TILE);
        wgmma_wait<0>();
      }
      reg_fence(oacc);
#pragma unroll
      for (int kc = 0; kc < FB_BK / 16; ++kc) reg_fence(pa[kc]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with it
      if (tile + 1 < ntiles) {
#pragma unroll
        for (int i = 0; i < 32; ++i) oacc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int kc = 0; kc < FB_BK / 16; ++kc) acc_to_a(pa[kc], s, kc);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    const float lc = fmaxf(l[r], 1e-30f);
    const int qr = q0 + 64 * c + 16 * w + g + 8 * r;
    if (qr < nq) {
      bf16* dst = o + ((size_t)bh * nq + qr) * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
            oacc[4 * j + 2 * r] / lc, oacc[4 * j + 2 * r + 1] / lc);
      if (lse != nullptr && t == 0) lse[(size_t)bh * nq + qr] = m[r] + logf(lc);
    }
  }
}

// ----------------------------------------------------------------- f32 ---
// Both products on the tensor cores as three TF32 products each (hopper.cuh
// split_tf32): S = lo_q.hi_k + hi_q.lo_k + hi_q.hi_k, and the same for
// P.V, small terms first, f32 accumulation.  One warpgroup per 64 query
// rows, two per block (128 rows); Q's hi/lo halves are register A operands
// of wgmma m64n64k8.tf32, loaded once.  Thread 0 keeps the next two raw f32
// K/V tiles in flight by TMA (two stages, one mbarrier each); all 256
// threads split each landed tile into hi/lo tiles (K as it is, V transposed,
// since tf32 wgmma takes only K-major operands), then each warpgroup runs
// its products on the split tile.  The split tiles are double buffered:
// tile j+1 is split while no warp still reads tile j-1's buffer.
//
// P.V without shuffles: P's accumulator registers are the A fragments as
// they sit, and V^T is written with its keys in the order they read them
// (hopper.cuh tf32_kpos).

constexpr int F_BQ = 128;                  // query rows per block
constexpr int F_THREADS = 256;             // 2 consumer warpgroups
constexpr int F_ATOM = 64 * 128;           // 64 rows x 32 f32, swizzled
constexpr int F_TILE = 2 * F_ATOM;         // 64 x 64 f32: hd 0-31, 32-63
constexpr int F_RAW = 2 * F_TILE;          // one stage: raw K, raw V
constexpr int F_SPLIT = 4 * F_TILE;        // hi(K), lo(K), hi(V^T), lo(V^T)
constexpr int SMEM_F32 = 2 * F_RAW + 2 * F_SPLIT + 2 * 8 + 1024;  // + align

// byte offset of element (row, col) of a 64 x 64 f32 tile
__device__ __forceinline__ int f32_off(int row, int col) {
  return f32_tile_off(row, col, 64);
}

// split one landed raw stage into hi/lo K and V^T tiles.  Thread tid takes
// key r = tid % 64 and four of its 16-byte chunks: reads are conflict-free
// (8 consecutive keys hit 8 chunk positions), and a warp's V^T writes fill
// one 128-byte row (32 keys of one hd column)
__device__ __forceinline__ void split_stage(const unsigned char* raw,
                                            unsigned char* sp, int tid) {
  const int r = tid & 63, vc = tf32_kpos(r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = 4 * ((tid >> 6) + 4 * i);  // first of 4 columns
    const int off = f32_off(r, col);
    const float4 kx = *reinterpret_cast<const float4*>(raw + off);
    const float4 vx = *reinterpret_cast<const float4*>(raw + F_TILE + off);
    const float kv[4] = {kx.x, kx.y, kx.z, kx.w};
    const float vv[4] = {vx.x, vx.y, vx.z, vx.w};
    unsigned kh[4], kl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_tf32(kv[e], kh[e], kl[e]);
      unsigned vh, vl;
      split_tf32(vv[e], vh, vl);
      const int vo = f32_off(col + e, vc);
      *reinterpret_cast<unsigned*>(sp + 2 * F_TILE + vo) = vh;
      *reinterpret_cast<unsigned*>(sp + 3 * F_TILE + vo) = vl;
    }
    *reinterpret_cast<uint4*>(sp + off) = make_uint4(kh[0], kh[1], kh[2], kh[3]);
    *reinterpret_cast<uint4*>(sp + F_TILE + off) =
        make_uint4(kl[0], kl[1], kl[2], kl[3]);
  }
}

// raw K and V rows [row, row+64) of head bh -> one stage, each tile as its
// two 32-column atoms; completion on `bar`
__device__ __forceinline__ void issue_kv_f32(const CUtensorMap* kmap,
                                             const CUtensorMap* vmap,
                                             unsigned char* dst, uint64_t* bar,
                                             int row, int bh) {
  mbar_arrive_expect_tx(bar, F_RAW);
  tma_load_3d(dst, kmap, bar, 0, row, bh);
  tma_load_3d(dst + F_ATOM, kmap, bar, 32, row, bh);
  tma_load_3d(dst + F_TILE, vmap, bar, 0, row, bh);
  tma_load_3d(dst + F_TILE + F_ATOM, vmap, bar, 32, row, bh);
}

// descriptor of k-step kk (8 values of the contracted dim) of a split tile
__device__ __forceinline__ uint64_t f32_kdesc(const unsigned char* tile,
                                              int kk) {
  return sw128_desc(tile + (kk >> 2) * F_ATOM + (kk & 3) * 32);
}

__global__ void __launch_bounds__(F_THREADS, 1)
flash_fwd_f32(const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const float* __restrict__ q, float* __restrict__ o,
              float* __restrict__ lse, int nq, int valid, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* raw = smem;                 // 2 stages of F_RAW
  unsigned char* split = smem + 2 * F_RAW;   // 2 buffers of F_SPLIT
  uint64_t* full = reinterpret_cast<uint64_t*>(split + 2 * F_SPLIT);

  const int bh = blockIdx.y, tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * F_BQ + wg * 64 + warp * 16 + g;  // and +8
  const int ntiles = (valid + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < 2 && s < ntiles; ++s)
      issue_kv_f32(&kmap, &vmap, raw + s * F_RAW, &full[s], s * BK, bh);

  // Q rows row0, row0+8 as tf32 hi/lo A fragments, one per 8 of hd
  unsigned qh[HD / 8][4], ql[HD / 8][4];
  const float* qb = q + (size_t)bh * nq * HD;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
      split_tf32(row < nq ? qb[(size_t)row * HD + col] : 0.f, qh[kk][i],
                 ql[kk][i]);
    }
  }

  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of rows g, g+8
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum

  for (int tile = 0; tile < ntiles; ++tile) {
    const int s = tile & 1;
    mbar_wait(&full[s], (tile >> 1) & 1);
    unsigned char* sp = split + s * F_SPLIT;
    split_stage(raw + s * F_RAW, sp, tid);
    fence_proxy_async();
    __syncthreads();  // the split tile is whole; the raw stage is free
    if (tid == 0 && tile + 2 < ntiles)
      issue_kv_f32(&kmap, &vmap, raw + s * F_RAW, &full[s], (tile + 2) * BK,
                   bh);

    // S (64 x 64 per warpgroup) = Q.K^T in three TF32 passes
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    reg_fence(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
      wgmma_tf32_rs(sacc, ql[kk], f32_kdesc(sp, kk));
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
      wgmma_tf32_rs(sacc, qh[kk], f32_kdesc(sp + F_TILE, kk));
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
      wgmma_tf32_rs(sacc, qh[kk], f32_kdesc(sp, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sacc);

    // online softmax on rows g (e = 0, 1) and g+8 (e = 2, 3); the row's four
    // lanes (same g) combine their maxima with two shuffles
    const int k0 = tile * BK;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[4 * j + e] * scale;
        if (k0 + j * 8 + 2 * t + (e & 1) >= valid) x = NEG_INF;
        sacc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float rsum[2] = {0.f, 0.f};
    unsigned ph[BK / 8][4], pl[BK / 8][4];  // P as tf32 hi/lo A fragments
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sacc[4 * j + e] - m[e >> 1]);
        rsum[e >> 1] += p;
        // a[0], a[1]: rows g, g+8 at key 2t; a[2], a[3]: at key 2t+1
        const int a = (e >> 1) | ((e & 1) << 1);
        split_tf32(p, ph[j][a], pl[j][a]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];

    // this tile's P.V in three TF32 passes (V^T's keys are in the
    // fragments' order), in its own accumulator: the tensor cores' f32
    // accumulation truncates, so it sums 24 k-steps at most, and O takes
    // the tile's sum with round-to-nearest arithmetic
    float pv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) pv[i] = 0.f;
    reg_fence(pv);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      wgmma_tf32_rs(pv, pl[j], f32_kdesc(sp + 2 * F_TILE, j));
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      wgmma_tf32_rs(pv, ph[j], f32_kdesc(sp + 3 * F_TILE, j));
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      wgmma_tf32_rs(pv, ph[j], f32_kdesc(sp + 2 * F_TILE, j));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(pv);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {  // the A fragments outlive the wait
      reg_fence(ph[j]);
      reg_fence(pl[j]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      oacc[i] = oacc[i] * alpha[(i >> 1) & 1] + pv[i];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    const float lc = fmaxf(l[r], 1e-30f);
    const int qr = row0 + 8 * r;
    if (qr < nq) {
      float* dst = o + (size_t)bh * nq * HD + (size_t)qr * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(oacc[4 * j + 2 * r] / lc, oacc[4 * j + 2 * r + 1] / lc);
      if (lse != nullptr && t == 0) lse[(size_t)bh * nq + qr] = m[r] + logf(lc);
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int nq, int nk, int valid, int hd, int is_bf16,
           float scale, void* stream) {
  if (hd != HD || nq <= 0 || nk <= 0 || valid < 0 || valid > nk || bh <= 0 ||
      bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap kmap, vmap;
  int err;
  if (is_bf16) {
    // Q seen as nq rows and K/V as `valid` rows of each head: TMA zero-fills
    // the rows past them
    CUtensorMap qmap;
    const CUtensorMapDataType bt = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if ((err = make_rows_map(&qmap, q, bt, 2, bh, nq, nq, 64, 64)) != 0 ||
        (err = make_rows_map(&kmap, k, bt, 2, bh, nk, valid, 64, FB_BK)) != 0 ||
        (err = make_rows_map(&vmap, v, bt, 2, bh, nk, valid, 64, FB_BK)) != 0)
      return err;
    if ((err = (int)cudaFuncSetAttribute(
             flash_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
             SMEM_BF16)) != 0)
      return err;
    const dim3 grid((nq + FB_BQ - 1) / FB_BQ, bh);
    flash_fwd_bf16<<<grid, FB_THREADS, SMEM_BF16, s>>>(
        qmap, kmap, vmap, static_cast<bf16*>(o), static_cast<float*>(lse), nq,
        valid, scale);
    return (int)cudaGetLastError();
  }
  // K/V seen as `valid` rows of each head: TMA zero-fills the ragged tile
  if ((err = make_rows_map(&kmap, k, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bh,
                           nk, valid, 32, BK)) != 0 ||
      (err = make_rows_map(&vmap, v, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bh,
                           nk, valid, 32, BK)) != 0)
    return err;
  // above 48 KB, dynamic shared memory needs an opt-in per kernel
  if ((err = (int)cudaFuncSetAttribute(
           flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
           SMEM_F32)) != 0)
    return err;
  const dim3 grid((nq + F_BQ - 1) / F_BQ, bh);
  flash_fwd_f32<<<grid, F_THREADS, SMEM_F32, s>>>(
      kmap, vmap, static_cast<const float*>(q), static_cast<float*>(o),
      static_cast<float*>(lse), nq, valid, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// _flash_kernel / _flash_kernel_chunked: q, k, v of n rows, every key valid;
// lse may be NULL
extern "C" int dtt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int bh, int n, int hd,
                                  int is_bf16, float scale, void* stream) {
  return launch(q, k, v, o, lse, bh, n, n, n, hd, is_bf16, scale, stream);
}

// _flash_kernel_dyn: q of nq rows, k/v of nk rows, keys >= valid masked,
// lse always written
extern "C" int dtt_flash_attn_fwd_dyn(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int bh, int nq, int nk, int valid,
                                      int hd, int is_bf16, float scale,
                                      void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return launch(q, k, v, o, lse, bh, nq, nk, valid, hd, is_bf16, scale,
                stream);
}
