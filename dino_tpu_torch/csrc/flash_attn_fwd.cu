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
// bf16: both products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate) in the FlashAttention-2 arrangement: each warp keeps its 16
// query rows' scores, probabilities and output accumulator in registers, so
// the softmax never touches shared memory, and the next K/V tile streams in
// (cp.async, double buffered) while the current one is used.
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
//   online softmax in f32; l sums the unrounded p
//   P is rounded to the input dtype before P.V (bf16; in f32 it is split
//                                           into its two TF32 halves)
//   O = acc / max(l, 1e-30), stored in the input dtype
//   lse = m + log(max(l, 1e-30)), f32, (B*nh, N), optional
//
// Layout: q, o are (B*nh, nq, 64), k, v (B*nh, nk, 64), all contiguous;
// lse (B*nh, nq).  bf16: grid (ceil(nq/64), B*nh), one block of 128 threads
// per (bh, 64-query tile); warp w owns query rows [16w, 16w+16) of the
// tile, so everything after the K/V load is warp-local.  f32: grid
// (ceil(nq/128), B*nh), 256 threads.  K/V rows >= valid are zero-filled on
// load (cp.async zero-fill, or TMA's out-of-bounds fill over a tensor map
// of `valid` rows), never used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace {

using namespace dtt;

constexpr int HD = 64;          // head dim
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 128;   // 4 warps
constexpr int LD = HD + 8;      // bf16 smem row stride: ldmatrix rows hit
                                // distinct banks
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// 64-row tiles -> smem, rows past n zero-filled (warp_mma.cuh)
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               int r0, int n) {
  load_rows64_bf16<BK, NTHREADS>(dst, LD, src, r0, n);
}

constexpr int SMEM_BF16 = (BQ + 4 * BK) * LD * (int)sizeof(bf16);  // Q, 2x(K, V)

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int nq, int nk, int valid,
               float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // BQ x LD
  bf16* Ks = Qs + BQ * LD;                   // 2 buffers of BK x LD
  bf16* Vs = Ks + 2 * BK * LD;               // 2 buffers of BK x LD

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * nq * HD, kbase = (size_t)bh * nk * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row / column pair

  load_tile_bf16(Qs, q + base, q0, nq);
  load_tile_bf16(Ks, k + kbase, 0, valid);
  load_tile_bf16(Vs, v + kbase, 0, valid);
  cp_async_commit();

  unsigned qa[HD / 16][4];      // Q strip as A fragments, one per 16 of hd
  float oacc[HD / 8][4] = {};   // O strip, 16 x 64
  float m[2] = {NEG_INF, NEG_INF};  // running max of rows g, g+8
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum

  const int ntiles = (valid + BK - 1) / BK;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < ntiles) {  // prefetch the next K/V tile
      load_tile_bf16(Ks + (buf ^ 1) * BK * LD, k + kbase, (tile + 1) * BK,
                     valid);
      load_tile_bf16(Vs + (buf ^ 1) * BK * LD, v + kbase, (tile + 1) * BK,
                     valid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc)
        ldsm_x4(qa[kc], a_tile(Qs, LD, warp * 16, kc * 16, lane));
    }
    const bf16* Kt = Ks + buf * BK * LD;
    const bf16* Vt = Vs + buf * BK * LD;

    // S strip (16 x 64) = Q . K^T; K row-major is K^T's column-major B
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        unsigned b[4];
        ldsm_x4(b, b_tiles_nk(Kt, LD, np * 16, kc * 16, lane));
        mma_bf16(s[2 * np], qa[kc], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kc], b[2], b[3]);
      }
    }

    // online softmax on rows g (e = 0, 1) and g+8 (e = 2, 3); the row's four
    // lanes (same g) combine their maxima with two shuffles
    const int k0 = tile * BK;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (k0 + j * 8 + 2 * t + (e & 1) >= valid) x = NEG_INF;
        s[j][e] = x;
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
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        rsum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      oacc[j][0] *= alpha[0];
      oacc[j][1] *= alpha[0];
      oacc[j][2] *= alpha[1];
      oacc[j][3] *= alpha[1];
    }

    // O strip += bf16(P) . V; the S accumulators of key tiles 2kc, 2kc+1 are
    // exactly the A fragment of keys [16kc, 16kc+16)
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const unsigned pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        unsigned b[4];
        ldsm_x4_trans(b, b_tiles_kn(Vt, LD, kc * 16, np * 16, lane));
        mma_bf16(oacc[2 * np], pa, b[0], b[1]);
        mma_bf16(oacc[2 * np + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }
  cp_async_wait<0>();  // valid = 0 visits no tile: drain the first loads

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    const float lc = fmaxf(l[r], 1e-30f);
    const int qr = q0 + warp * 16 + g + 8 * r;
    if (qr < nq) {
      bf16* dst = o + base + (size_t)qr * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
            oacc[j][2 * r] / lc, oacc[j][2 * r + 1] / lc);
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
// P.V without shuffles: the accumulator holds row g's scores at columns
// 2t, 2t+1 of each 8-key slice, the tf32 A fragment wants columns t, t+4.
// The values are used where they sit, read as keys in the order
// 0,2,4,6,1,3,5,7 of each group of 8, and V^T is written in that same key
// order (key p at column (p&1)*4 + (p>>1)); P.V sums over keys, so the
// order does not change the sum's terms.

constexpr int F_BQ = 128;                  // query rows per block
constexpr int F_THREADS = 256;             // 2 consumer warpgroups
constexpr int F_ATOM = 64 * 128;           // 64 rows x 32 f32, swizzled
constexpr int F_TILE = 2 * F_ATOM;         // 64 x 64 f32: hd 0-31, 32-63
constexpr int F_RAW = 2 * F_TILE;          // one stage: raw K, raw V
constexpr int F_SPLIT = 4 * F_TILE;        // hi(K), lo(K), hi(V^T), lo(V^T)
constexpr int SMEM_F32 = 2 * F_RAW + 2 * F_SPLIT + 2 * 8 + 1024;  // + align

// the position of key r (0..63) in V^T's key order
__device__ __forceinline__ int vt_col(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3);
}

// byte offset of element (row, col) of a 64 x 64 f32 tile held as two
// 128-byte-swizzled atoms (cols 0-31, 32-63)
__device__ __forceinline__ int f32_off(int row, int col) {
  return (col >> 5) * F_ATOM + row * 128 +
         ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4;
}

// split one landed raw stage into hi/lo K and V^T tiles.  Thread tid takes
// key r = tid % 64 and four of its 16-byte chunks: reads are conflict-free
// (8 consecutive keys hit 8 chunk positions), and a warp's V^T writes fill
// one 128-byte row (32 keys of one hd column)
__device__ __forceinline__ void split_stage(const unsigned char* raw,
                                            unsigned char* sp, int tid) {
  const int r = tid & 63, vc = vt_col(r);
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
  if (is_bf16) {
    const dim3 grid((nq + BQ - 1) / BQ, bh);
    flash_fwd_bf16<<<grid, NTHREADS, SMEM_BF16, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o),
        static_cast<float*>(lse), nq, nk, valid, scale);
    return (int)cudaGetLastError();
  }
  // K/V seen as `valid` rows of each head: TMA zero-fills the ragged tile
  CUtensorMap kmap, vmap;
  int err;
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
