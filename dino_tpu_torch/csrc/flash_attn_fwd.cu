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
// it is bound by operations.  The bf16 path therefore runs both products on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate) in the
// FlashAttention-2 arrangement: each warp keeps its 16 query rows' scores,
// probabilities and output accumulator in registers, so the softmax never
// touches shared memory, and the next K/V tile streams in (cp.async, double
// buffered) while the current one is used.  The f32 path (the parity mode)
// runs on the CUDA cores in full float32.  wgmma/TMA are later work.
//
// Contract (identical to the JAX kernel's numerics):
//   S = (Q.K^T) in f32, then * scale      (scale after the product)
//   keys >= valid are masked to -1e30      (ragged last tile; valid = n
//                                           for the single-device forward)
//   online softmax in f32; l sums the unrounded p
//   P is rounded to the input dtype before P.V
//   O = acc / max(l, 1e-30), stored in the input dtype
//   lse = m + log(max(l, 1e-30)), f32, (B*nh, N), optional
//
// Layout: q, o are (B*nh, nq, 64), k, v (B*nh, nk, 64), all contiguous;
// lse (B*nh, nq); grid (ceil(nq/64), B*nh); one block of 128 threads per
// (bh, 64-query tile).  Warp w owns query rows [16w, 16w+16) of the tile, so
// everything after the K/V load is warp-local.  K/V rows >= valid are
// zero-filled on load, never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace dtt;

constexpr int HD = 64;          // head dim
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 128;   // 4 warps
constexpr int LD = HD + 8;      // bf16 smem row stride: ldmatrix rows hit
                                // distinct banks
constexpr int KS = HD + 1;      // f32 path: padded K/V row stride
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// 64-row tiles -> smem, rows past n zero-filled (warp_mma.cuh)
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               int r0, int n) {
  load_rows64_bf16<BK, NTHREADS>(dst, LD, src, r0, n);
}

__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int r0, int n) {
  load_rows64_f32<BK, NTHREADS>(dst, KS, src, r0, n);
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

constexpr int SMEM_F32 = 2 * BK * KS * (int)sizeof(float);

// f32: same tiling on the CUDA cores.  Each lane keeps its query row in
// registers and owns keys 2j+half of each tile and output columns 2i+half;
// P never leaves registers (no rounding in f32), the lane pair trades its
// halves with one shuffle per key pair.
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int nq, int nk, int valid,
              float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // BK x KS
  float* Vs = Ks + BK * KS;                    // BK x KS

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * nq * HD, kbase = (size_t)bh * nk * HD;
  const int row = threadIdx.x / 2, half = threadIdx.x % 2;
  const int qr = q0 + row;

  float qv[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d)
    qv[d] = qr < nq ? q[base + (size_t)qr * HD + d] : 0.f;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  float m = NEG_INF, l = 0.f;
  const int ntiles = (valid + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    load_tile_f32(Ks, k + kbase, k0, valid);
    load_tile_f32(Vs, v + kbase, k0, valid);
    __syncthreads();

    float sv[BK / 2];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int key = 2 * j + half;
      const float* kr = Ks + key * KS;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) s = fmaf(qv[d], kr[d], s);
      s *= scale;
      if (k0 + key >= valid) s = NEG_INF;
      sv[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      sv[j] = expf(sv[j] - m_new);
      sum += sv[j];
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    l = l * alpha + sum;
    m = m_new;

    float pv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) pv[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < BK / 2; ++j) {
      const float mine = sv[j];
      const float peer = __shfl_xor_sync(FULL, mine, 1);
      const float p_even = half ? peer : mine;  // key 2j
      const float p_odd = half ? mine : peer;   // key 2j+1
      const float* v_even = Vs + (2 * j) * KS + half;
      const float* v_odd = v_even + KS;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i)
        pv[i] = fmaf(p_odd, v_odd[2 * i], fmaf(p_even, v_even[2 * i], pv[i]));
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = acc[i] * alpha + pv[i];
    __syncthreads();
  }

  const float lc = fmaxf(l, 1e-30f);
  if (qr < nq) {
    float* dst = o + base + (size_t)qr * HD + half;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dst[2 * i] = acc[i] / lc;
    if (lse != nullptr && half == 0) lse[(size_t)bh * nq + qr] = m + logf(lc);
  }
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int nq, int nk, int valid, int hd, int is_bf16,
           float scale, void* stream) {
  if (hd != HD || nq <= 0 || nk <= 0 || valid < 0 || valid > nk || bh <= 0 ||
      bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + BQ - 1) / BQ, bh);
  if (is_bf16) {
    flash_fwd_bf16<<<grid, NTHREADS, SMEM_BF16, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o),
        static_cast<float*>(lse), nq, nk, valid, scale);
  } else {
    flash_fwd_f32<<<grid, NTHREADS, SMEM_F32, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), nq, nk, valid, scale);
  }
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
