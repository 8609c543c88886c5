// Fused LayerNorm + MLP + residual for NVIDIA Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel dino_tpu/ops/fused_mlp.py:_kernel
// (launched by fused_ln_mlp_residual), the second half of every ViT block
// on the bf16 eval path:  out = x + fc2(gelu(fc1(LN(x)))).
//
// What bounds it: at 480px batch 3 (M = 10,803 token rows, D = 384,
// H = 1,536) the two products are 4*M*D*H = 2.5e10 FLOP against ~19 MB of
// x, out and weights, ~1,300 FLOP per byte: bound by operations, as far as
// device memory goes.  The weights (2.4 MB, L2-resident) are streamed from
// L2 by every block, 64 FLOP per L2 byte.  What sets the time is latency
// inside the block: clock64 stamps of one block (cli/kernel_variants.py
// --trace) put each chunk at ~3.5k cycles, in series in the same warps: the
// wait for the chunk's W2 (~0.7k), the fc1 issue (~1.45k: the issuing
// warps stall while their 24 narrow wgmma run), the GELU (~1.1k); LN takes
// ~9k cycles a block.  The (M, H) hidden activation never goes to device
// memory.
//
// Design: a block takes 64 rows with two consumer warpgroups and a producer
// warpgroup (setmaxnreg: 240 / 24 registers).  The consumers normalize the
// rows into shared memory in the 128-byte-swizzled layout wgmma reads (6
// atoms of 64 columns), then stream the hidden dimension in chunks of 64:
//     h_c  = bf16(gelu_as(LN(x) . W1[c]^T + b1[c]))     (64 x 64, smem)
//     acc += h_c . W2[:, c]^T                            (64 x 384, registers)
// Warpgroup cc owns output columns [192cc, 192cc+192) (96 f32 registers a
// thread) and computes fc1 of hidden columns [32cc, 32cc+32) of each chunk
// (wgmma m64n32k16, both operands from shared memory); the two halves of h_c
// meet in shared memory (double buffered, a named barrier per chunk) as the
// A operand of fc2 (wgmma m64n192k16).  W1 (H, 384) and W2 (384, H) in
// torch's (out, in) layout are both K-major B operands as they lie: the
// producer streams W1[c] (64 rows) and W2[:, c] (384 rows of 64 columns)
// by TMA through a ring of three 48 KB slots, in the order the consumers
// take them (W1[0], then W1[c+1], W2[c] per chunk).  Each consumer issues
// fc1 of chunk c+1 and fc2 of chunk c together and runs chunk c+1's GELU
// while fc2 is on the tensor cores.  HSPLIT blocks of a cluster split the
// hidden dimension of one row block (see fused_ln_mlp_kernel), so that a
// frame's 57 row blocks fill more than 57 SMs.
//
// Numerics follow the JAX kernel: LN statistics in f32 (two-pass mean and
// variance, eps from the caller), LN output cast to bf16 (fused_mlp.py:45);
// fc1 + b1 in f32; GELU with the Abramowitz & Stegun 7.1.26 erf in f32, cast
// to bf16 (:48); fc2 + b2 in f32, cast to bf16; the residual add in bf16
// (:50).  fc2's f32 sums run chunk by chunk, the HSPLIT parts added last
// (tests/test_torch_port_fwd_mlp_emul.py emulates that order).
//
// Layout: x, out (M, 384) bf16; w1 (H, 384) and w2 (384, H) bf16 in torch's
// (out, in) layout; b1 (H), b2, ln weight, ln bias (384) f32.  H % 64 == 0.
// Grid ceil(M/64) * HSPLIT, 384 threads, ~209 KB of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace dtt;

constexpr int D = 384;          // embed dim
constexpr int BM = 64;          // token rows per block
constexpr int HC = 64;          // hidden units per chunk
constexpr int HW = HC / 2;      // fc1 columns per consumer warpgroup
constexpr int OUT_COLS = D / 2; // output columns per consumer warpgroup
constexpr int THREADS = 384;    // 2 consumer warpgroups, 1 producer group
constexpr int CONSUMERS = 256;
constexpr int PRODUCER = 8;     // the producer's warp index
constexpr int REGS_PRODUCER = 24, REGS_CONSUMER = 240;
constexpr int ATOM = 64 * 128;  // 64 rows x 64 bf16, 128-byte swizzled
// a weight chunk: W1 rows [c0, c0+HC) as 6 atoms of HC rows x 64 columns,
// or W2 columns [c0, c0+HC) as 384 rows of HC columns (128-byte swizzle)
constexpr int W_SLOT = HC * D * 2;
constexpr int W_STAGES = 3;     // a 144 KB ring
constexpr int W2_BOX = 192;     // W2 rows per TMA box (at most 256)
// blocks of a cluster that split the hidden dimension of one row block
constexpr int HSPLIT = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BAR_CONSUMERS = 1;  // named barrier of the 256 consumer threads

// LN(x) (6 atoms), 2 gelu buffers, the weight ring, its barriers
constexpr int SMEM = 6 * ATOM + 2 * ATOM + W_STAGES * W_SLOT +
                     2 * W_STAGES * 8 + 1024;  // + align

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Abramowitz & Stegun 7.1.26 (|err| < 1.5e-7), as fused_mlp.py:_erf_as,
// with exp(-z^2) taken as 2^(-z^2 * log2 e) and 1 / (1 + p|z|) as the
// MUFU's approximate reciprocal (within 1 ulp; with the correctly rounded
// one, a subroutine with a slow path, the kernel took 11-25% longer in the
// builds measured: cli/kernel_variants.py, frcp); erf(0) is not 0 but GELU
// multiplies it by 0
__device__ __forceinline__ float erf_as(float z) {
  const float az = fabsf(z);
  const float t = rcp_approx(1.f + 0.3275911f * az);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return copysignf(1.f - poly * ex2(-az * az * 1.4426950408889634f), z);
}

// LayerNorm of the block's rows -> Xn (bf16, 6 swizzled atoms of 64
// columns); warp wi (of 8) takes rows wi, wi+8, ..; lane takes columns
// 4q..4q+3 for q = lane + 32i.  Rows >= m are zeros.  The warp's 8 rows are
// loaded at once and ln_w, ln_b once, so their memory latencies overlap.
__device__ __forceinline__ void layer_norm_rows(
    unsigned char* Xn, const bf16* __restrict__ x,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, int m0,
    int m, float eps, int wi, int lane) {
  constexpr int ROWS = BM / (CONSUMERS / 32);  // a warp's rows
  uint2 raw[ROWS][3];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int gr = m0 + wi + 8 * k;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      raw[k][i] = gr < m ? *reinterpret_cast<const uint2*>(
                               x + (size_t)gr * D + 4 * (lane + 32 * i))
                         : make_uint2(0u, 0u);
  }
  float4 lw[3], lb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lw[i] = *reinterpret_cast<const float4*>(ln_w + 4 * (lane + 32 * i));
    lb[i] = *reinterpret_cast<const float4*>(ln_b + 4 * (lane + 32 * i));
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = wi + 8 * k, gr = m0 + r;
    float xv[3][4];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const __nv_bfloat162 a =
          *reinterpret_cast<const __nv_bfloat162*>(&raw[k][i].x);
      const __nv_bfloat162 b =
          *reinterpret_cast<const __nv_bfloat162*>(&raw[k][i].y);
      xv[i][0] = __low2float(a);
      xv[i][1] = __high2float(a);
      xv[i][2] = __low2float(b);
      xv[i][3] = __high2float(b);
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum += xv[i][e];
    const float mu = warp_sum(sum) / D;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dv = xv[i][e] - mu;
        ss += dv * dv;
      }
    const float rstd = 1.f / sqrtf(warp_sum(ss) / D + eps);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int col = 4 * (lane + 32 * i);
      const float w4[4] = {lw[i].x, lw[i].y, lw[i].z, lw[i].w};
      const float b4[4] = {lb[i].x, lb[i].y, lb[i].z, lb[i].w};
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = gr < m ? __fadd_rn(__fmul_rn(__fmul_rn(xv[i][e] - mu, rstd),
                                            w4[e]),
                                  b4[e])
                      : 0.f;
      *reinterpret_cast<uint2*>(Xn + (col >> 6) * ATOM +
                                sw128_off(r, col & 63)) =
          make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
    }
  }
}

// fc1 of this warpgroup's HW columns of the chunk: hacc (64 x HW) =
// LN(x) (64 x 384) . W1 chunk rows [HW*cc, HW*cc+HW)^T, one wgmma group
__device__ __forceinline__ void fc1_issue(float (&hacc)[HW / 2],
                                          const unsigned char* Xn,
                                          const unsigned char* w1, int cc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {  // 32 bytes per k-step
    const int atom = kk / 4, off = 2 * (kk % 4);
    wgmma_bf16_ss(hacc, sw128_desc(Xn + atom * ATOM) + off,
                  sw128_desc(w1 + atom * HC * 128 + cc * HW * 128) + off);
  }
  wgmma_commit();
}

// gelu chunk c's buffer (double buffered)
__device__ __forceinline__ unsigned char* gelu_buf(unsigned char* Hs, int c) {
  return Hs + (c & 1) * ATOM;
}

// fc2 of one chunk: acc (64 x 192) += the gelu chunk (64 x HC) . W2 chunk
// rows [192*cc, 192*cc+192)^T, one wgmma group
__device__ __forceinline__ void fc2_issue(float (&acc)[OUT_COLS / 2],
                                          unsigned char* Hs,
                                          const unsigned char* w2, int c,
                                          int cc) {
  const uint64_t da = sw128_desc(gelu_buf(Hs, c));
  const uint64_t db = sw128_desc(w2 + cc * OUT_COLS * HC * 2);
#pragma unroll
  for (int kk = 0; kk < HC / 16; ++kk)
    wgmma_bf16_ss(acc, da + 2 * kk, db + 2 * kk);
  wgmma_commit();
}

// this lane's b1 values of chunk c (columns HW*cc + 8j + 2t, +1), loaded
// ahead of the GELU that adds them
__device__ __forceinline__ void load_b1(float2 (&bb)[HW / 8],
                                        const float* __restrict__ b1, int c,
                                        int cc, int lane) {
#pragma unroll
  for (int j = 0; j < HW / 8; ++j)
    bb[j] = *reinterpret_cast<const float2*>(b1 + c * HC + HW * cc + 8 * j +
                                             2 * (lane % 4));
}

// + b1, GELU (A&S erf) in f32, bf16 -> this warpgroup's HW columns of gelu
// chunk c.  hacc[4j+e]: row 16w + g + 8(e>>1), column 8j + 2t + (e&1)
__device__ __forceinline__ void gelu_store(const float (&hacc)[HW / 2],
                                           unsigned char* Hs,
                                           const float2 (&b1)[HW / 8],
                                           int c, int cc, int w, int lane) {
  const int g = lane / 4, t = lane % 4;
  unsigned char* Ht = gelu_buf(Hs, c);
#pragma unroll
  for (int j = 0; j < HW / 8; ++j) {
    const int col = HW * cc + 8 * j + 2 * t;  // within the chunk
    const float2 bb = b1[j];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float hv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x1 = hacc[4 * j + 2 * r + e] + (e ? bb.y : bb.x);
        const float z = x1 * 0.7071067811865476f;
        hv[e] = x1 * 0.5f * (1.f + erf_as(z));
      }
      *reinterpret_cast<unsigned*>(
          Ht + sw128_off(16 * w + g + 8 * r, col)) =
          pack_bf16(hv[0], hv[1]);
    }
  }
}

// the consumer warpgroups' part of the kernel: LN of the block's rows, then
// fc1, GELU and fc2 over hidden chunks [c_begin, c_end) into acc.
// Warpgroup cc owns output columns [192cc, 192cc+192) and, in each chunk,
// fc1 of hidden columns [HW*cc, HW*cc+HW).
__device__ __forceinline__ void mlp_chunks(
    float (&acc)[OUT_COLS / 2], const bf16* __restrict__ x,
    const float* __restrict__ b1, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, int m0, int m, int c_begin, int c_end,
    float eps, unsigned char* Xn, unsigned char* Hs, unsigned char* Ws,
    uint64_t* full, uint64_t* empty, int warp, int lane) {
  const int cc = warp / 4, w = warp % 4;
#pragma unroll
  for (int i = 0; i < OUT_COLS / 2; ++i) acc[i] = 0.f;
  if (c_begin == c_end) return;
  layer_norm_rows(Xn, x, ln_w, ln_b, m0, m, eps, warp, lane);
  fence_proxy_async();  // LN(x) -> visible to wgmma
  named_barrier(BAR_CONSUMERS, CONSUMERS);

  float hacc[HW / 2];
  float2 bb[HW / 8];  // b1 of the next chunk to go through the GELU
  int it = 0;  // position in the weight stream
  load_b1(bb, b1, c_begin, cc, lane);

  // the first chunk's fc1 and GELU
#pragma unroll
  for (int i = 0; i < HW / 2; ++i) hacc[i] = 0.f;
  mbar_wait(&full[0], 0);
  reg_fence(hacc);
  wgmma_fence();
  fc1_issue(hacc, Xn, Ws, cc);
  wgmma_wait<0>();
  reg_fence(hacc);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[0]);
  ++it;
  gelu_store(hacc, Hs, bb, c_begin, cc, w, lane);
  fence_proxy_async();
  named_barrier(BAR_CONSUMERS, CONSUMERS);

  // chunk c: fc1 of chunk c+1 and fc2 of chunk c in flight together; the
  // GELU of chunk c+1 runs while fc2 of chunk c is on the tensor cores.  On
  // the last chunk fc1 runs over the W2 slot and its result is dropped: each
  // iteration issues the same two wgmma groups (ptxas serializes wgmma
  // issued under a condition, and crashes on a second fc2 issue site).
  for (int c = c_begin; c < c_end; ++c) {
    const bool more = c + 1 < c_end;
    if (more) load_b1(bb, b1, c + 1, cc, lane);
    int s1 = 0;
    if (more) {
      s1 = it % W_STAGES;
      mbar_wait(&full[s1], (it / W_STAGES) & 1);
      ++it;
    }
    const int s2 = it % W_STAGES;
    mbar_wait(&full[s2], (it / W_STAGES) & 1);
    ++it;
#pragma unroll
    for (int i = 0; i < HW / 2; ++i) hacc[i] = 0.f;
    reg_fence(hacc);
    reg_fence(acc);
    wgmma_fence();
    fc1_issue(hacc, Xn, Ws + (more ? s1 : s2) * W_SLOT, cc);
    fc2_issue(acc, Hs, Ws + s2 * W_SLOT, c, cc);
    wgmma_wait<1>();
    reg_fence(hacc);
    if (more) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s1]);
      gelu_store(hacc, Hs, bb, c + 1, cc, w, lane);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    reg_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s2]);
    // both halves of chunk c+1 are written; both groups are done with c
    named_barrier(BAR_CONSUMERS, CONSUMERS);
  }
}

// out = x + bf16(acc + b2), added in bf16
__device__ __forceinline__ void mlp_epilogue(const float (&acc)[OUT_COLS / 2],
                                             const bf16* __restrict__ x,
                                             const float* __restrict__ b2,
                                             bf16* __restrict__ out, int m0,
                                             int m, int warp, int lane) {
  const int cc = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = m0 + 16 * w + g + 8 * r;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < OUT_COLS / 8; ++j) {
      const int col = cc * OUT_COLS + j * 8 + 2 * t;
      const size_t off = (size_t)gr * D + col;
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + off);
      const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
      const __nv_bfloat162 hb = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] + bb.x, acc[4 * j + 2 * r + 1] + bb.y);
      *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(
          __low2float(xv) + __low2float(hb), __high2float(xv) + __high2float(hb));
    }
  }
}

// the producer thread: the weight stream of chunks [c_begin, c_end) in the
// order the consumers take it: W1[c_begin], then W1[c+1], W2[c] per chunk
__device__ __forceinline__ void mlp_produce(const CUtensorMap* w1map,
                                            const CUtensorMap* w2map,
                                            unsigned char* Ws, uint64_t* full,
                                            uint64_t* empty, int c_begin,
                                            int c_end) {
  int it = 0;
  for (int c = c_begin - 1; c < c_end; ++c) {
    for (int kind = 0; kind < 2; ++kind) {
      const bool w1 = kind == 0;
      const int chunk = w1 ? c + 1 : c;
      if (chunk < c_begin || chunk >= c_end) continue;
      const int s = it % W_STAGES;
      mbar_wait(&empty[s], ((it / W_STAGES) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], W_SLOT);
      unsigned char* slot = Ws + s * W_SLOT;
      if (w1) {  // rows [HC*c, HC*c+HC) of W1 (H, 384): 6 atoms
        for (int a = 0; a < D / 64; ++a)
          tma_load_2d(slot + a * HC * 128, w1map, &full[s], 64 * a,
                      HC * chunk);
      } else {   // columns [HC*c, HC*c+HC) of W2 (384, H): 384 rows
        for (int b = 0; b < D / W2_BOX; ++b)
          tma_load_2d(slot + b * W2_BOX * HC * 2, w2map, &full[s],
                      HC * chunk, W2_BOX * b);
      }
      ++it;
    }
  }
}

// HSPLIT blocks of a cluster take one 64-row block, block r the hidden
// chunks [r*nc/HSPLIT, (r+1)*nc/HSPLIT); their fc2 partial sums meet in
// block 0 through distributed shared memory (block 0's + block 1's, in
// that order: the same bits on every run), which adds b2 and the residual.
__global__ void __cluster_dims__(HSPLIT, 1, 1) __launch_bounds__(THREADS, 1)
fused_ln_mlp_kernel(const __grid_constant__ CUtensorMap w1map,
                    const __grid_constant__ CUtensorMap w2map,
                    const bf16* __restrict__ x, const float* __restrict__ b1,
                    const float* __restrict__ b2,
                    const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b, bf16* __restrict__ out,
                    int m, int h, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Xn = align1024(smem_raw);   // LN(x): 6 atoms
  unsigned char* Hs = Xn + 6 * ATOM;         // 2 gelu buffers (64 x 64)
  unsigned char* Ws = Hs + 2 * ATOM;         // W_STAGES weight slots
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + W_STAGES * W_SLOT);
  uint64_t* empty = full + W_STAGES;

  const int tid = threadIdx.x, nc = h / HC;
  const int rank = HSPLIT > 1 ? (int)cluster_ctarank() : 0;
  const int m0 = (blockIdx.x / HSPLIT) * BM;
  const int c_begin = rank * nc / HSPLIT, c_end = (rank + 1) * nc / HSPLIT;
  if (tid == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one lane per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (warp < PRODUCER) {
    setmaxnreg_inc<REGS_CONSUMER>();
    float acc[OUT_COLS / 2];  // rows 16w + g (+8), columns 192cc + 8j + 2t
    mlp_chunks(acc, x, b1, ln_w, ln_b, m0, m, c_begin, c_end, eps, Xn, Hs,
               Ws, full, empty, warp, lane);
    if (HSPLIT > 1) {  // the weight ring is idle now: it carries the sums
      float4* part = reinterpret_cast<float4*>(Ws);
      if (rank != 0)
#pragma unroll
        for (int j = 0; j < OUT_COLS / 8; ++j)
          part[j * CONSUMERS + tid] = make_float4(
              acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
      cluster_sync();
      if (rank == 0)
        for (int r = 1; r < HSPLIT; ++r)
#pragma unroll
          for (int j = 0; j < OUT_COLS / 8; ++j) {
            const float4 p = ld_dsmem_f4(part + j * CONSUMERS + tid, r);
            acc[4 * j] += p.x;
            acc[4 * j + 1] += p.y;
            acc[4 * j + 2] += p.z;
            acc[4 * j + 3] += p.w;
          }
    }
    if (rank == 0) mlp_epilogue(acc, x, b2, out, m0, m, warp, lane);
    if (HSPLIT > 1) cluster_sync();  // block 0 is done reading the peers
  } else {
    setmaxnreg_dec<REGS_PRODUCER>();
    if (warp == PRODUCER && lane == 0)
      mlp_produce(&w1map, &w2map, Ws, full, empty, c_begin, c_end);
    __syncwarp();
    if (HSPLIT > 1) {
      cluster_sync();
      cluster_sync();
    }
  }
}

}  // namespace

extern "C" int dtt_fused_ln_mlp(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const void* ln_w, const void* ln_b, void* out,
                                int m, int d, int h, float eps, void* stream) {
  if (d != D || h <= 0 || h % 64 != 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap w1map, w2map;
  int err;
  if ((err = make_2d_map(&w1map, w1, h, D, HC)) != 0 ||
      (err = make_2d_map(&w2map, w2, D, h, W2_BOX)) != 0)
    return err;
  if ((err = (int)cudaFuncSetAttribute(
           fused_ln_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           SMEM)) != 0)
    return err;
  fused_ln_mlp_kernel<<<(m + BM - 1) / BM * HSPLIT, THREADS, SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      w1map, w2map, static_cast<const bf16*>(x),
      static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<bf16*>(out), m, h, eps);
  return (int)cudaGetLastError();
}
