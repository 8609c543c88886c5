// fc1's epilogue on the bf16 training path, one pass each way (sm_90a).
//
// Replaces no Pallas kernel: in dino_tpu, XLA fuses this composition of
// models/vit.py:mlp_residual by itself (fc1's product with an f32 result,
// the f32 bias, the true-erf GELU in f32, the rounding to bf16); eager
// PyTorch runs it as separate passes over the (rows, hidden) tensor: the
// bias add in place, the GELU f32 -> f32, the cast, and in the backward the
// cast back, GeluBackward, the cast of du and its column sum.  Here:
//
//   forward   h  = bf16(gelu(y + b1))                  y read, h written
//   backward  du = bf16(dh * gelu'(y + b1)), db = sum_rows(du32)
//                                                      dh, y read, du written
//
// y is fc1's raw f32 product (cuBLAS, outside this file), saved for the
// backward in place of the GELU's f32 input; the backward recomputes
// u = y + b1 with the same f32 add, so the same bits.  The GELU and its
// derivative are PyTorch's GeluCUDAKernelImpl / GeluBackwardCUDAKernelImpl
// (approximate='none') in f32 opmath, written as they are there, erff and
// expf the library's (no --use_fast_math), and each rounding is round to
// nearest even, as c10::BFloat16's.
//
// What bounds it: bytes.  6 B an element forward, 8 B backward, against a
// few dozen f32 operations (erff, expf): at ViT-S's hidden width 1,536 and
// the pretrain step's 100,480 global-crop rows, 0.28 ms and 0.37 ms at
// 3.35 TB/s.  Design: each thread owns 8 columns (one 16-byte bf16 vector,
// two of f32), a warp 256 contiguous columns of a row, a block 8 rows at a
// time; the grid is one wave (blocks of a column tile interleave their row
// groups, so each gets the same share of rows) and every block loops.  db
// is summed without atomics: each thread keeps its 8 columns' sums in
// registers over its rows, the block adds its 8 row lanes in shared memory
// in a fixed order into one row of partials, and a second small launch adds
// the partials' rows in a fixed order.  The same shapes on the same card
// give the same bits.
//
// Layout: y (rows, hidden) f32; b1 (hidden) f32; h, dh, du (rows, hidden)
// bf16; all row-major and contiguous, 16-byte aligned, hidden % 8 == 0.
// partial (slabs, hidden) f32 scratch, slabs from dtt_bias_gelu_slabs; db
// (hidden) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;                 // columns a thread
constexpr int TX = 32;                 // threads across a column tile
constexpr int TY = 8;                  // rows a block takes at a time
constexpr int THREADS = TX * TY;
constexpr int TILE = TX * VEC;         // 256 columns a block
constexpr int BLOCKS_PER_SM = 4;       // __launch_bounds__ below
constexpr int RED_THREADS = 256;       // partials' reduce: 32 columns x 8

// PyTorch's constants, float(M_SQRT1_2) and float(M_2_SQRTPI * M_SQRT1_2 *
// 0.5), their values written out so that no math.h macro is needed
constexpr float kAlpha = static_cast<float>(0.70710678118654752440);
constexpr float kBeta = static_cast<float>(1.12837916709551257390 *
                                           0.70710678118654752440 * 0.5);

__device__ __forceinline__ float gelu(float x) {
  return x * 0.5f * (1.0f + erff(x * kAlpha));
}

__device__ __forceinline__ float gelu_grad(float dy, float x) {
  const float cdf = 0.5f * (1.0f + erff(x * kAlpha));
  const float pdf = expf(-0.5f * x * x) * kBeta;
  return dy * (cdf + x * pdf);
}

__device__ __forceinline__ uint4 pack_bf16(const float (&v)[VEC]) {
  uint4 out;
  __nv_bfloat162 p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  out.x = *reinterpret_cast<uint32_t*>(&p[0]);
  out.y = *reinterpret_cast<uint32_t*>(&p[1]);
  out.z = *reinterpret_cast<uint32_t*>(&p[2]);
  out.w = *reinterpret_cast<uint32_t*>(&p[3]);
  return out;
}

__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float (&v)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_bf16(const __nv_bfloat16* __restrict__ p,
                                          float (&v)[VEC]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// grid (column tiles, slabs); block (TX, TY).  Block by takes the row
// groups by, by + slabs, ... of TY rows each.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
bias_gelu_fwd_kernel(const float* __restrict__ y,
                     const float* __restrict__ b1,
                     __nv_bfloat16* __restrict__ h, int rows, int hidden) {
  const int col = (blockIdx.x * TX + threadIdx.x) * VEC;
  if (col >= hidden) return;
  float b[VEC];
  load_f32(b1 + col, b);
  const int groups = (rows + TY - 1) / TY;
#pragma unroll 2
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    const int r = g * TY + threadIdx.y;
    if (r >= rows) continue;
    const size_t at = static_cast<size_t>(r) * hidden + col;
    float v[VEC];
    load_f32(y + at, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = gelu(v[i] + b[i]);
    *reinterpret_cast<uint4*>(h + at) = pack_bf16(v);
  }
}

// As the forward's grid; partial[by][col] = block by's column sums of du32.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
bias_gelu_bwd_kernel(const __nv_bfloat16* __restrict__ dh,
                     const float* __restrict__ y,
                     const float* __restrict__ b1,
                     __nv_bfloat16* __restrict__ du,
                     float* __restrict__ partial, int rows, int hidden) {
  __shared__ float red[TY][TILE];
  const int col = (blockIdx.x * TX + threadIdx.x) * VEC;
  const bool live = col < hidden;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  if (live) {
    float b[VEC];
    load_f32(b1 + col, b);
    const int groups = (rows + TY - 1) / TY;
#pragma unroll 2
    for (int g = blockIdx.y; g < groups; g += gridDim.y) {
      const int r = g * TY + threadIdx.y;
      if (r >= rows) continue;
      const size_t at = static_cast<size_t>(r) * hidden + col;
      float v[VEC], d[VEC];
      load_f32(y + at, v);
      load_bf16(dh + at, d);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[i] = gelu_grad(d[i], v[i] + b[i]);
        acc[i] += v[i];
      }
      *reinterpret_cast<uint4*>(du + at) = pack_bf16(v);
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) red[threadIdx.y][threadIdx.x * VEC + i] = acc[i];
  __syncthreads();
  const int t = threadIdx.y * TX + threadIdx.x;  // one column of the tile
  const int c = blockIdx.x * TILE + t;
  if (c < hidden) {
    float s = red[0][t];
#pragma unroll
    for (int k = 1; k < TY; ++k) s += red[k][t];
    partial[static_cast<size_t>(blockIdx.y) * hidden + c] = s;
  }
}

// grid ceil(hidden / 32); block (32, 8): lane x one column, row lane k the
// slabs k, k + 8, ...; the 8 lanes' sums added in order.
__global__ void __launch_bounds__(RED_THREADS)
bias_gelu_db_kernel(const float* __restrict__ partial, float* __restrict__ db,
                    int slabs, int hidden) {
  __shared__ float red[RED_THREADS / 32][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (c < hidden)
    for (int k = threadIdx.y; k < slabs; k += RED_THREADS / 32)
      s += partial[static_cast<size_t>(k) * hidden + c];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < hidden) {
#pragma unroll
    for (int k = 1; k < RED_THREADS / 32; ++k) s += red[k][threadIdx.x];
    db[c] = s;
  }
}

int g_sms[64];  // SM count by device ordinal, 0 until read

int slabs_for(int rows, int hidden) {
  int dev, err;
  if ((err = (int)cudaGetDevice(&dev)) != 0) return -err;
  if (dev < 0 || dev >= 64) return -(int)cudaErrorInvalidDevice;
  if (g_sms[dev] == 0 &&
      (err = (int)cudaDeviceGetAttribute(
           &g_sms[dev], cudaDevAttrMultiProcessorCount, dev)) != 0)
    return -err;
  const int tiles = (hidden + TILE - 1) / TILE;
  const int groups = (rows + TY - 1) / TY;
  int slabs = g_sms[dev] * BLOCKS_PER_SM / tiles;
  if (slabs > groups) slabs = groups;
  return slabs < 1 ? 1 : slabs;
}

bool bad_args(const void* a, const void* b, const void* c, int rows,
              int hidden) {
  return rows <= 0 || hidden <= 0 || hidden % VEC != 0 ||
         (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
          reinterpret_cast<uintptr_t>(c)) % 16 != 0;
}

}  // namespace

// The rows of the backward's partial sums (its grid's second dimension):
// one wave of blocks on this device.  Negative: a CUDA error, negated.
extern "C" int dtt_bias_gelu_slabs(int rows, int hidden) {
  if (rows <= 0 || hidden <= 0) return -(int)cudaErrorInvalidValue;
  return slabs_for(rows, hidden);
}

extern "C" int dtt_bias_gelu_fwd(const void* y, const void* b1, void* h,
                                 int rows, int hidden, void* stream) {
  if (bad_args(y, b1, h, rows, hidden)) return (int)cudaErrorInvalidValue;
  const int slabs = slabs_for(rows, hidden);
  if (slabs < 0) return -slabs;
  const dim3 grid((hidden + TILE - 1) / TILE, slabs);
  bias_gelu_fwd_kernel<<<grid, dim3(TX, TY), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(b1),
      static_cast<__nv_bfloat16*>(h), rows, hidden);
  return (int)cudaGetLastError();
}

extern "C" int dtt_bias_gelu_bwd(const void* dh, const void* y, const void* b1,
                                 void* du, void* partial, void* db, int rows,
                                 int hidden, int slabs, void* stream) {
  if (bad_args(dh, y, b1, rows, hidden) ||
      (reinterpret_cast<uintptr_t>(du) % 16) != 0 || slabs <= 0 ||
      slabs > (rows + TY - 1) / TY)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((hidden + TILE - 1) / TILE, slabs);
  bias_gelu_bwd_kernel<<<grid, dim3(TX, TY), 0, s>>>(
      static_cast<const __nv_bfloat16*>(dh), static_cast<const float*>(y),
      static_cast<const float*>(b1), static_cast<__nv_bfloat16*>(du),
      static_cast<float*>(partial), rows, hidden);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  bias_gelu_db_kernel<<<(hidden + 31) / 32, dim3(32, RED_THREADS / 32), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(db), slabs,
      hidden);
  return (int)cudaGetLastError();
}
