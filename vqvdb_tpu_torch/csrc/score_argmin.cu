// Score GEMM with a first-minimum argmin epilogue:
//     out[n] = argmin_k ( sum_f h[n, f] * M[f, k] + c[k] )
// in f32, ties to the smallest k, a NaN score winning over any number
// (the first NaN among NaNs), as jnp.argmin and torch.argmin do.
//
// Replaces two TPU kernels, each with its own entry point:
//   * vqvdb_tpu/ops/quantize.py:fused_score_argmin (_score_argmin_kernel):
//     the encoder's 1x1 projection folded into the quantizer score,
//     h = packed-encoder features [N, 64] (bf16 or f32), M [64, K], c [K].
//   * vqvdb_tpu/ops/quantize.py:fused_nearest_indices (_nearest_kernel):
//     the nearest code to latents z [N, D] f32, which is the same body with
//     M = -2 E^T [D, K] and c = ||e||^2 (||z||^2 dropped: it cannot move
//     the argmin).
//
// Bound on the H100 at the codec's batch (N = 262,144 rows, K = 256), with
// the arithmetic in f32 on the CUDA cores as the TPU kernels specify
// (67 TFLOP/s peak):
//   score-argmin: h read 33.6 MB bf16 -> 10 us; 2*N*64*256 = 8.6 GFLOP
//                 -> 128 us. Bound by operations.
//   nearest:      z read 134 MB f32 -> 40 us; 2*N*128*256 = 17.2 GFLOP
//                 -> 256 us. Bound by operations.
//
// Simple design: a persistent grid; each block loads M and c into shared
// memory once (64 KB / 128 KB for M, so dynamic shared memory with the
// opt-in attribute) and walks 64-row tiles of h. A tile is staged in shared
// memory transposed ([f][row], f32). Each of the 256 threads keeps a
// 4-row x 16-code register tile of scores (codes j*64 + cg*4 + q), so per
// step of f it reads one float4 of h and up to four float4s of M for 64
// FMAs. The 16 threads that share rows then reduce (value, index) pairs
// lexicographically with warp shuffles. The [N, K] scores never reach
// device memory; the output is int32 [N], as the TPU kernels return.
//
// Later fast design: the score GEMM on the tensor cores (wgmma, bf16 or
// TF32 operands where the index agreement allows it) with TMA-fed h tiles,
// and the index stored as u8 straight into the file batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;          // rows per tile
constexpr int kThreads = 256;      // 16 row groups x 16 code groups
constexpr int kRowsPerThread = 4;  // rows of one row group
constexpr int kMaxQuads = 4;       // K / 64 code quads per thread (K <= 256)
constexpr int kHStride = kRows + 4;  // padded transposed-tile row, float4-aligned

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (a, ia) comes before (b, ib) in jnp.argmin order.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a < b || (a == b && ia < ib);
}

size_t smem_bytes(int f, int k) {
  return sizeof(float) * (static_cast<size_t>(f) * k + k +
                          static_cast<size_t>(f) * kHStride);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    score_argmin_kernel(const T* __restrict__ h, const float* __restrict__ m,
                        const float* __restrict__ c, int32_t* __restrict__ out,
                        int n, int f, int k) {
  extern __shared__ float4 smem4[];
  float* m_s = reinterpret_cast<float*>(smem4);  // [f][k]
  float* c_s = m_s + f * k;                      // [k]
  float* h_s = c_s + k;                          // [f][kHStride]

  for (int i = threadIdx.x; i < f * k; i += kThreads) m_s[i] = m[i];
  for (int i = threadIdx.x; i < k; i += kThreads) c_s[i] = c[i];

  const int rg = threadIdx.x / 16;  // rows rg*4 .. rg*4+3 of the tile
  const int cg = threadIdx.x % 16;  // codes j*64 + cg*4 + q
  const int quads = k / 64;
  const int tiles = (n + kRows - 1) / kRows;
  const long long limit = static_cast<long long>(n) * f;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * kRows;
    const long long base = row0 * f;
    __syncthreads();  // the previous tile's readers are done with h_s
    for (int e = threadIdx.x; e < kRows * f; e += kThreads) {
      const int r = e / f;
      const int col = e - r * f;
      h_s[col * kHStride + r] = (base + e < limit) ? to_f32(h[base + e]) : 0.f;
    }
    __syncthreads();

    float acc[kRowsPerThread][kMaxQuads][4];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int j = 0; j < kMaxQuads; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][j][q] = 0.f;

    for (int ff = 0; ff < f; ++ff) {
      const float4 hv =
          *reinterpret_cast<const float4*>(&h_s[ff * kHStride + rg * 4]);
      const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int j = 0; j < kMaxQuads; ++j) {
        if (j < quads) {
          const float4 mv = *reinterpret_cast<const float4*>(
              &m_s[ff * k + j * 64 + cg * 4]);
          const float mr[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[r][j][q] = fmaf(hr[r], mr[q], acc[r][j][q]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      float best = acc[r][0][0] + c_s[cg * 4];
      int best_i = cg * 4;
#pragma unroll
      for (int j = 0; j < kMaxQuads; ++j) {
        if (j < quads) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int code = j * 64 + cg * 4 + q;
            const float s = acc[r][j][q] + c_s[code];
            if (before(s, code, best, best_i)) {
              best = s;
              best_i = code;
            }
          }
        }
      }
      // The 16 code groups of a row group are 16 consecutive lanes.
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
        if (before(ob, oi, best, best_i)) {
          best = ob;
          best_i = oi;
        }
      }
      const long long row = row0 + rg * kRowsPerThread + r;
      if (cg == 0 && row < n) out[row] = best_i;
    }
  }
}

template <typename T>
int launch(const void* h, const void* m, const void* c, void* out, int n,
           int f, int k, void* stream) {
  if (n <= 0 || f <= 0 || k < 64 || k > 64 * kMaxQuads || k % 64 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(f, k);
  cudaError_t err = cudaFuncSetAttribute(
      score_argmin_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, score_argmin_kernel<T>, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (n + kRows - 1) / kRows;
  const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
  score_argmin_kernel<T><<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(h), static_cast<const float*>(m),
      static_cast<const float*>(c), static_cast<int32_t*>(out), n, f, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h [n, f] (bf16 when h_is_bf16, else f32), m [f, k] f32, c [k] f32
// -> out int32 [n]. K must be 64, 128, 192 or 256.
extern "C" int vq_score_argmin(const void* h, int h_is_bf16, const void* m,
                               const void* c, void* out, int n, int f, int k,
                               void* stream) {
  if (h_is_bf16) {
    return launch<__nv_bfloat16>(h, m, c, out, n, f, k, stream);
  }
  return launch<float>(h, m, c, out, n, f, k, stream);
}

// z [n, d] f32, mt = -2 E^T [d, k] f32, esq = ||e||^2 [k] f32 -> int32 [n].
extern "C" int vq_nearest_indices(const void* z, const void* mt,
                                  const void* esq, void* out, int n, int d,
                                  int k, void* stream) {
  return launch<float>(z, mt, esq, out, n, d, k, stream);
}
