// The 16-channel pre-activation residual block of 8^3 leaves in one kernel:
//     out = x + res_scale * conv2(relu(gn2(conv1(relu(gn1(x))))))
// with 3x3x3 SAME convs (bias included), GroupNorm per (leaf, group) with f32
// statistics, and every intermediate kept on the chip: x is read from device
// memory once and out is written once.
//
// Replaces: vqvdb_tpu/ops/fused_rb.py:residual_block_fused (_rb_kernel).
// That kernel lays a leaf out as 64 rows x 128 (w, c) lanes and multiplies
// by nine banded block-Toeplitz matrices, with GroupNorm sums taken by a 0/1
// matmul. Both are devices for a 128x128 matrix unit and inflate the
// arithmetic 2.67x; neither is carried over. Here each conv is the direct sum
// of 27 taps x 16 input channels per output element.
//
// Arithmetic follows the TPU kernel: x is widened to f32, everything up to
// the final sum stays f32, and the result is rounded to x's type once. For
// bf16 input the wrapper rounds the conv weights to bf16 first, as the TPU
// kernel does, and passes them as f32. GroupNorm takes the two-pass form
// (mean, then the mean of squared deviations), which is what the plain
// version computes; the TPU kernel's E[x^2] - mean^2 differs from it by
// rounding only.
//
// Bound on the H100 at the codec's batch (B = 4096 leaves): two convs of
// 4096*512*27*16*16*2 = 29.0 GFLOP each, 58 GFLOP of f32 on the CUDA cores
// (67 TFLOP/s) -> 0.87 ms: bound by operations. The bytes (67 MB bf16 in and
// out -> 0.040 ms, 0.080 ms in f32) are what a tensor-core version would
// chase.
//
// Simple design: a persistent grid of 512-thread blocks. A block holds both
// convs' weights in shared memory ([27 taps][16 in][16 out] f32, 2 x 27 KB)
// for its lifetime, and its two 256-thread teams each own one leaf at a time
// with one zero-haloed activation buffer [16 ch][10 d][10 h][10 w] f32 in
// shared memory (d stride padded to 104 and channel stride to 1041 floats).
// A thread owns 4 voxels along h x 8 output channels (32 f32 sums): lanes
// run along w (8) and d (4), so every activation load of a warp hits 32
// distinct banks (d stride 104 = 8 mod 32), and the 8 output channels are
// uniform in a warp, so every weight load is a 16-byte broadcast. Per
// (input channel, kd, kw) a thread loads 6 activations and 6 float4 of
// weights for 96 FMAs. x stays in the thread's registers from the load to
// the final sum. GroupNorm sums go through warp shuffles and a small
// shared-memory table in a fixed order, so results do not vary run to run.
//
// Later fast design: an implicit GEMM on the tensor cores (per tap
// [512 voxels x 16] x [16 x 16], bf16 mma / wgmma with f32 sums), TMA loads
// of the leaf tile, and more leaves in flight per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;                 // channels
constexpr int kLeaf = 8;               // leaf edge
constexpr int kVoxels = kLeaf * kLeaf * kLeaf;
constexpr int kTeamThreads = 256;      // threads that own one leaf
constexpr int kTeams = 2;              // leaves in flight per block
constexpr int kThreads = kTeamThreads * kTeams;
constexpr int kTeamWarps = kTeamThreads / 32;
constexpr int kCo = 8;                 // output channels per thread
constexpr int kVox = 4;                // voxels (along h) per thread
constexpr int kSH = 10;                // haloed buffer: h stride
constexpr int kSD = 104;               // d stride (10 rows of 10, +4 pad)
constexpr int kCS = 10 * kSD + 1;      // channel stride
constexpr int kBuf = kC * kCS;         // floats per team buffer
constexpr int kWConv = 27 * kC * kC;   // floats per conv weight
constexpr int kPrm = 6 * kC;           // gn1 scale, gn1 bias, conv1 bias,
                                       // gn2 scale, gn2 bias, conv2 bias
constexpr int kRed = kTeamWarps * kCo + kC;  // per-team reduction scratch

constexpr size_t kSmemBytes =
    sizeof(float) * (kTeams * kBuf + 2 * kWConv + kPrm + kTeams * kRed);

__device__ __forceinline__ void load8(const float* p, float (&v)[kCo]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kCo]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kCo]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kCo]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

// Where a thread sits in its team.
struct Place {
  int t;      // thread in team
  int warp;   // warp in team
  int lane;
  int co0;    // first of its 8 output channels
  int base;   // haloed-buffer offset of voxel (d - 1, h0 - 1, w - 1)
  int voxel;  // linear index of its first voxel (d, h0, w)
};

// v[k] holds this thread's partial sum for channel co0 + k. Returns in v[k]
// the total over the team's leaf and over the GroupNorm group of channel
// co0 + k (cpg channels per group). `red` is the team's scratch. Every
// thread of the block must call it (it synchronises the block).
__device__ __forceinline__ void group_totals(float (&v)[kCo], float* red,
                                             const Place& pl, int cpg) {
  float* part = red;                     // [kTeamWarps][kCo]
  float* chs = red + kTeamWarps * kCo;   // [kC]
#pragma unroll
  for (int k = 0; k < kCo; ++k) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    }
  }
  if (pl.lane == 0) {
#pragma unroll
    for (int k = 0; k < kCo; ++k) part[pl.warp * kCo + k] = v[k];
  }
  __syncthreads();
  if (pl.t < kC) {
    // Channels 0-7 live in warps 0-3 of the team, channels 8-15 in 4-7.
    const int half = pl.t / kCo;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kTeamWarps / 2; ++q) {
      s += part[(half * (kTeamWarps / 2) + q) * kCo + (pl.t % kCo)];
    }
    chs[pl.t] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCo; ++k) {
    const int g0 = ((pl.co0 + k) / cpg) * cpg;
    float s = 0.f;
    for (int c = g0; c < g0 + cpg; ++c) s += chs[c];
    v[k] = s;
  }
}

// GroupNorm + ReLU of the thread's 4 x 8 values `a`, written to the interior
// of the team's haloed buffer. scale / bias: [16] in shared memory.
__device__ __forceinline__ void gn_relu_to_buffer(
    const float (&a)[kVox][kCo], float* buf, float* red, const Place& pl,
    int cpg, float eps, const float* scale, const float* bias) {
  const float inv_n = 1.f / static_cast<float>(kVoxels * cpg);
  float mean[kCo], inv[kCo];
#pragma unroll
  for (int k = 0; k < kCo; ++k) {
    mean[k] = (a[0][k] + a[1][k]) + (a[2][k] + a[3][k]);
  }
  group_totals(mean, red, pl, cpg);
#pragma unroll
  for (int k = 0; k < kCo; ++k) {
    mean[k] *= inv_n;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kVox; ++j) {
      const float dlt = a[j][k] - mean[k];
      s = fmaf(dlt, dlt, s);
    }
    inv[k] = s;
  }
  group_totals(inv, red, pl, cpg);
#pragma unroll
  for (int k = 0; k < kCo; ++k) {
    inv[k] = 1.f / sqrtf(inv[k] * inv_n + eps);
  }
  // The first barrier inside group_totals came after every thread's reads
  // of the buffer (the conv before this call), so it may be overwritten.
#pragma unroll
  for (int k = 0; k < kCo; ++k) {
    const float sc = scale[pl.co0 + k], bi = bias[pl.co0 + k];
    float* dst = buf + (pl.co0 + k) * kCS + pl.base + kSD + kSH + 1;
#pragma unroll
    for (int j = 0; j < kVox; ++j) {
      const float y = (a[j][k] - mean[k]) * inv[k] * sc + bi;
      dst[j * kSH] = y < 0.f ? 0.f : y;  // keeps a NaN, as relu does
    }
  }
}

// acc[j][k] = bias[co0 + k] + sum over 27 taps and 16 input channels of the
// haloed buffer times w[tap][ci][co0 + k].
__device__ __forceinline__ void conv3x3x3(const float* buf, const float* w,
                                          const float* bias, const Place& pl,
                                          float (&acc)[kVox][kCo]) {
#pragma unroll
  for (int k = 0; k < kCo; ++k) {
    const float b = bias[pl.co0 + k];
#pragma unroll
    for (int j = 0; j < kVox; ++j) acc[j][k] = b;
  }
#pragma unroll 1
  for (int ci = 0; ci < kC; ++ci) {
    const float* src = buf + ci * kCS + pl.base;
    const float* wc = w + ci * kC + pl.co0;
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        float in[kVox + 2];
#pragma unroll
        for (int r = 0; r < kVox + 2; ++r) {
          in[r] = src[kd * kSD + r * kSH + kw];
        }
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          float wv[kCo];
          load8(wc + ((kd * 3 + kh) * 3 + kw) * (kC * kC), wv);
#pragma unroll
          for (int j = 0; j < kVox; ++j) {
#pragma unroll
            for (int k = 0; k < kCo; ++k) {
              acc[j][k] = fmaf(in[j + kh], wv[k], acc[j][k]);
            }
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    residual_block16_kernel(const T* __restrict__ x,
                            const float* __restrict__ w1,
                            const float* __restrict__ w2,
                            const float* __restrict__ prm,
                            T* __restrict__ out, int b, int cpg,
                            float res_scale, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* w1_s = smem;                      // 16-byte aligned: float4 loads
  float* w2_s = w1_s + kWConv;
  float* prm_s = w2_s + kWConv;
  float* bufs = prm_s + kPrm;
  float* reds = bufs + kTeams * kBuf;

  for (int i = threadIdx.x; i < kWConv; i += kThreads) {
    w1_s[i] = w1[i];
    w2_s[i] = w2[i];
  }
  for (int i = threadIdx.x; i < kPrm; i += kThreads) prm_s[i] = prm[i];
  // The halo is zeroed once; later writes touch the interior only.
  for (int i = threadIdx.x; i < kTeams * kBuf; i += kThreads) bufs[i] = 0.f;
  __syncthreads();

  const int team = threadIdx.x / kTeamThreads;
  Place pl;
  pl.t = threadIdx.x % kTeamThreads;
  pl.warp = pl.t / 32;
  pl.lane = pl.t % 32;
  const int w = pl.lane & 7;
  const int d = (pl.warp & 1) * 4 + (pl.lane >> 3);
  const int h0 = ((pl.warp >> 1) & 1) * kVox;
  pl.co0 = (pl.warp >> 2) * kCo;
  pl.base = d * kSD + h0 * kSH + w;
  pl.voxel = (d * kLeaf + h0) * kLeaf + w;
  float* buf = bufs + team * kBuf;
  float* red = reds + team * kRed;

  for (int leaf0 = blockIdx.x * kTeams; leaf0 < b;
       leaf0 += gridDim.x * kTeams) {
    const int leaf = leaf0 + team;
    const bool live = leaf < b;  // an idle team computes on zeros
    const size_t at =
        (static_cast<size_t>(live ? leaf : 0) * kVoxels + pl.voxel) * kC +
        pl.co0;
    float xr[kVox][kCo];
#pragma unroll
    for (int j = 0; j < kVox; ++j) {
      if (live) {
        load8(x + at + static_cast<size_t>(j) * kLeaf * kC, xr[j]);
      } else {
#pragma unroll
        for (int k = 0; k < kCo; ++k) xr[j][k] = 0.f;
      }
    }

    float acc[kVox][kCo];
    gn_relu_to_buffer(xr, buf, red, pl, cpg, eps, prm_s, prm_s + kC);
    __syncthreads();
    conv3x3x3(buf, w1_s, prm_s + 2 * kC, pl, acc);
    gn_relu_to_buffer(acc, buf, red, pl, cpg, eps, prm_s + 3 * kC,
                      prm_s + 4 * kC);
    __syncthreads();
    conv3x3x3(buf, w2_s, prm_s + 5 * kC, pl, acc);

    if (live) {
#pragma unroll
      for (int j = 0; j < kVox; ++j) {
#pragma unroll
        for (int k = 0; k < kCo; ++k) {
          acc[j][k] = xr[j][k] + res_scale * acc[j][k];
        }
        store8(out + at + static_cast<size_t>(j) * kLeaf * kC, acc[j]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* w2, const void* prm,
           void* out, int b, int groups, float res_scale, float eps,
           void* stream) {
  if (b <= 0 || groups <= 0 || kC % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      residual_block16_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int pairs = (b + kTeams - 1) / kTeams;
  const int blocks = pairs < sms ? pairs : sms;
  residual_block16_kernel<T><<<blocks, kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<const float*>(prm),
      static_cast<T*>(out), b, kC / groups, res_scale, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: [b, 8, 8, 8, 16] dense NDHWC, bf16 when x_is_bf16 else f32,
// 16-byte aligned. w1, w2: [27, 16, 16] f32 (tap, in, out). prm: [6, 16] f32
// rows gn1 scale, gn1 bias, conv1 bias, gn2 scale, gn2 bias, conv2 bias.
// groups divides 16.
extern "C" int vq_residual_block16(const void* x, int x_is_bf16,
                                   const void* w1, const void* w2,
                                   const void* prm, void* out, int b,
                                   int groups, float res_scale, float eps,
                                   void* stream) {
  if (x_is_bf16) {
    return launch<__nv_bfloat16>(x, w1, w2, prm, out, b, groups, res_scale,
                                 eps, stream);
  }
  return launch<float>(x, w1, w2, prm, out, b, groups, res_scale, eps,
                       stream);
}
