// GroupNorm, its affine, the cast back to the input's type and the ReLU
// that follows, over dense channels-last leaves, in one pass over memory:
//     out = relu(to_dtype(((x - mean_g) * rsqrt(var_g + eps)) * scale + bias))
// with each leaf's per-group mean and variance in f32.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses it. Eager PyTorch does not: `models/blocks.py::group_norm` runs a
// cast, two means, two subtracts, a square, a multiply by rsqrt, the scale
// multiply and bias add and a cast back, each a pass over the whole
// activation in f32, and the ReLU after it one more.
//
// Bound on the H100: bytes. The kernel reads each leaf once and writes it
// once: 2 * B * S * C * sizeof(x), 0.160 ms at 3.35 TB/s for a 4,096-leaf
// batch of 8^3 x 64 bf16 leaves (537 MB). The arithmetic, about ten f32
// operations a value, is far below the card's rate.
//
// Arithmetic: the eager version's, rounding for rounding, but for the order
// of the two sums. Statistics are two-pass: the mean, then the mean of the
// squared deviations (not E[x^2] - mean^2), each a sum in a fixed order
// times 1/N. Every value then takes the eager sequence of f32 roundings,
// with no FMA contraction: x - mean, times rsqrtf(var + eps), times scale,
// plus bias; rounded to x's type (round to nearest even); ReLU keeps a
// NaN, as torch.relu does. A leaf's bits depend only on (S, C, G, dtype):
// the plan is fixed by those, so a leaf gives the same bits whatever the
// batch size and wherever it sits in its block.
//
// Design (the plan is `ops/group_norm.py::group_norm_plan`, passed in):
//   * A block copies its l leaves, one contiguous stretch of device memory,
//     into shared memory with 16-byte cp.async copies (every thread a share,
//     no registers held while they fly), then reads them there for the two
//     sums and the write. A tile is 64 KB of bf16 for the cells' shapes (one
//     8^3 x 64 leaf, four 4^3 x 128 leaves), so three blocks share an SM and
//     one block's copy overlaps another's arithmetic and stores; a first
//     version held the leaf in registers, spilled at 8^3 x 64 bf16 and ran
//     at 37% of the byte bound. A leaf too large for that (4^3 x 1024 in
//     f32, which no shipped model has) is read from device memory in each
//     pass instead, one leaf a block, in the same order; the plan says
//     which (`staged`), and the launch refuses a block that asks for more
//     shared memory than the card gives one.
//   * A vector is the widest of 16, 8, 4 or 2 bytes that holds ve channels
//     of one group: 16 bytes for the cells' shapes, neighbouring threads on
//     neighbouring vectors in shared memory and in the output.
//   * A leaf of S voxels x C channels is nv = S * C / ve vectors. A team of
//     tl = nv / v threads owns it, thread u taking vectors u, u + tl, ...
//     (v = 8 a thread, more where a team would pass 512 threads); v divides
//     S, so tl is a multiple of the C / ve vectors of a voxel and every
//     vector of a thread lies in the same channels and group. l = max(1,
//     512 / tl) teams make a block, rounded up to whole warps.
//   * Each sum: every thread's own values in order; the partials of a
//     (leaf, group) pair (tl / G threads) summed by one warp, lane j taking
//     members j, j + 32, ... in order, then an xor butterfly over the 32
//     lanes (every lane ends with the same sum); the pair's total goes to
//     shared memory for the leaf's threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxDevices = 64;

template <typename T, int VE>
struct alignas(sizeof(T) * VE) Vec {
  T v[VE];
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// relu of a value already rounded to T: keeps a NaN (NaN < 0 is false).
template <typename T>
__device__ __forceinline__ T relu(T y) {
  return widen(y) < 0.f ? narrow<T>(0.f) : y;
}

// What the block shares besides its tile: each thread's partial sum and
// each (leaf, group) pair's total.
struct Shared {
  float* partial;  // [threads]
  float* total;    // [l * groups]
};

// The total of this thread's group in its leaf, from every thread's partial
// `s`: warp w sums pairs w, w + warps, ... in the fixed order above. Every
// thread of the block calls it (it holds two barriers).
__device__ __forceinline__ float group_total(float s, const Shared& sh, int here, int tl,
                                             int vv, int gv, int groups, int team, int g) {
  sh.partial[threadIdx.x] = s;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int members = tl / groups;
  for (int p = threadIdx.x >> 5; p < here * groups; p += warps) {
    const int pt = p / groups, pg = p - pt * groups;
    const float* part = sh.partial + pt * tl + pg * gv;  // member i: thread m * vv + j
    float t = 0.f;
    for (int i = lane; i < members; i += 32) {
      const int m = i / gv;
      t = __fadd_rn(t, part[m * vv + (i - m * gv)]);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, off));
    }
    if (lane == 0) sh.total[p] = t;
  }
  __syncthreads();
  return team < here ? sh.total[team * groups + g] : 0.f;
}

template <typename T, int VE, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_relu_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out, int leaves,
                       int leaf_elems, int vv, int gv, int groups, int tl, int v, int l,
                       float eps, float inv_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Vt = Vec<T, VE>;
  const long long first = static_cast<long long>(blockIdx.x) * l;
  const int here = static_cast<int>(min(static_cast<long long>(l), leaves - first));
  float* after_tile = reinterpret_cast<float*>(smem + (kStaged ? l * leaf_elems * sizeof(T) : 0));
  const Shared sh{after_tile, after_tile + blockDim.x};
  const int team = threadIdx.x / tl;
  const int u = threadIdx.x - team * tl;
  const bool live = team < here;
  const int g = (u % vv) / gv;
  const Vt* mine;  // this thread's k-th vector at mine[k * tl]
  if constexpr (kStaged) {
    const uint4* src = reinterpret_cast<const uint4*>(x + first * leaf_elems);
    const int chunks = here * leaf_elems * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem + 16 * i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src + i));
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    mine = reinterpret_cast<const Vt*>(smem) + team * tl * v + u;
  } else {  // a leaf too large for shared memory, read from device memory (L2) each time
    mine = reinterpret_cast<const Vt*>(x + (first + team) * leaf_elems) + u;
  }

  float s = 0.f;
  if (live) {
    for (int k = 0; k < v; ++k) {
      const Vt r = mine[k * tl];
#pragma unroll
      for (int e = 0; e < VE; ++e) s = __fadd_rn(s, widen(r.v[e]));
    }
  }
  const float mean = __fmul_rn(group_total(s, sh, here, tl, vv, gv, groups, team, g), inv_n);
  float q = 0.f;
  if (live) {
    for (int k = 0; k < v; ++k) {
      const Vt r = mine[k * tl];
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const float d = __fsub_rn(widen(r.v[e]), mean);
        q = __fadd_rn(q, __fmul_rn(d, d));
      }
    }
  }
  const float var = __fmul_rn(group_total(q, sh, here, tl, vv, gv, groups, team, g), inv_n);
  if (!live) return;
  const float rstd = rsqrtf(__fadd_rn(var, eps));

  const int c0 = (u % vv) * VE;  // first channel of every vector of this thread
  float sc[VE], bi[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) {
    sc[e] = __ldg(scale + c0 + e);
    bi[e] = __ldg(bias + c0 + e);
  }
  Vt* dst = reinterpret_cast<Vt*>(out + (first + team) * leaf_elems) + u;
  for (int k = 0; k < v; ++k) {
    const Vt r = mine[k * tl];
    Vt o;
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      float y = __fmul_rn(__fsub_rn(widen(r.v[e]), mean), rstd);
      y = __fadd_rn(__fmul_rn(y, sc[e]), bi[e]);
      o.v[e] = relu(narrow<T>(y));
    }
    dst[k * tl] = o;
  }
}

template <typename T, int VE, bool kStaged>
int launch_staged(const void* x, const float* scale, const float* bias, void* out, int leaves,
                  int leaf_elems, int vv, int gv, int groups, int tl, int v, int l, float eps,
                  float inv_n, cudaStream_t s) {
  auto kernel = group_norm_relu_kernel<T, VE, kStaged>;
  const int threads = (tl * l + 31) / 32 * 32;
  const int smem = (kStaged ? l * leaf_elems * static_cast<int>(sizeof(T)) : 0) +
                   (threads + l * groups) * static_cast<int>(sizeof(float));
  // Raised once per device to the most a block may ask for there (above
  // the 48 KB a launch gets without asking).
  static int most[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!most[dev]) {
    int optin = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    most[dev] = optin;
  }
  if (smem > most[dev]) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (leaves + l - 1) / l;
  kernel<<<blocks, threads, smem, s>>>(static_cast<const T*>(x), scale, bias,
                                       static_cast<T*>(out), leaves, leaf_elems, vv, gv,
                                       groups, tl, v, l, eps, inv_n);
  return static_cast<int>(cudaGetLastError());
}

// Leaves go through shared memory where the plan stages them (every shape
// the shipped models reach), else each pass reads device memory.
template <typename T, int VE>
int launch_ve(const void* x, const float* scale, const float* bias, void* out, int leaves,
              int leaf_elems, int vv, int gv, int groups, int tl, int v, int l, bool staged,
              float eps, float inv_n, cudaStream_t s) {
  if (staged) {
    return launch_staged<T, VE, true>(x, scale, bias, out, leaves, leaf_elems, vv, gv, groups,
                                      tl, v, l, eps, inv_n, s);
  }
  return launch_staged<T, VE, false>(x, scale, bias, out, leaves, leaf_elems, vv, gv, groups,
                                     tl, v, l, eps, inv_n, s);
}

template <typename T>
int launch(const void* x, const float* scale, const float* bias, void* out, int leaves,
           int leaf_elems, int vv, int gv, int groups, int tl, int ve, int v, int l,
           bool staged, float eps, float inv_n, cudaStream_t s) {
  switch (ve * static_cast<int>(sizeof(T))) {
    case 16:
      return launch_ve<T, 16 / sizeof(T)>(x, scale, bias, out, leaves, leaf_elems, vv, gv,
                                          groups, tl, v, l, staged, eps, inv_n, s);
    case 8:
      return launch_ve<T, 8 / sizeof(T)>(x, scale, bias, out, leaves, leaf_elems, vv, gv,
                                         groups, tl, v, l, staged, eps, inv_n, s);
    case 4:
      return launch_ve<T, 4 / sizeof(T)>(x, scale, bias, out, leaves, leaf_elems, vv, gv,
                                         groups, tl, v, l, staged, eps, inv_n, s);
    case 2:  // one bf16 value
      return launch_ve<T, 1>(x, scale, bias, out, leaves, leaf_elems, vv, gv, groups, tl, v,
                             l, staged, eps, inv_n, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

}  // namespace

extern "C" const char* vq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: [leaves, s, c] dense channels-last, bf16 when x_is_bf16 else f32,
// 16-byte aligned. scale, bias: [c] f32. The plan (ve values a vector, v
// vectors a thread, l leaves a block) is `group_norm_plan`'s; it is checked
// here against the shape, and a plan the kernel cannot run is refused with
// cudaErrorInvalidValue. `staged`: the block's leaves go through shared
// memory.
extern "C" int vq_group_norm_relu(const void* x, int x_is_bf16, const void* scale,
                                  const void* bias, void* out, int leaves, int s, int c,
                                  int groups, int ve, int v, int l, int staged, float eps,
                                  void* stream) {
  const int elem = x_is_bf16 ? 2 : 4;
  if (leaves <= 0 || s <= 0 || c <= 0 || groups <= 0 || c % groups != 0 || !pow2(ve) ||
      ve * elem > 16 || (c / groups) % ve != 0 || v <= 0 || s % v != 0 || l <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vv = c / ve, gv = (c / groups) / ve;
  const long long tl = static_cast<long long>(s) * vv / v;
  const long long leaf_bytes = static_cast<long long>(s) * c * elem;
  if (tl * l > kMaxThreads || leaf_bytes % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if (align % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const float inv_n = 1.0f / static_cast<float>(s * (c / groups));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (x_is_bf16) {
    return launch<__nv_bfloat16>(x, sc, bi, out, leaves, s * c, vv, gv, groups,
                                 static_cast<int>(tl), ve, v, l, staged != 0, eps, inv_n, st);
  }
  return launch<float>(x, sc, bi, out, leaves, s * c, vv, gv, groups, static_cast<int>(tl), ve,
                       v, l, staged != 0, eps, inv_n, st);
}
