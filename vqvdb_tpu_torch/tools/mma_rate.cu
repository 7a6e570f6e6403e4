// What the tensor cores give each MMA instruction shape that a 16-output-
// channel implicit GEMM could use, bf16 in and f32 sums, on every SM at once:
//   0: mma.sync m16n8k16, 12 warps a block, 8 independent accumulators a warp;
//   1: wgmma m64n16k16, A from registers, B from shared memory, 3 warpgroups
//      a block, 8 independent accumulators a warpgroup;
//   2, 3, 4: wgmma m64n32k16, m64n48k16, m64n64k16, the same with 4, 3 and 2
//      accumulators.
// One block per SM, `iters` rounds of back-to-back MMAs; the sums go to
// `sink` so that nothing is optimised away. Measurement only
// (tools/rb_phases.py); no kernel of the package calls it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;
constexpr uint32_t kOnes = 0x3C003C00u;  // a bf16 pair of 2^-7

// Independent accumulators a warpgroup keeps in flight at wgmma width n.
__host__ __device__ constexpr int chains(int n) { return n == 16 ? 8 : n == 32 ? 4 : n == 48 ? 3 : 2; }

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%8}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b));
}

__device__ __forceinline__ void a_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = kOnes + ((threadIdx.x + i) & 1);
}

__global__ void __launch_bounds__(kThreads, 1) mma_sync_kernel(int iters, float* sink) {
  float d[8][4] = {};
  uint32_t a[4];
  a_regs(a);
  const uint32_t b = kOnes;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 8; ++c) mma(d[c], a, b);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  sink[blockIdx.x * kThreads + threadIdx.x] = s;
}

// B descriptor: no swizzle, K-major; LBO 128 B between the two 8-deep
// halves, SBO 256 B between groups of 8 columns.
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) | (static_cast<uint64_t>(256 >> 4) << 32);
}

// D += A * B with A m64k16 from registers, B k16nN from shared memory:
// N / 2 f32 accumulators a thread.
#define VQ_D8(d, i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define VQ_WGMMA_N(N, REGS, A0, A1, A2, A3, DESC, SCALE, ...)                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" SCALE ", 0;\n"                      \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32.bf16.bf16 {" REGS "}, "     \
               "{%" A0 ",%" A1 ",%" A2 ",%" A3 "}, %" DESC ", p, 1, 1, 0;\n}\n"          \
               : __VA_ARGS__                                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1))

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc);
template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  VQ_WGMMA_N("16", "%0,%1,%2,%3,%4,%5,%6,%7", "8", "9", "10", "11", "12", "13", VQ_D8(d, 0));
}
template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  VQ_WGMMA_N("32", "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15", "16", "17", "18", "19",
             "20", "21",
             VQ_D8(d, 0), VQ_D8(d, 8));
}
template <>
__device__ __forceinline__ void wgmma<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t desc) {
  VQ_WGMMA_N("48",
             "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
             "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23",
             "24", "25", "26", "27", "28", "29",
             VQ_D8(d, 0), VQ_D8(d, 8), VQ_D8(d, 16));
}
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  VQ_WGMMA_N("64",
             "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
             "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
             "%24,%25,%26,%27,%28,%29,%30,%31",
             "32", "33", "34", "35", "36", "37", VQ_D8(d, 0), VQ_D8(d, 8), VQ_D8(d, 16),
             VQ_D8(d, 24));
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1) wgmma_kernel(int iters, float* sink) {
  constexpr int kChains = chains(N);
  constexpr int kRegs = N / 2;  // f32 accumulators a thread per m64nN tile
  __shared__ __align__(128) uint32_t b[16 * N / 2];
  for (int i = threadIdx.x; i < 16 * N / 2; i += kThreads) b[i] = kOnes;
  __syncthreads();
  const uint64_t desc = b_descriptor(static_cast<uint32_t>(__cvta_generic_to_shared(b)));
  uint32_t a[4];
  a_regs(a);
  float d[kChains][kRegs] = {};
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int c = 0; c < kChains; ++c) wgmma<N>(d[c], a, desc);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int i = 0; i < kRegs; ++i) s += d[c][i];
  sink[blockIdx.x * kThreads + threadIdx.x] = s;
}

int sms() {
  int device = 0, n = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n;
}

}  // namespace

// FLOPs of one vq_mma_rate launch.
extern "C" double vq_mma_rate_flops(int shape, int iters) {
  const int n = 16 * shape;
  const double per_block = shape == 0 ? 12.0 * 8 * 2 * 16 * 8 * 16 : 3.0 * chains(n) * 2 * 64 * n * 16;
  return per_block * iters * sms();
}

// shape 0 to 4 as above; sink: float [SMs * 384] on the device.
extern "C" int vq_mma_rate(int shape, int iters, void* sink, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(sink);
  if (shape == 0) mma_sync_kernel<<<sms(), kThreads, 0, s>>>(iters, out);
  else if (shape == 1) wgmma_kernel<16><<<sms(), kThreads, 0, s>>>(iters, out);
  else if (shape == 2) wgmma_kernel<32><<<sms(), kThreads, 0, s>>>(iters, out);
  else if (shape == 3) wgmma_kernel<48><<<sms(), kThreads, 0, s>>>(iters, out);
  else if (shape == 4) wgmma_kernel<64><<<sms(), kThreads, 0, s>>>(iters, out);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
