// Codebook lookup: out[n, :] = codebook[idx[n], :], zero row when idx is
// outside [0, K).
//
// Replaces: vqvdb_tpu/ops/quantize.py:fused_dequantize (_dequant_kernel),
// which ran the lookup as one-hot(idx) @ codebook per 1024-row tile because
// row gathers are slow on the TPU. On Hopper a gather is the natural form,
// so this kernel copies rows directly. An out-of-range index writes zeros,
// as the one-hot product gives.
//
// Bound on the H100: bytes. At the codec's batch (N = 4096 leaves x 64 =
// 262,144 rows, D = 128) it reads 262 KB of u8 indices and the codebook
// once (64 KB bf16 / 128 KB f32) and writes 67 MB (bf16) of rows: about
// 20 us at 3.35 TB/s. No arithmetic to speak of.
//
// Simple design: the kernel is dtype-blind (a row is row_bytes bytes). Each
// thread moves one vector of the widest of 16, 8, 4 or 2 bytes that divides
// the row and the two pointers' alignment (16 for every shipped model's
// rows), neighbouring threads neighbouring vectors of the output, so stores
// coalesce fully;
// codebook reads go through the read-only path and stay in L2. It reads
// the u8 indices of the file batch directly (no int32 widening pass) and
// also takes int32 indices.
//
// Later fast design: fuse the gather into the decoder stem conv's operand
// load, so the [N, D] rows never reach device memory at all.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename Vec>
__device__ __forceinline__ Vec zero_vec();
template <>
__device__ __forceinline__ uint4 zero_vec<uint4>() { return make_uint4(0u, 0u, 0u, 0u); }
template <>
__device__ __forceinline__ uint2 zero_vec<uint2>() { return make_uint2(0u, 0u); }
template <>
__device__ __forceinline__ unsigned int zero_vec<unsigned int>() { return 0u; }
template <>
__device__ __forceinline__ unsigned short zero_vec<unsigned short>() { return 0; }

template <typename Idx, typename Vec>
__global__ void dequantize_kernel(const Idx* __restrict__ idx,
                                  const Vec* __restrict__ codebook,
                                  Vec* __restrict__ out, int total, int k,
                                  int vecs_per_row) {
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    const int row = v / vecs_per_row;
    const int col = v - row * vecs_per_row;
    const long long i = static_cast<long long>(idx[row]);
    Vec val = zero_vec<Vec>();
    if (i >= 0 && i < k) {
      val = __ldg(codebook + i * vecs_per_row + col);
    }
    out[v] = val;
  }
}

template <typename Vec>
void launch_vec(const void* idx, int index_bytes, const void* codebook, void* out,
                int total, int k, int vecs_per_row, cudaStream_t s) {
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  const Vec* cb = static_cast<const Vec*>(codebook);
  Vec* o = static_cast<Vec*>(out);
  if (index_bytes == 1) {
    dequantize_kernel<uint8_t, Vec><<<blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(idx), cb, o, total, k, vecs_per_row);
  } else {
    dequantize_kernel<int32_t, Vec><<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(idx), cb, o, total, k, vecs_per_row);
  }
}

extern "C" const char* vq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// idx: n indices of index_bytes (1 = u8, 4 = int32) each; codebook: k rows
// of row_bytes (even); out: n rows of row_bytes. The vector width is the
// widest of 16, 8, 4, 2 bytes dividing row_bytes and both row pointers.
extern "C" int vq_dequantize(const void* idx, int index_bytes,
                             const void* codebook, void* out, int n, int k,
                             int row_bytes, void* stream) {
  if (n <= 0 || k <= 0 || row_bytes <= 0 || row_bytes % 2 != 0 ||
      (index_bytes != 1 && index_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned long long align =
      reinterpret_cast<uintptr_t>(codebook) | reinterpret_cast<uintptr_t>(out) |
      static_cast<unsigned long long>(row_bytes);
  const int width = align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : align % 4 == 0 ? 4 : 2;
  if (align % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vecs_per_row = row_bytes / width;
  const long long total = static_cast<long long>(n) * vecs_per_row;
  if (total > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(total);
  switch (width) {
    case 16: launch_vec<uint4>(idx, index_bytes, codebook, out, t, k, vecs_per_row, s); break;
    case 8: launch_vec<uint2>(idx, index_bytes, codebook, out, t, k, vecs_per_row, s); break;
    case 4: launch_vec<unsigned int>(idx, index_bytes, codebook, out, t, k, vecs_per_row, s); break;
    default: launch_vec<unsigned short>(idx, index_bytes, codebook, out, t, k, vecs_per_row, s);
  }
  return static_cast<int>(cudaGetLastError());
}
