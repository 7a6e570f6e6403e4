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
// Simple design: the kernel is dtype-blind (a row is row_bytes bytes, a
// multiple of 16). Each thread moves one 16-byte vector, neighbouring
// threads neighbouring vectors of the output, so stores coalesce fully;
// codebook reads go through the read-only path and stay in L2. It reads
// the u8 indices of the file batch directly (no int32 widening pass) and
// also takes int32 indices.
//
// Later fast design: fuse the gather into the decoder stem conv's operand
// load, so the [N, D] rows never reach device memory at all.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename Idx>
__global__ void dequantize_kernel(const Idx* __restrict__ idx,
                                  const uint4* __restrict__ codebook,
                                  uint4* __restrict__ out, int total, int k,
                                  int vecs_per_row) {
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    const int row = v / vecs_per_row;
    const int col = v - row * vecs_per_row;
    const long long i = static_cast<long long>(idx[row]);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (i >= 0 && i < k) {
      val = __ldg(codebook + i * vecs_per_row + col);
    }
    out[v] = val;
  }
}

extern "C" const char* vq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// idx: n indices of index_bytes (1 = u8, 4 = int32) each; codebook: k rows
// of row_bytes; out: n rows of row_bytes. Pointers 16-byte aligned.
extern "C" int vq_dequantize(const void* idx, int index_bytes,
                             const void* codebook, void* out, int n, int k,
                             int row_bytes, void* stream) {
  if (n <= 0 || k <= 0 || row_bytes <= 0 || row_bytes % 16 != 0 ||
      (index_bytes != 1 && index_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vecs_per_row = row_bytes / 16;
  const long long total = static_cast<long long>(n) * vecs_per_row;
  if (total > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* cb = static_cast<const uint4*>(codebook);
  uint4* o = static_cast<uint4*>(out);
  if (index_bytes == 1) {
    dequantize_kernel<uint8_t><<<blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(idx), cb, o, static_cast<int>(total), k,
        vecs_per_row);
  } else {
    dequantize_kernel<int32_t><<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(idx), cb, o, static_cast<int>(total), k,
        vecs_per_row);
  }
  return static_cast<int>(cudaGetLastError());
}
