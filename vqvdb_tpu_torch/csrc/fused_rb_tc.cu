// The 16-channel pre-activation residual block of 8^3 leaves in one kernel,
// its two 3x3x3 convs on the tensor cores:
//     out = x + res_scale * conv2(relu(gn2(conv1(relu(gn1(x))))))
// with SAME convs (bias included), GroupNorm per (leaf, group) with f32
// statistics, and every intermediate kept on the chip: x is read from device
// memory twice (GroupNorm, then the residual sum, from L2) and out is
// written once.
//
// Replaces: vqvdb_tpu/ops/fused_rb.py:residual_block_fused (_rb_kernel).
// That kernel lays a leaf out as 64 rows x 128 (w, c) lanes and multiplies
// by nine banded block-Toeplitz matrices, a device for a 128x128 matrix
// unit; it is not carried over. Here each conv is an implicit GEMM per leaf:
// M = 512 voxels, N = 16 output channels, K = 27 taps x 16 input channels.
//
// Arithmetic follows the TPU kernel: x is widened to f32, GroupNorm takes
// f32 statistics in the two-pass form (mean, then the mean of squared
// deviations; the TPU kernel's E[x^2] - mean^2 differs by rounding only),
// relu keeps NaN, and the result x + res_scale * h2 is rounded to x's type
// once. Conv products are f32-grade, made of bf16 tensor-core products with
// f32 sums, as in csrc/score_argmin_tc.cu: an f32 value is the exact sum of
// three bf16 terms hi + mid + lo. The GroupNorm output (f32) is split into
// its three terms once, when it is written to shared memory.
//   bf16 x: the weights are rounded to bf16 (their hi term), as the TPU
//     kernel does, and are one term: 3 products, lo*w, mid*w, hi*w.
//   f32 x:  the weights are split too, and the 6 products of order <= 2 are
//     kept: lo*hi, mid*mid, hi*lo, mid*hi, hi*mid, hi*hi (activation term
//     first). A non-finite activation keeps only its hi term: its mid and
//     lo are zero, and it is zeroed in the hi*mid and hi*lo products, so
//     that inf times a zero small weight term does not become NaN.
// Products start small first at every step; no atomics, so the same input
// gives the same bits.
//
// Bound on the H100 at the codec's batch (B = 4096 leaves): a leaf has 22^3
// (voxel, tap) pairs off the zero padding (22 valid taps over the 8
// positions of each axis), so two convs of 4096*22^3*16*16*2 = 22.3 GFLOP
// each. bf16 tensor cores at 989 TFLOP/s: bf16 x (3 products) 0.135 ms,
// f32 x (6 products) 0.271 ms: bound by operations. The bytes (x in, out:
// 67 MB in bf16, 134 MB in f32) take 0.040 and 0.080 ms at 3.35 TB/s. (The
// first version ran f32 FMAs on the CUDA cores over all 27 taps and took
// 1.46 ms.)
//
// Design:
//   * mma.sync m16n8k16 (bf16 in, f32 sums). A team of 4 warps owns a leaf;
//     warp w owns the 128 output voxels with h in {2w, 2w + 1}: 8 d slabs x
//     16 rows (h, w), as 8 row tiles x 16 channels = 64 f32 accumulators a
//     thread. Four teams a block for bf16 x (128 registers), three for f32
//     x (168 registers, 81 KB of weights), one block per SM. Not wgmma: at
//     N = 16 output channels, m64n16k16 runs no faster than mma.sync (0.60
//     against 0.64 PFLOP/s back to back, tools/mma_rate.cu); the wider
//     m64n32k16 / m64n48k16 (0.93 / 0.98) need the accumulators of 2-3 d
//     slabs as one operand, and every such layout tried made ptxas
//     serialise the MMAs for want of registers (C7511), slower than this.
//   * A fragment of input slab d_in at tap (kh, kw) serves the three taps
//     kd = 0..2, each into the accumulators of output slab d_in + 1 - kd, so
//     every A fragment read from shared memory feeds 3 (bf16 x) or 6 (f32 x)
//     MMA pairs, and no MMA runs on the zero halo in d. The halo in h and w is
//     a 128-byte zero region that a lane's ldmatrix row address points to
//     where the shifted voxel lies outside the leaf.
//   * Activations: three bf16 planes (hi, mid, lo) of [512 voxels][16 ch],
//     48 KB per leaf, unhaloed. A voxel is two 16-byte halves (channels 0-7,
//     8-15); half hf of voxel v sits at 16-byte unit 2 v + (hf ^ (v >> 2 & 1)).
//     The swizzle is a function of the voxel alone, so any 8 consecutive
//     voxels (an ldmatrix phase, at any tap shift) fall in 8 distinct bank
//     groups; a zero row takes the unit, mod 8, that its voxel would have.
//   * Weights: both convs' B fragments in shared memory in the order the
//     lanes read them (one 16-byte load per lane, tap and term): 27 KB for
//     bf16 x, 81 KB as three terms for f32 x; split and arranged by each
//     block at its start from the [27, 16, 16] f32 weights.
//   * GroupNorm on the accumulators: per-thread sums, shuffles over the 8
//     lanes of a quad column, a [4 warps][16] table, group totals in a fixed
//     order (deterministic), two passes; then normalise, relu, split and
//     write the three planes that the next conv reads. conv1's result never
//     leaves the registers until it is written as conv2's operand.
//   * Shared memory: weights + 128 B of zeros + teams x (48 KB planes +
//     512 B of GroupNorm scratch) = 221 KB (bf16 x) or 227 KB (f32 x). Teams
//     sync with named barriers only, so a team runs its leaves without
//     waiting for the others: one team's GroupNorm and loads run under
//     another's MMAs.
//   * What bounds it (tools/rb_phases.py): with the ldmatrix reads and
//     GroupNorm compiled out the kernel takes as long as whole, so it is
//     bound by the MMAs themselves, which run at about two thirds of
//     mma.sync's back-to-back rate. The MMAs on the h and w halo (zero rows)
//     are 16% of those it runs.
//   * VQ_RB_SKIP_LDSM, VQ_RB_SKIP_MMA and VQ_RB_SKIP_GN exist only for
//     tools/rb_phases.py, which builds this file with one of them set to
//     time the kernel without that part; the codec never sets them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;             // channels
constexpr int kVoxels = 512;       // 8^3
constexpr int kTaps = 27;
constexpr int kWarps = 4;          // warps of a team; warp w owns h = 2w, 2w + 1
constexpr int kTeamThreads = 32 * kWarps;
constexpr int kSlabBytes = 64 * kC * 2;          // one d slab of a plane
constexpr int kPlaneBytes = 8 * kSlabBytes;      // one bf16 term of a leaf
constexpr int kPlanes = 3;                       // hi, mid, lo
constexpr int kRedFloats = 2 * kWarps * kC;      // GroupNorm scratch, two passes
constexpr int kTeamBytes = kPlanes * kPlaneBytes + kRedFloats * 4;
constexpr int kZeroBytes = 128;
constexpr int kSmemLimit = 232448;

// Per input type: weight terms, activation fragments and products.
template <typename T>
struct Arith;

template <>
struct Arith<__nv_bfloat16> {
  static constexpr int kTeams = 4;  // leaves in flight per block
  static constexpr int kWTerms = 1;
  static constexpr int kATerms = 3;  // 0 hi, 1 mid, 2 lo
  static constexpr int kProducts = 3;
  // (activation term, weight term) of product p: lo*w, mid*w, hi*w
  static __device__ __forceinline__ constexpr int a_term(int p) { return 2 - p; }
  static __device__ __forceinline__ constexpr int w_term(int) { return 0; }
};

template <>
struct Arith<float> {
  static constexpr int kTeams = 3;
  static constexpr int kWTerms = 3;
  static constexpr int kATerms = 4;  // and 3: hi with its non-finite values zeroed
  static constexpr int kProducts = 6;
  // lo*hi, mid*mid, hi*lo, mid*hi, hi*mid, hi*hi
  static __device__ __forceinline__ constexpr int a_term(int p) {
    return p == 0 ? 2 : p == 1 ? 1 : p == 2 ? 3 : p == 3 ? 1 : p == 4 ? 3 : 0;
  }
  static __device__ __forceinline__ constexpr int w_term(int p) {
    return p == 0 ? 0 : p == 1 ? 1 : p == 2 ? 2 : p == 3 ? 0 : p == 4 ? 1 : 0;
  }
};

template <typename T>
__host__ __device__ constexpr int weight_bytes() {
  return 2 * kTaps * Arith<T>::kWTerms * 32 * 16;
}
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return weight_bytes<T>() + kZeroBytes + Arith<T>::kTeams * kTeamBytes;
}
static_assert(smem_bytes<float>() <= kSmemLimit, "f32 layout exceeds shared memory");
static_assert(smem_bytes<__nv_bfloat16>() <= kSmemLimit, "bf16 layout exceeds shared memory");

// ---------------------------------------------------------------------------
// PTX wrappers and the bf16 split
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "n"(kTeamThreads) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
#ifndef VQ_RB_SKIP_LDSM
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
#else  // measurement only: tools/rb_phases.py (no shared-memory reads)
  for (int i = 0; i < 4; ++i) r[i] = (addr ^ i) & 0x3F803F80u;
#endif
}

// d += a * b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 f32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
#ifndef VQ_RB_SKIP_MMA  // measurement only: tools/rb_phases.py
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#endif
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Mask of the halves of a bf16 pair that are finite.
__device__ __forceinline__ uint32_t finite_mask(uint32_t w) {
  return ((w & 0x7F80u) != 0x7F80u ? 0xFFFFu : 0u) |
         ((w & 0x7F800000u) != 0x7F800000u ? 0xFFFF0000u : 0u);
}

// A bf16 pair with its non-finite halves zeroed, in five integer operations:
// adding 0x80 to an all-ones exponent carries into the half's top bit.
__device__ __forceinline__ uint32_t finite_only(uint32_t w) {
  const uint32_t top = ((w & 0x7F807F80u) + 0x00800080u) & 0x80008000u;
  return w & ~((top >> 15) * 0xFFFFu);
}

// x0, x1 -> the pairs of their hi, mid and lo bf16 terms (x0 in the low
// half). x - hi and (x - hi) - mid are exact in f32. Where hi is not finite
// mid and lo are zero.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&t)[3]) {
  const uint32_t hi = pack_bf16(x0, x1);
  const uint32_t fin = finite_mask(hi);
  const float r0 = (fin & 0xFFFFu) ? x0 - __uint_as_float(hi << 16) : 0.f;
  const float r1 = (fin >> 16) ? x1 - __uint_as_float(hi & 0xFFFF0000u) : 0.f;
  const uint32_t mid = pack_bf16(r0, r1);
  t[0] = hi;
  t[1] = mid;
  t[2] = pack_bf16(r0 - __uint_as_float(mid << 16), r1 - __uint_as_float(mid & 0xFFFF0000u));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// Where a thread's values sit
// ---------------------------------------------------------------------------
//
// Accumulator v[d][nh][2 rr + j] of the thread (warp w, lane = 4 g + t) is
// output channel 8 nh + 2 t + j of voxel (d, h = 2 w + rr, w = g): the mma
// D fragment of row tile d (rows = 16 (h, w) voxels of slab d, row g + 8 rr)
// and n-half nh. x is loaded, and out stored, in the same places.

struct Place {
  int warp, lane, g, t;
  __device__ __forceinline__ int voxel(int d, int rr) const {
    return d * 64 + (2 * warp + rr) * 8 + g;
  }
};

// Weight fragments in shared memory: uint4 [conv][tap][term][lane]; word j of
// lane (g, t) holds the pair W[ci][co], W[ci + 1][co] with ci = 2 t + 8 (j & 1),
// co = 8 (j >> 1) + g: the mma B fragment (b0, b1) of n-half nh is words
// 2 nh, 2 nh + 1. w: [27 taps][16 in][16 out] f32 per conv.
template <typename T>
__device__ __forceinline__ void stage_weights(const float* __restrict__ w1,
                                              const float* __restrict__ w2, uint32_t* wsm) {
  constexpr int P = Arith<T>::kWTerms;
  for (int i = threadIdx.x; i < 2 * kTaps * 32 * 4; i += blockDim.x) {
    const int j = i & 3, lane = (i >> 2) & 31, tap = (i >> 7) % kTaps, conv = (i >> 7) / kTaps;
    const int ci = 2 * (lane & 3) + 8 * (j & 1), co = 8 * (j >> 1) + (lane >> 2);
    const float* w = (conv ? w2 : w1) + tap * kC * kC;
    uint32_t terms[3];
    split_pair(w[ci * kC + co], w[(ci + 1) * kC + co], terms);
#pragma unroll
    for (int p = 0; p < P; ++p) wsm[((conv * kTaps + tap) * P + p) * 128 + lane * 4 + j] = terms[p];
  }
}

// ---------------------------------------------------------------------------
// GroupNorm + relu into the planes
// ---------------------------------------------------------------------------

// s[nh][j]: this thread's partial sum for channel 8 nh + 2 t + j. Returns the
// total over the team's leaf and the channel's group (cpg channels), summed
// in the same order by every thread. red: [4 warps][16] of the team.
__device__ __forceinline__ void group_totals(float (&s)[2][2], float* red, int team,
                                             const Place& pl, int cpg) {
#pragma unroll
  for (int nh = 0; nh < 2; ++nh)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) s[nh][j] += __shfl_xor_sync(0xffffffffu, s[nh][j], off);
  if (pl.lane < 4) {
#pragma unroll
    for (int nh = 0; nh < 2; ++nh)
#pragma unroll
      for (int j = 0; j < 2; ++j) red[pl.warp * kC + 8 * nh + 2 * pl.t + j] = s[nh][j];
  }
  team_sync(team);
#pragma unroll
  for (int nh = 0; nh < 2; ++nh)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c0 = (8 * nh + 2 * pl.t + j) / cpg * cpg;
      float tot = 0.f;
      for (int c = c0; c < c0 + cpg; ++c)
#pragma unroll
        for (int w = 0; w < kWarps; ++w) tot += red[w * kC + c];
      s[nh][j] = tot;
    }
}

// relu(GroupNorm(v)) split into hi, mid, lo and written to the team's three
// planes. The first barrier inside group_totals comes after every warp's
// reads of the planes (the conv before), so they may be overwritten.
__device__ __forceinline__ void gn_relu_store(const float (&v)[8][2][4], uint8_t* planes,
                                              float* red, int team, const Place& pl, int cpg,
                                              float eps, const float* __restrict__ scale,
                                              const float* __restrict__ bias) {
  const float inv_n = 1.f / static_cast<float>(kVoxels * cpg);
  float mean[2][2], var[2][2];
#pragma unroll
  for (int nh = 0; nh < 2; ++nh)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < 8; ++d) s += v[d][nh][j] + v[d][nh][2 + j];
      mean[nh][j] = s;
    }
#ifndef VQ_RB_SKIP_GN
  group_totals(mean, red, team, pl, cpg);
#endif
#pragma unroll
  for (int nh = 0; nh < 2; ++nh)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mean[nh][j] *= inv_n;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < 8; ++d)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float dl = v[d][nh][2 * rr + j] - mean[nh][j];
          s = fmaf(dl, dl, s);
        }
      var[nh][j] = s;
    }
#ifndef VQ_RB_SKIP_GN
  group_totals(var, red + kWarps * kC, team, pl, cpg);
#else  // measurement only: tools/rb_phases.py
  team_sync(team);
#endif
  float sc[2][2], bi[2][2];
#pragma unroll
  for (int nh = 0; nh < 2; ++nh)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 8 * nh + 2 * pl.t + j;
      var[nh][j] = 1.f / sqrtf(var[nh][j] * inv_n + eps);
      sc[nh][j] = __ldg(scale + c);
      bi[nh][j] = __ldg(bias + c);
    }
  // Word (pair 2t, 2t + 1 of half nh) of voxel v: byte 16 (2 v + (nh ^ (v >> 2 & 1))) + 4 t.
  const int swz = (pl.g >> 2) & 1;
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float z = (v[d][nh][2 * rr + j] - mean[nh][j]) * var[nh][j] * sc[nh][j] + bi[nh][j];
          y[j] = z < 0.f ? 0.f : z;  // keeps a NaN, as relu does
        }
        uint32_t terms[3];
        split_pair(y[0], y[1], terms);
        uint8_t* dst = planes + 16 * (2 * pl.voxel(d, rr) + (nh ^ swz)) + 4 * pl.t;
#pragma unroll
        for (int p = 0; p < kPlanes; ++p)
          *reinterpret_cast<uint32_t*>(dst + p * kPlaneBytes) = terms[p];
      }
}

// ---------------------------------------------------------------------------
// The conv
// ---------------------------------------------------------------------------

// acc = bias + conv of the team's planes with one conv's weight fragments
// (wconv: [27 taps][terms][32 lanes] uint4). For each (kh, kw) and input slab
// d_in a lane points ldmatrix at row (lane & 15) of the warp's 16-row tile,
// half lane >> 4: voxel (d_in, 2 warp + (row >> 3) + kh - 1, (row & 7) + kw - 1)
// of each plane, or the zero region where that lies outside the leaf.
template <typename T>
__device__ __forceinline__ void conv3x3x3(float (&acc)[8][2][4], uint32_t planes,
                                          uint32_t zero, const uint4* wconv,
                                          const float* __restrict__ bias, const Place& pl) {
  using A = Arith<T>;
  constexpr int P = A::kWTerms;
#pragma unroll
  for (int nh = 0; nh < 2; ++nh) {
    const float b0 = __ldg(bias + 8 * nh + 2 * pl.t), b1 = __ldg(bias + 8 * nh + 2 * pl.t + 1);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      acc[d][nh][0] = acc[d][nh][2] = b0;
      acc[d][nh][1] = acc[d][nh][3] = b1;
    }
  }
  const int row = pl.lane & 15, hf = pl.lane >> 4;
#pragma unroll 1
  for (int khw = 0; khw < 9; ++khw) {
    const int kh = khw / 3, kw = khw % 3;
    const int h = 2 * pl.warp + (row >> 3) + kh - 1, w = (row & 7) + kw - 1;
    const int vs = 8 * h + w;  // voxel in its slab; out of the leaf when !inside
    const int unit = 2 * vs + (hf ^ ((vs >> 2) & 1));
    const bool inside = static_cast<unsigned>(h) < 8u && static_cast<unsigned>(w) < 8u;
    const uint32_t base = inside ? planes + 16 * unit : zero + 16 * (unit & 7);
    const uint32_t dstep = inside ? kSlabBytes : 0u, pstep = inside ? kPlaneBytes : 0u;

    uint4 wf[3][P];  // taps (kd, kh, kw), kd = 0..2
#pragma unroll
    for (int kd = 0; kd < 3; ++kd)
#pragma unroll
      for (int p = 0; p < P; ++p) wf[kd][p] = wconv[((kd * 9 + khw) * P + p) * 32 + pl.lane];

    uint32_t a[2][A::kATerms][4];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) ldsm_x4(a[0][p], base + p * pstep);
#pragma unroll
    for (int din = 0; din < 8; ++din) {
      const int cur = din & 1;
      if (din + 1 < 8) {
#pragma unroll
        for (int p = 0; p < kPlanes; ++p)
          ldsm_x4(a[cur ^ 1][p], base + (din + 1) * dstep + p * pstep);
      }
      if constexpr (A::kATerms == 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[cur][A::kATerms - 1][i] = finite_only(a[cur][0][i]);
      }
#pragma unroll
      for (int p = 0; p < A::kProducts; ++p)
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          const int dout = din + 1 - kd;
          if (dout < 0 || dout > 7) continue;
          const uint4& b = wf[kd][A::w_term(p)];
          mma(acc[dout][0], a[cur][A::a_term(p)], b.x, b.y);
          mma(acc[dout][1], a[cur][A::a_term(p)], b.z, b.w);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------
//
// Shared memory: [weight fragments of both convs][128 B of zeros]
// [team 0: planes hi, mid, lo; GroupNorm scratch][team 1 ...] ...
// prm: [6][16] f32 rows gn1 scale, gn1 bias, conv1 bias, gn2 scale, gn2
// bias, conv2 bias, read through the read-only cache.

template <typename T>
__global__ void __launch_bounds__(Arith<T>::kTeams * kTeamThreads, 1)
    rb16_tc_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ w2, const float* __restrict__ prm,
                   T* __restrict__ out, int b, int cpg, float res_scale, float eps) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* zero = smem + weight_bytes<T>();
  stage_weights<T>(w1, w2, reinterpret_cast<uint32_t*>(smem));
  const uint4* wsm = reinterpret_cast<const uint4*>(smem);
  for (int i = threadIdx.x; i < kZeroBytes / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(zero)[i] = 0u;
  __syncthreads();

  // The shuffle tells the compiler that the team is uniform over the warp.
  const int team = __shfl_sync(0xffffffffu, threadIdx.x / kTeamThreads, 0);
  Place pl;
  pl.warp = (threadIdx.x / 32) % kWarps;
  pl.lane = threadIdx.x & 31;
  pl.g = pl.lane >> 2;
  pl.t = pl.lane & 3;
  uint8_t* planes = zero + kZeroBytes + team * kTeamBytes;
  float* red = reinterpret_cast<float*>(planes + kPlanes * kPlaneBytes);
  const uint32_t planes_s = smem_u32(planes), zero_s = smem_u32(zero);

  // Leaves go team-major over the grid, so a last partial wave spreads over
  // the SMs.
  for (int leaf = team * gridDim.x + blockIdx.x; leaf < b; leaf += gridDim.x * Arith<T>::kTeams) {
    const size_t at = static_cast<size_t>(leaf) * kVoxels * kC + 2 * pl.t;
    float v[8][2][4];
#pragma unroll
    for (int d = 0; d < 8; ++d)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int nh = 0; nh < 2; ++nh) {
          const float2 f = load2(x + at + pl.voxel(d, rr) * kC + 8 * nh);
          v[d][nh][2 * rr] = f.x;
          v[d][nh][2 * rr + 1] = f.y;
        }
    gn_relu_store(v, planes, red, team, pl, cpg, eps, prm, prm + kC);
    team_sync(team);
    conv3x3x3<T>(v, planes_s, zero_s, wsm, prm + 2 * kC, pl);
    gn_relu_store(v, planes, red, team, pl, cpg, eps, prm + 3 * kC, prm + 4 * kC);
    team_sync(team);
    conv3x3x3<T>(v, planes_s, zero_s, wsm + kTaps * Arith<T>::kWTerms * 32, prm + 5 * kC, pl);
#pragma unroll
    for (int d = 0; d < 8; ++d)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int nh = 0; nh < 2; ++nh) {
          const size_t i = at + pl.voxel(d, rr) * kC + 8 * nh;
          const float2 f = load2(x + i);
          store2(out + i, f.x + res_scale * v[d][nh][2 * rr],
                 f.y + res_scale * v[d][nh][2 * rr + 1]);
        }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* w2, const void* prm, void* out, int b,
           int groups, float res_scale, float eps, void* stream) {
  if (b <= 0 || groups <= 0 || kC % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(rb16_tc_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  constexpr int teams = Arith<T>::kTeams;
  const int need = (b + teams - 1) / teams;
  rb16_tc_kernel<T><<<need < sms ? need : sms, teams * kTeamThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const float*>(prm), static_cast<T*>(out), b, kC / groups, res_scale, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: [b, 8, 8, 8, 16] dense NDHWC, bf16 when x_is_bf16 else f32,
// 16-byte aligned. w1, w2: [27, 16, 16] f32 (tap, in, out); for bf16 x the
// kernel rounds them to bf16 (their hi term). prm: [6, 16] f32 rows gn1
// scale, gn1 bias, conv1 bias, gn2 scale, gn2 bias, conv2 bias. groups
// divides 16.
extern "C" int vq_residual_block16(const void* x, int x_is_bf16, const void* w1, const void* w2,
                                   const void* prm, void* out, int b, int groups,
                                   float res_scale, float eps, void* stream) {
  if (x_is_bf16) {
    return launch<__nv_bfloat16>(x, w1, w2, prm, out, b, groups, res_scale, eps, stream);
  }
  return launch<float>(x, w1, w2, prm, out, b, groups, res_scale, eps, stream);
}
