// The decoder's head: its channel-attention gate, the folded tail product,
// the bias and the head activation, for rows h [n, 64, C] (a leaf's 4^3
// latent positions x C channels, NDHWC; C 64 or 128):
//     g      = bf16(sigmoid(relu(mean_p(h) @ W1) @ W2))      (f32 inside)
//     x      = bf16(h * g)                                   (per channel)
//     out    = act(x @ Op + b)                               (f32 sums)
// with Op the folded tail (ops/tail.py:fold_decoder_tail, 64 C x N, N = 512
// C_out) rounded to bf16 once, act sigmoid (scalar) or tanh (vec3), and out
// [n, N] f32 = the leaf's 8^3 x C_out voxels. That is h in bf16, on the
// tensor cores (vq_decoder_head). For h in f32 (an f32 codec) the same
// function is computed in f32 throughout, g and x unrounded and Op the f32
// fold, on the CUDA cores (vq_decoder_head_f32; see "The f32 form" below).
//
// Replaces no TPU kernel: the JAX package leaves the attention and the tail
// product to XLA. Eager PyTorch ran them as about 26 launches a batch
// (`models/blocks.py::channel_attention`: a cast and a mean, fc1 and fc2
// as four 1,024-row products each, relu, sigmoid, a cast and the multiply;
// `ops/tail.py::apply_decoder_tail`: two casts of the operator, the
// features' cast, four 1,024-row f32 products on the CUDA cores, the bias
// and the activation). The roundings are theirs one for one: the gate in
// f32, rounded to bf16 and multiplied into the row in bf16 (one rounding of
// the exact product); then bf16 x bf16 products, exact in f32, summed in
// f32. Only the order of the sums moves.
//
// Bound on the H100 at the codec's batch (n = 4,096): operations.
//   vec3:     2 * 4096 * 8192 * 1536 = 103.1 GFLOP -> 0.104 ms at 989 TFLOP/s
//             (bytes read once and written once: 67 + 25 + 25 MB -> 0.035 ms)
//   flagship: 2 * 4096 * 4096 * 512  =  17.2 GFLOP -> 0.017 ms (bytes 0.014)
//
// Design:
//   * Two launches. The gate needs the mean over a leaf's whole row (16 KB
//     at vec3) before the first gated value is multiplied, and the product
//     reads each row once per column tile (8 at vec3, 4 at the flagship).
//     Gates computed by every product block would read each row that many
//     extra times from L2 (537 MB a vec3 batch); `gate_kernel` reads it once
//     from memory and writes only n x C bf16 gates (1 MB at vec3). This
//     split rests on that arithmetic: a one-launch form with the gates in
//     the product kernel was not built or timed against it.
//   * gate_kernel: a team of C threads a leaf, 256 / C leaves a block.
//     Thread i sums 8 channels at 8 of the 64 positions (16-byte loads,
//     neighbouring threads on neighbouring channels), the 8 partials of a
//     channel go through shared memory and are summed in a fixed order, then
//     fc1 (C / H threads a hidden unit, each a dot of H channels, their
//     partials summed in order), relu, fc2 (thread i: a dot of H) and
//     sigmoid, each in f32 in a fixed order. A leaf's gate depends on the
//     leaf alone.
//   * head_kernel: `wgmma` m64nBNk16 (bf16, f32 accumulate), one persistent
//     block a SM over tiles of 128 rows x BN columns (BN 192 where it divides
//     N, else 128: ops/decoder_head.py:head_plan), tile t at row tile t / (N /
//     BN), column tile t % (N / BN), so the blocks in flight share their row
//     tiles in L2. Two consumer warpgroups own 64 rows each (BN / 2 f32
//     accumulators a thread, 96 at vec3); the producer warpgroup fills a
//     ring of 64-deep stages, and setmaxnreg moves registers from it (40) to
//     the consumers (232). The product reads more from L2 than the card's L2
//     delivers at the tensor cores' rate: each row once per column tile and
//     the operator once per row tile, 1.34 GB a vec3 batch and 268 MB a
//     flagship one, so it runs at about 6-7 TB/s of L2 reads, not at its
//     MMA bound.
//   * A stage's rows come by cp.async, 16 bytes a copy, 8 a producer thread,
//     each thread's copies completing on the stage's full mbarrier
//     (cp.async.mbarrier.arrive.noinc); the stage's operator tile is one
//     contiguous cp.async.bulk. (One cp.async.bulk a 128-byte row, 132
//     copies a stage from one warp, cost about 60 cycles of issue each: 0.29
//     ms at the flagship's shape.) A stage is free again once each consumer
//     warp has arrived on its empty mbarrier. (Clusters of two CTAs sharing
//     each operator stage by multicast read 30% less from L2 but ran at
//     0.094 / 0.36 ms against 0.060 / 0.22.)
//   * A comes from registers, with the gate applied as it is loaded: a
//     thread reads 16 bytes of each of its two rows per 32-deep chunk (8
//     channels of one position), multiplies them by its 8 gates in bf16
//     (`__hmul2`, one rounding), and hands the words to wgmma. A thread keeps
//     its rows' gates for its 8 channels of every 32 in registers for the
//     whole tile (C / 4 registers). Within a chunk the depth order is
//     permuted so that these reads are contiguous; the prepared operand
//     carries the same permutation (ops/decoder_head.py:operator_tiles,
//     the score kernel's convention). The MMAs of chunk d run while chunk
//     d + 1 is read and gated into the other set of fragment registers.
//   * Rows of even index in a stage lie in one half of it and odd ones in
//     the other, 64 bytes further along the banks: the eight lanes of a
//     quarter warp read two rows, 64 bytes each, on disjoint banks.
//   * The operator is prepared once a model in the no-swizzle K-major core
//     matrix layout that wgmma reads (per column tile, per stage, per k16
//     step, per group of 8 columns, the two 8-deep halves of 8 x 8 bf16; LBO
//     128 B, SBO 256 B), so a stage of a column tile is one contiguous run
//     of 4 x BN x 32 bytes. For vec3 it is 25 MB and stays in L2.
//   * Every output element is summed in one thread's accumulator, stage by
//     stage in depth order, whatever the number of rows or the row's place
//     in its tile: a leaf gets the same bits in a batch of any size. Rows
//     past n in the last row tile are not copied (their MMAs compute on
//     stale shared memory and are not stored).
//   * Epilogue: the bias, then sigmoid (1 / (1 + expf(-x))) or tanhf in f32
//     as torch does, stored as float2 pairs straight from the accumulators.
//
// The f32 form (an f32 codec's step: its features, gate and fold in f32,
// as the plain graph's f32 products, TF32 off):
//   * The same gate kernel on f32 rows, writing f32 gates.
//   * head_kernel_f32: a tiled f32 product on the CUDA cores, 128 x 128
//     tiles of 256 threads, 8 x 8 outputs a thread, 8-deep steps through a
//     double-buffered shared tile. A row's values are gated in f32 as they
//     are loaded (one rounding, the plain `x * y`). Each output is one
//     thread's fmaf chain in depth order: a leaf's bits do not depend on the
//     batch. The epilogue is the bf16 form's.
//   Bound on the H100 at n = 4,096: the same operations at the CUDA cores'
//   67 TFLOP/s, 1.54 ms (vec3) and 0.26 ms (flagship). It ran at 4.28 and
//   0.79 ms on an H100 SXM (700 W), a third of that bound and about twice
//   cuBLAS's f32 product alone (2.05 / 0.36 ms): at vec3 its 384 tiles fill
//   1.45 waves of two blocks an SM, at the flagship 128 tiles leave one
//   block an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPositions = 64;  // latent positions of a leaf (4^3)
constexpr int kTileRows = 64;   // rows of one warpgroup's accumulator tile
constexpr int kConsumers = 2;   // consumer warpgroups per block
constexpr int kThreads = (kConsumers + 1) * 128;  // and a producer warpgroup
constexpr int kRows = kConsumers * kTileRows;     // rows of a block's tile
constexpr int kStageDepth = 64;                   // depth of a stage: four k16 steps
constexpr uint32_t kRowBytes = kStageDepth * 2;   // a row's bytes in a stage
// Odd rows of a stage start 64 bytes past a multiple of 128 (bank offset).
constexpr uint32_t kOddOffset = (kRows / 2) * kRowBytes + 64;
constexpr uint32_t kAStageBytes = 16512;  // both halves, rounded up to 128 bytes
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;
constexpr int kGateThreads = 256;
constexpr int kMaxDevices = 64;

static_assert(kOddOffset + (kRows / 2) * kRowBytes <= kAStageBytes, "A stage too small");

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Contiguous bytes global -> shared, completing on an mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared, by this thread (cp.async, bypassing L1).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

// One arrival on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving uses of the accumulators across the
// asynchronous MMAs' start and wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// B descriptor: no swizzle, K-major; LBO (between the two 8-deep halves of
// a k16 step) 128 B, SBO (between groups of 8 columns) 256 B.
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

#define HD_REGS_0 "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
#define HD_REGS_1 "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
#define HD_REGS_2 "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
#define HD_ACC8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HD_ACC32(d, i) \
  HD_ACC8(d, i), HD_ACC8(d, i + 8), HD_ACC8(d, i + 16), HD_ACC8(d, i + 24)
// D (+)= A * B: A m64k16 bf16 from registers, B k16nN bf16 from shared
// memory, D m64nN f32. `A0` is the number of the first operand after D.
#define HD_WGMMA(N, REGS, A0, A1, A2, A3, DESC, SCALE, ...)                  \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %" SCALE ", 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n" N "k16.f32.bf16.bf16 "             \
      "{" REGS "}, {%" A0 ",%" A1 ",%" A2 ",%" A3 "}, %" DESC ", p, 1, 1, 0;\n" \
      "}\n"                                                                  \
      : __VA_ARGS__                                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d))

// NB = BN / 64 blocks of 64 columns; the accumulator has 32 * NB registers.
template <int NB>
struct Mma;
template <>
struct Mma<2> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    HD_WGMMA("128", HD_REGS_0 "," HD_REGS_1, "64", "65", "66", "67", "68", "69",
             HD_ACC32(d, 0), HD_ACC32(d, 32));
  }
};
template <>
struct Mma<3> {
  static __device__ __forceinline__ void run(float (&d)[96], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    HD_WGMMA("192", HD_REGS_0 "," HD_REGS_1 "," HD_REGS_2, "96", "97", "98", "99",
             "100", "101", HD_ACC32(d, 0), HD_ACC32(d, 32), HD_ACC32(d, 64));
  }
};

// ---------------------------------------------------------------------------
// The gate
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// 8 consecutive channels of one position, as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  v[0] = bf16_lo(q.x), v[1] = bf16_hi(q.x), v[2] = bf16_lo(q.y), v[3] = bf16_hi(q.y);
  v[4] = bf16_lo(q.z), v[5] = bf16_hi(q.z), v[6] = bf16_lo(q.w), v[7] = bf16_hi(q.w);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store_gate(__nv_bfloat16* p, float g) {
  *p = __float2bfloat16_rn(g);
}
__device__ __forceinline__ void store_gate(float* p, float g) { *p = g; }

// h [n, 64, c] T, w1 [c, hid] f32, w2 [hid, c] f32 -> gate [n, c] T (T bf16
// or f32; the gate is rounded to T once). blockDim.x = l * c: l leaves a
// block, a team of c threads a leaf.
template <typename T>
__global__ void __launch_bounds__(kGateThreads)
    gate_kernel(const T* __restrict__ h, const float* __restrict__ w1,
                const float* __restrict__ w2, T* __restrict__ gate, int n, int c, int hid) {
  __shared__ float part[8 * kGateThreads];  // [team][position group][channel]
  __shared__ float mean[kGateThreads];      // [team][channel]
  __shared__ float hidden[kGateThreads];    // [team][hidden unit]
  const int l = blockDim.x / c;
  const int team = threadIdx.x / c, i = threadIdx.x - team * c;
  const long long leaf = static_cast<long long>(blockIdx.x) * l + team;
  const bool live = leaf < n;
  const int vc = c / 8;  // 16-byte vectors of a position
  const int v = i % vc, pg = i / vc;  // channels 8v..8v+7 at positions pg, pg + 8, ...
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    const T* x = h + leaf * kPositions * c + 8 * v;
#pragma unroll
    for (int k = 0; k < kPositions / 8; ++k) {
      float q[8];
      load8(x + (pg + 8 * k) * c, q);
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] += q[e];
    }
  }
  float* mine = part + (team * 8 + pg) * c + 8 * v;
#pragma unroll
  for (int e = 0; e < 8; ++e) mine[e] = s[e];
  __syncthreads();
  float sum = 0.f;
#pragma unroll
  for (int g = 0; g < 8; ++g) sum += part[(team * 8 + g) * c + i];
  mean[team * c + i] = sum * (1.0f / kPositions);
  __syncthreads();
  // fc1: thread i sums the r = c / hid channels' quarter q = i / hid of hidden
  // unit j = i % hid (channels q * c / r ..), the r partials in order after.
  const int r = c / hid, j = i % hid, q = i / hid, span = c / r;
  float a1 = 0.f;
  for (int k = q * span; k < (q + 1) * span; ++k)
    a1 = fmaf(mean[team * c + k], w1[k * hid + j], a1);
  part[team * c + i] = a1;
  __syncthreads();
  if (i < hid) {
    float a = 0.f;
    for (int p = 0; p < r; ++p) a += part[team * c + p * hid + i];
    hidden[team * c + i] = a < 0.f ? 0.f : a;  // relu, keeping a NaN
  }
  __syncthreads();
  float a = 0.f;
  for (int j = 0; j < hid; ++j) a = fmaf(hidden[team * c + j], w2[j * c + i], a);
  if (live) store_gate(gate + leaf * c + i, 1.0f / (1.0f + expf(-a)));
}

// ---------------------------------------------------------------------------
// The product
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t x, uint32_t g) {
  const __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                                   *reinterpret_cast<const __nv_bfloat162*>(&g));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// This thread's 8 values of rows g and g + 8 (w[0], w[1]) at depths
// 32 d + 8 t .. + 7 of a stage, times their channels' gates, in bf16.
__device__ __forceinline__ void load_gated(uint32_t (&w)[2][4], const uint8_t* rows,
                                           const uint32_t (&g0)[4], const uint32_t (&g1)[4]) {
  const uint4 x0 = *reinterpret_cast<const uint4*>(rows);
  const uint4 x1 = *reinterpret_cast<const uint4*>(rows + 4 * kRowBytes);
  w[0][0] = mul_bf16x2(x0.x, g0[0]), w[0][1] = mul_bf16x2(x0.y, g0[1]);
  w[0][2] = mul_bf16x2(x0.z, g0[2]), w[0][3] = mul_bf16x2(x0.w, g0[3]);
  w[1][0] = mul_bf16x2(x1.x, g1[0]), w[1][1] = mul_bf16x2(x1.y, g1[1]);
  w[1][2] = mul_bf16x2(x1.z, g1[2]), w[1][3] = mul_bf16x2(x1.w, g1[3]);
}

// Starts the MMAs of one 32-deep chunk: two k16 steps. A thread holds, of
// rows g and g + 8, 8 values; step u takes values 4u .. 4u + 3: the first
// pair as MMA depths 2t, 2t + 1, the second as 2t + 8, 2t + 9. `b` is the
// shared address of the chunk's first k16 step of the operator tile.
template <int NB>
__device__ __forceinline__ void mma_chunk(float (&acc)[32 * NB], const uint32_t (&w)[2][4],
                                          uint32_t b, bool first) {
  constexpr uint32_t kStepBytes = 64 * NB * 32;
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const uint32_t a[4] = {w[0][2 * u], w[1][2 * u], w[0][2 * u + 1], w[1][2 * u + 1]};
    Mma<NB>::run(acc, a, b_descriptor(b + u * kStepBytes), !(first && u == 0));
  }
  wgmma_commit();
}

__device__ __forceinline__ float activate(float x, int act) {
  return act == 0 ? 1.0f / (1.0f + expf(-x)) : tanhf(x);
}

// Shared memory: a ring of `stages` stages, each [A: even rows | odd rows,
// 128 x 64 bf16][B: four k16 steps of the operator's column tile, BN x 32
// bytes each], then the mbarriers full[kMaxStages], empty[kMaxStages].
template <int NB, int G>
__global__ void __launch_bounds__(kThreads, 1)
    head_kernel(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ gate,
                const __nv_bfloat16* __restrict__ op, const float* __restrict__ bias,
                float* __restrict__ out, int n, int n_out, int stages, int act) {
  constexpr int BN = 64 * NB;
  constexpr int C = 32 * G;
  constexpr int K = kPositions * C;  // a row's depth
  constexpr int kSteps = K / kStageDepth;  // stages a tile (= C)
  constexpr uint32_t kStepBytes = BN * 32;
  constexpr uint32_t kBStageBytes = 4 * kStepBytes;
  constexpr uint32_t kStageBytes = kAStageBytes + kBStageBytes;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + stages * kStageBytes;
  const uint32_t empty = full + 8 * kMaxStages;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1 + 128);  // the operator's expect_tx, the producers' rows
      mbar_init(empty + 8 * i, kConsumers * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int col_tiles = n_out / BN;
  const int tiles = (n + kRows - 1) / kRows * col_tiles;
  // The shuffle tells the compiler that the role is uniform over the warp.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == kConsumers) {
    // ---- producer warpgroup: thread 0 the operator tile, every thread rows ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int p = threadIdx.x - kConsumers * 128;
    const uint8_t* b_tiles = reinterpret_cast<const uint8_t*>(op);
    int stage = 0, parity = 1;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int rt = tile / col_tiles, ct = tile - rt * col_tiles;
      const long long row0 = static_cast<long long>(rt) * kRows;
      const int rows = n - row0 < kRows ? static_cast<int>(n - row0) : kRows;
      const __nv_bfloat16* a_src = h + row0 * K;
      const uint8_t* b_src = b_tiles + static_cast<size_t>(ct) * kSteps * kBStageBytes;
      for (int s = 0; s < kSteps; ++s) {
        mbar_wait(empty + 8 * stage, parity);
        const uint32_t dst = base + stage * kStageBytes;
        const uint32_t bar = full + 8 * stage;
        if (p == 0) {
          mbar_expect_tx(bar, kBStageBytes);
          bulk_load(dst + kAStageBytes, b_src + static_cast<size_t>(s) * kBStageBytes,
                    kBStageBytes, bar);
        }
        // 16-byte piece j of row r: thread p takes pieces p, p + 128, ...
#pragma unroll
        for (int i = 0; i < kRows * 8 / 128; ++i) {
          const int piece = p + 128 * i, r = piece >> 3, j = piece & 7;
          if (r < rows)
            cp_async16(dst + (r & 1) * kOddOffset + (r >> 1) * kRowBytes + 16 * j,
                       a_src + static_cast<long long>(r) * K + s * kStageDepth + 8 * j);
        }
        cp_async_arrive(bar);
        if (++stage == stages) stage = 0, parity ^= 1;
      }
    }
  } else {
    // ---- consumers: gated fragments, MMAs, the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x & 127) >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int row_in_tile = wg * kTileRows + 16 * warp + g;  // and row_in_tile + 8
    // Rows g and g + 8 have g's parity; +8 rows is +4 rows of a half.
    const uint32_t a_off = (g & 1) * kOddOffset + (row_in_tile >> 1) * kRowBytes + 16 * t;
    float acc[32 * NB] = {};
    uint32_t gw[2][G][4];  // gates of rows g, g + 8: channels 32 j + 8 t .. + 7
    uint32_t w[2][2][4];   // gated fragments of the chunk in flight and the next
    int stage = 0, parity = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int rt = tile / col_tiles, ct = tile - rt * col_tiles;
      const long long row0 = static_cast<long long>(rt) * kRows;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = row0 + row_in_tile + 8 * r;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          uint4 q = make_uint4(0u, 0u, 0u, 0u);
          if (row < n) q = *reinterpret_cast<const uint4*>(gate + row * C + 32 * j + 8 * t);
          gw[r][j][0] = q.x, gw[r][j][1] = q.y, gw[r][j][2] = q.z, gw[r][j][3] = q.w;
        }
      }
      mbar_wait(full + 8 * stage, parity);
      load_gated(w[0], smem + stage * kStageBytes + a_off, gw[0][0], gw[1][0]);
      fence_regs(acc);
      int prev = stage;
      for (int s0 = 0; s0 < kSteps; s0 += G) {
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const int s = s0 + i;
          const uint32_t b = base + stage * kStageBytes + kAStageBytes;
          const uint8_t* rows = smem + stage * kStageBytes + a_off;
          // chunk d = 0 (channels 32 * ((2 i) % G) ..), fragments in w[0]
          mma_chunk<NB>(acc, w[0], b, s == 0);
          if (s > 0) {
            wgmma_wait_one();  // the previous stage's last chunk is done
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * prev);
          }
          load_gated(w[1], rows + 64, gw[0][(2 * i + 1) % G], gw[1][(2 * i + 1) % G]);
          // chunk d = 1
          mma_chunk<NB>(acc, w[1], b + 2 * kStepBytes, false);
          wgmma_wait_one();  // chunk d = 0 is done: w[0] is free
          prev = stage;
          if (++stage == stages) stage = 0, parity ^= 1;
          if (s + 1 < kSteps) {
            mbar_wait(full + 8 * stage, parity);
            load_gated(w[0], smem + stage * kStageBytes + a_off, gw[0][(2 * i + 2) % G],
                       gw[1][(2 * i + 2) % G]);
          }
        }
      }
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * prev);

      // acc[4j + 2r + v] is row g + 8r (of this warp's 16), column 8j + 2t + v.
      const int col0 = ct * BN + 2 * t;
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(bias + col0 + 8 * j);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = row0 + row_in_tile + 8 * r;
          if (row < n) {
            float2 o;
            o.x = activate(acc[4 * j + 2 * r] + bb.x, act);
            o.y = activate(acc[4 * j + 2 * r + 1] + bb.y, act);
            *reinterpret_cast<float2*>(out + row * n_out + col0 + 8 * j) = o;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The product in f32
// ---------------------------------------------------------------------------

constexpr int kF32Tile = 128;  // rows and columns of a block's tile
constexpr int kF32Step = 8;    // depth of one step
constexpr int kF32Threads = 256;

// h [n, 64 c] f32, gate [n, c] f32, k [64 c, n_out] f32 (the fold as it
// is), bias [n_out] -> out [n, n_out] f32. Grid (n_out / 128, row tiles):
// the blocks in flight share their row tiles in L2.
__global__ void __launch_bounds__(kF32Threads)
    head_kernel_f32(const float* __restrict__ h, const float* __restrict__ gate,
                    const float* __restrict__ k, const float* __restrict__ bias,
                    float* __restrict__ out, int n, int c, int n_out, int act) {
  __shared__ __align__(16) float as[2][kF32Step][kF32Tile];  // [depth][row], gated
  __shared__ __align__(16) float bs[2][kF32Step][kF32Tile];  // [depth][column]
  const int depth = kPositions * c;
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.y) * kF32Tile;
  const int col0 = blockIdx.x * kF32Tile;
  // Loads of a step: row ar at depths ak .. ak + 3, gated by channels
  // (depth mod c) ak .. (8 | c, so a step's 8 depths are 8 channels of one
  // position); the operator at depth bk, columns bc .. bc + 3.
  const int ar = tid >> 1, ak = 4 * (tid & 1);
  const bool a_live = row0 + ar < n;
  const float* a_src = h + (a_live ? row0 + ar : 0) * depth + ak;
  const float* g_src = gate + (a_live ? row0 + ar : 0) * c + ak;
  const int bk = tid >> 5, bc = 4 * (tid & 31);
  const float* b_src = k + static_cast<long long>(bk) * n_out + col0 + bc;
  // This thread's outputs: rows 4 ty + i and 64 + 4 ty + i, columns 4 tx + j
  // and 64 + 4 tx + j (i, j < 4).
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8] = {};
  float4 ra = make_float4(0.f, 0.f, 0.f, 0.f), rb;
  const int steps = depth / kF32Step;
#pragma unroll 1
  for (int s = 0; s <= steps; ++s) {
    if (s < steps) {  // step s into registers
      const int d0 = s * kF32Step;
      if (a_live) {
        const float4 x = *reinterpret_cast<const float4*>(a_src + d0);
        const float4 g = *reinterpret_cast<const float4*>(g_src + d0 % c);
        ra = make_float4(x.x * g.x, x.y * g.y, x.z * g.z, x.w * g.w);
      }
      rb = *reinterpret_cast<const float4*>(b_src + static_cast<long long>(d0) * n_out);
    }
    if (s > 0) {  // step s - 1 from shared memory
      const int buf = (s - 1) & 1;
#pragma unroll
      for (int kk = 0; kk < kF32Step; ++kk) {
        float a[8], b[8];
        *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(&as[buf][kk][4 * ty]);
        *reinterpret_cast<float4*>(a + 4) =
            *reinterpret_cast<const float4*>(&as[buf][kk][64 + 4 * ty]);
        *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(&bs[buf][kk][4 * tx]);
        *reinterpret_cast<float4*>(b + 4) =
            *reinterpret_cast<const float4*>(&bs[buf][kk][64 + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (s < steps) {  // step s into the other buffer (its last reader passed the barrier)
      const int buf = s & 1;
      as[buf][ak][ar] = ra.x, as[buf][ak + 1][ar] = ra.y;
      as[buf][ak + 2][ar] = ra.z, as[buf][ak + 3][ar] = ra.w;
      *reinterpret_cast<float4*>(&bs[buf][bk][bc]) = rb;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= n) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = col0 + 64 * half + 4 * tx;
      const float4 bb = *reinterpret_cast<const float4*>(bias + col);
      const float* v = acc[i] + 4 * half;
      *reinterpret_cast<float4*>(out + row * n_out + col) =
          make_float4(activate(v[0] + bb.x, act), activate(v[1] + bb.y, act),
                      activate(v[2] + bb.z, act), activate(v[3] + bb.w, act));
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The card's SM count, read once a device.
int sm_count(int device) {
  static int counts[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return 0;
  if (counts[device] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return 0;
    counts[device] = sms;
  }
  return counts[device];
}

template <int NB, int G>
int launch_product(const void* h, const void* gate, const void* op, const void* bias,
                   void* out, int n, int n_out, int act, int device, cudaStream_t stream) {
  constexpr int kStageBytes = kAStageBytes + 4 * 64 * NB * 32;
  constexpr int kBarrierBytes = 16 * kMaxStages;
  constexpr int kStages = (kSmemLimit - kBarrierBytes) / kStageBytes < kMaxStages
                              ? (kSmemLimit - kBarrierBytes) / kStageBytes
                              : kMaxStages;
  constexpr int kSmem = kStages * kStageBytes + kBarrierBytes;
  static_assert(kStages >= 3, "too few stages fit");
  static bool ready[kMaxDevices] = {};
  auto kernel = head_kernel<NB, G>;
  if (!ready[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  const int sms = sm_count(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int tiles = (n + kRows - 1) / kRows * (n_out / (64 * NB));
  kernel<<<tiles < sms ? tiles : sms, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(gate),
      static_cast<const __nv_bfloat16*>(op), static_cast<const float*>(bias),
      static_cast<float*>(out), n, n_out, kStages, act);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_nb(int c, const void* h, const void* gate, const void* op, const void* bias,
              void* out, int n, int n_out, int act, int device, cudaStream_t stream) {
  return c == 64 ? launch_product<NB, 2>(h, gate, op, bias, out, n, n_out, act, device, stream)
                 : launch_product<NB, 4>(h, gate, op, bias, out, n, n_out, act, device, stream);
}

// The arguments both forms take: c 64 or 128, H dividing c, n_out a
// multiple of 128, act 0 or 1; h and gate 16-byte aligned, bias and out 8.
bool bad_arguments(const void* h, const void* gate, const void* bias, const void* out, int n,
                   int c, int hid, int n_out, int act) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(gate);
  const uintptr_t align8 = reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(out);
  return n <= 0 || (c != 64 && c != 128) || hid < 1 || c % hid != 0 || n_out <= 0 ||
         n_out % 128 != 0 || (act != 0 && act != 1) || align % 16 != 0 || align8 % 8 != 0;
}

template <typename T>
int launch_gate(const void* h, const void* w1, const void* w2, void* gate, int n, int c,
                int hid, cudaStream_t stream) {
  const int l = kGateThreads / c;
  gate_kernel<T><<<(n + l - 1) / l, l * c, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<T*>(gate), n, c, hid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h [n, 64, c] bf16 (c 64 or 128), w1 [c, hid] f32, w2 [hid, c] f32 (hid
// dividing c), gate [n, c] bf16 scratch, op the operator prepared by
// ops/decoder_head.py:operator_tiles (64 c x n_out), bias [n_out] f32 ->
// out [n, n_out] f32; bn (128 or 192) divides n_out; act 0 sigmoid, 1 tanh.
// Two launches on `stream`: the gate, then the product.
extern "C" int vq_decoder_head(const void* h, const void* w1, const void* w2, void* gate,
                               const void* op, const void* bias, void* out, int n, int c,
                               int hid, int n_out, int bn, int act, void* stream) {
  if (bad_arguments(h, gate, bias, out, n, c, hid, n_out, act) || (bn != 128 && bn != 192) ||
      n_out % bn != 0 || reinterpret_cast<uintptr_t>(op) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int status = launch_gate<__nv_bfloat16>(h, w1, w2, gate, n, c, hid, s);
  if (status != 0) return status;
  return bn == 192 ? launch_nb<3>(c, h, gate, op, bias, out, n, n_out, act, device, s)
                   : launch_nb<2>(c, h, gate, op, bias, out, n, n_out, act, device, s);
}

// The f32 form: h [n, 64, c] f32, gate [n, c] f32 scratch, k [64 c, n_out]
// f32 (the fold, dense), the rest as vq_decoder_head; k, bias and out
// 16-byte aligned. Two launches on
// `stream`: the gate, then the product.
extern "C" int vq_decoder_head_f32(const void* h, const void* w1, const void* w2, void* gate,
                                   const void* k, const void* bias, void* out, int n, int c,
                                   int hid, int n_out, int act, void* stream) {
  const int row_tiles = (n + kF32Tile - 1) / kF32Tile;
  const uintptr_t align = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(bias) |
                          reinterpret_cast<uintptr_t>(out);
  if (bad_arguments(h, gate, bias, out, n, c, hid, n_out, act) || align % 16 != 0 ||
      row_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int status = launch_gate<float>(h, w1, w2, gate, n, c, hid, s);
  if (status != 0) return status;
  head_kernel_f32<<<dim3(n_out / kF32Tile, row_tiles), kF32Threads, 0, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(gate),
      static_cast<const float*>(k), static_cast<const float*>(bias), static_cast<float*>(out),
      n, c, n_out, act);
  return static_cast<int>(cudaGetLastError());
}
