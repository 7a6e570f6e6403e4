// Score GEMM on the tensor cores with a first-minimum argmin epilogue:
//     out[n] = argmin_k ( sum_f h[n, f] * M[f, k] + c[k] )
// with f32-grade products, f32 sums, ties to the smallest k and a NaN score
// winning over any number (the first NaN among NaNs), as jnp.argmin and
// torch.argmin do. The [N, K] scores never reach device memory; the output
// is int32 [N].
//
// Replaces two TPU kernels, each with its own entry point:
//   * vqvdb_tpu/ops/quantize.py:fused_score_argmin (_score_argmin_kernel):
//     the encoder's 1x1 projection folded into the quantizer score,
//     h = encoder features [N, F] (bf16 or f32), M [F, K], c [K].
//   * vqvdb_tpu/ops/quantize.py:fused_nearest_indices (_nearest_kernel):
//     the nearest code to latents z [N, D] f32: the same body with
//     M = -2 E^T [D, K] and c = ||e||^2 (||z||^2 cannot move the argmin).
//
// f32-grade products from bf16 tensor-core MMAs. An f32 value is the exact
// sum of three bf16 terms, hi + mid + lo (3 x 8 mantissa bits); a bf16 x bf16
// product is exact in f32 and the MMA sums in f32. M is split once on the
// host side (ops/quantize.py:prepare_scores). A bf16 row is one term, so its
// score is 3 products, h*M_lo + h*M_mid + h*M_hi. An f32 row is split in
// registers after the load and keeps the 6 products of order <= 2:
// lo*hi, mid*mid, hi*lo, mid*hi, hi*mid, hi*hi. Within a depth chunk the small
// products are started first, and every code column sees the same sequence of
// MMAs, so two identical codes get bit-equal scores and the tie goes to the
// smaller index. Where a row value's hi term is not finite its mid and lo
// are zero, and only the hi*hi product sees it: an infinite value gives
// +-inf scores (never inf * 0 from a zero mid or lo term of M), a NaN gives
// NaN for every code, hence index 0.
//
// Bound on the H100 at the codec's batch (N = 262,144 rows, K = 256), bf16
// MMAs at 989 TFLOP/s, device memory at 3.35 TB/s:
//   bf16 rows, 3 products: F = 64: 3 * 8.6 GFLOP -> 26 us (rows read: 10 us);
//                          F = 32: 13 us; F = 128: 52 us. By operations.
//   f32 rows, 6 products:  D = 128: 6 * 17.2 GFLOP -> 104 us (rows read:
//                          40 us); F = 64: 52 us. By operations.
// (On the CUDA cores in f32, as the first version of this kernel ran: 128 us
// at F = 64, 256 us at 128.)
//
// Design, and what each part answers in the first version:
//   * MMAs are wgmma.mma_async m64nKk16 (bf16, f32 accumulate), not
//     mma.sync: B is read from shared memory by the tensor cores once per
//     64 rows, where mma.sync would pull all of B through every warp's
//     registers for 16 rows. The first version ran f32 FMAs on the CUDA
//     cores and could not pass 67 TFLOP/s.
//   * One persistent block per SM: two consumer warpgroups, each owning
//     64 rows x K codes of accumulators (K/2 registers a thread), and a
//     producer warpgroup. setmaxnreg moves registers from the producer (40)
//     to the consumers (232): with 168, the even share of 384 threads, ptxas
//     serialises the MMAs of K = 256 for want of registers. When M is
//     resident the two consumers take turns on the tensor cores (named
//     barriers), so that one's argmin runs under the other's MMAs.
//   * Two producer threads keep tiles in flight with cp.async.bulk
//     completing on mbarriers: a [64, F] row tile is one contiguous run of
//     bytes of [N, F], so no tensor map is involved. Up to four row stages
//     per warpgroup; the first version loaded, barriered, computed,
//     barriered. Within a tile the MMAs of chunk d run while chunk d + 1 is
//     read and split into a second set of fragment registers.
//   * A comes from registers: a thread reads 16 bytes (bf16) or 32 bytes
//     (f32) of its two rows per 32-deep chunk straight from the row-major
//     tile, splits f32 values, and hands the fragments to wgmma. No
//     transposed staging buffer (the first version's 8-way bank conflict).
//     The depth order inside a chunk is permuted so that these reads are
//     contiguous; the prepared B operand carries the same permutation.
//   * B (the three terms of M) is prepared once per model in the exact byte
//     order of shared memory: per 32-deep chunk, per term, per k16 step, the
//     no-swizzle K-major core matrices (8 codes x 8 depths, 128 contiguous
//     bytes; LBO 128 B between the two depth halves, SBO 256 B between code
//     groups). It takes 6*F*K bytes: resident in shared memory when that and
//     the row stages fit in 227 KB (F <= 64 at K = 256); otherwise its
//     chunks stream from L2 through a ring that both warpgroups consume
//     (F = 128: 192 KB per 128 rows, hidden under the MMAs of the chunk
//     before). The first version held M as f32, 128 KB at F = 128.
//   * The argmin is taken in the accumulator registers: a row's K scores lie
//     in the four lanes of a quad. Add c, take the minimum (min.NaN keeps a
//     NaN) over the thread's codes and the quad (two xor-shuffles), then the
//     smallest code whose score equals it (or is NaN, when it is NaN). The
//     first version shuffled (value, index) pairs over 16 lanes. Compares,
//     min and select run at half the FMA rate, and this epilogue (four
//     instructions a score) does not hide under the other warpgroup's MMAs
//     as well as hoped: at F <= 64 kernel time is close to MMA time plus
//     epilogue time (tools/score_phases.py measures the two apart).
//   * Any K from 1 to 65,536. The accumulators of 64 rows x 256 codes take
//     128 of a consumer's 232 registers, so the codes run in tiles of kt <=
//     256, one launch per tile in code order. Every tile of a call has the
//     same width, so identical codes in different tiles see the same MMAs
//     and get bit-equal scores. A launch adds its tile's first code and
//     merges its (minimum, code) per row into a running pair in device
//     memory by the same rules as inside a tile; a partial last tile sets
//     the scores of its pad codes to +inf before the minimum. Rows are read
//     once per tile: a loop over tiles inside the kernel, row tile kept
//     resident, would read them once.
//   * Rows of any depth. Two full-depth row stages and two B chunks fit in
//     shared memory up to f32 rows of depth 128 and bf16 rows of depth 256
//     at K = 256. Deeper rows take the streamed-depth mode (kStream, an
//     instantiation of its own so that the other modes run none of its
//     code): the rows come 32 deep through the B ring, one stage holding
//     one B chunk and the 128 rows x 32 depths of both consumer warpgroups
//     (one bulk copy per row, issued by the 32 lanes of the B warp). The
//     accumulators stay in registers across the chunks and the argmin runs
//     after the last one, so products and sums keep the order of the other
//     modes (ops/quantize.py:split_scores). Every chunk's rows and M pass
//     through shared memory once per 128 rows, as M does in the ring mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 64;   // rows of one warpgroup's accumulator tile
constexpr int kConsumers = 2;   // consumer warpgroups per block
constexpr int kThreads = (kConsumers + 1) * 128;  // and a producer warpgroup
constexpr int kChunk = 32;      // depth of one chunk of B: two k16 steps
constexpr int kMaxAStages = 4;  // row-tile stages per consumer warpgroup: 2 to 4
constexpr int kMaxBStages = 4;  // ring of B chunks when M is streamed
constexpr int kSmemLimit = 232448;
constexpr int kBarriers = 2 * kConsumers * kMaxAStages + 2 * kMaxBStages;

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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
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

__device__ __forceinline__ float fmin_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// B descriptor: no swizzle, K-major; LBO (between the two 8-deep halves of
// a k16 step) 128 B, SBO (between groups of 8 codes) 256 B.
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

#define VQ_REGS_0 "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
#define VQ_REGS_1 "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
#define VQ_REGS_2 "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
#define VQ_REGS_3 "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
#define VQ_ACC8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VQ_ACC32(d, i) \
  VQ_ACC8(d, i), VQ_ACC8(d, i + 8), VQ_ACC8(d, i + 16), VQ_ACC8(d, i + 24)
// D (+)= A * B: A m64k16 bf16 from registers, B k16nN bf16 from shared
// memory, D m64nN f32. `A0` is the number of the first operand after D.
#define VQ_WGMMA(N, REGS, A0, A1, A2, A3, DESC, SCALE, ...)                  \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %" SCALE ", 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n" N "k16.f32.bf16.bf16 "             \
      "{" REGS "}, {%" A0 ",%" A1 ",%" A2 ",%" A3 "}, %" DESC ", p, 1, 1, 0;\n" \
      "}\n"                                                                  \
      : __VA_ARGS__                                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d))

// NB = K / 64 blocks of 64 codes; the accumulator has 32 * NB registers.
template <int NB>
struct Mma;
template <>
struct Mma<1> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    VQ_WGMMA("64", VQ_REGS_0, "32", "33", "34", "35", "36", "37", VQ_ACC32(d, 0));
  }
};
template <>
struct Mma<2> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    VQ_WGMMA("128", VQ_REGS_0 "," VQ_REGS_1, "64", "65", "66", "67", "68", "69",
             VQ_ACC32(d, 0), VQ_ACC32(d, 32));
  }
};
template <>
struct Mma<3> {
  static __device__ __forceinline__ void run(float (&d)[96], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    VQ_WGMMA("192", VQ_REGS_0 "," VQ_REGS_1 "," VQ_REGS_2, "96", "97", "98", "99",
             "100", "101", VQ_ACC32(d, 0), VQ_ACC32(d, 32), VQ_ACC32(d, 64));
  }
};
template <>
struct Mma<4> {
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    VQ_WGMMA("256", VQ_REGS_0 "," VQ_REGS_1 "," VQ_REGS_2 "," VQ_REGS_3, "128",
             "129", "130", "131", "132", "133", VQ_ACC32(d, 0), VQ_ACC32(d, 32),
             VQ_ACC32(d, 64), VQ_ACC32(d, 96));
  }
};

// ---------------------------------------------------------------------------
// A fragments
// ---------------------------------------------------------------------------
//
// A thread (quad lane t, row g of its warp's 16 rows) holds, of rows g and
// g + 8, the 8 values at depths 32 d + 8 t .. + 7 of chunk d. Step u of the
// chunk takes values 4u .. 4u + 3: the first pair as MMA depths 2t, 2t + 1,
// the second as 2t + 8, 2t + 9. Words are bf16 pairs, low half first;
// w[r][j] is pair j of row g + 8 r.

__device__ __forceinline__ void fragment(uint32_t (&a)[4], const uint32_t (&w)[2][4],
                                         int u) {
  a[0] = w[0][2 * u];
  a[1] = w[1][2 * u];
  a[2] = w[0][2 * u + 1];
  a[3] = w[1][2 * u + 1];
}

// Mask of the halves of a bf16 pair that are finite.
__device__ __forceinline__ uint32_t finite_mask(uint32_t w) {
  return ((w & 0x7F80u) != 0x7F80u ? 0xFFFFu : 0u) |
         ((w & 0x7F800000u) != 0x7F800000u ? 0xFFFF0000u : 0u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// One chunk of a thread's two rows, as the MMAs take it. `term[i]` follows
// the numbering of ops/quantize.py: 0 hi, 1 mid, 2 lo, 3 hi with its
// non-finite values zeroed. A bf16 row is its own hi term and has no others.
template <typename T>
struct Frag;

template <>
struct Frag<__nv_bfloat16> {
  static constexpr int kProducts = 3;
  uint32_t term[4][2][4];  // 1 and 2 stay unused

  __device__ __forceinline__ void load(const __nv_bfloat16* row_lo,
                                       const __nv_bfloat16* row_hi) {
    const uint4 v0 = *reinterpret_cast<const uint4*>(row_lo);
    const uint4 v1 = *reinterpret_cast<const uint4*>(row_hi);
    term[0][0][0] = v0.x, term[0][0][1] = v0.y, term[0][0][2] = v0.z, term[0][0][3] = v0.w;
    term[0][1][0] = v1.x, term[0][1][1] = v1.y, term[0][1][2] = v1.z, term[0][1][3] = v1.w;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        term[3][r][j] = term[0][r][j] & finite_mask(term[0][r][j]);
  }
  // (row term, M term) of product p, the small products first.
  static __device__ __forceinline__ constexpr int row_term(int p) { return p < 2 ? 3 : 0; }
  static __device__ __forceinline__ constexpr int m_term(int p) { return 2 - p; }
};

template <>
struct Frag<float> {
  static constexpr int kProducts = 6;
  uint32_t term[4][2][4];

  // x0, x1 -> pair j of row r of every term. x - hi and (x - hi) - mid are
  // exact in f32.
  __device__ __forceinline__ void split_pair(int r, int j, float x0, float x1) {
    const uint32_t hi = pack_bf16(x0, x1);
    const uint32_t fin = finite_mask(hi);
    const float r0 = (fin & 0xFFFFu) ? x0 - __uint_as_float(hi << 16) : 0.f;
    const float r1 = (fin >> 16) ? x1 - __uint_as_float(hi & 0xFFFF0000u) : 0.f;
    const uint32_t mid = pack_bf16(r0, r1);
    term[0][r][j] = hi;
    term[1][r][j] = mid;
    term[2][r][j] = pack_bf16(r0 - __uint_as_float(mid << 16),
                              r1 - __uint_as_float(mid & 0xFFFF0000u));
    term[3][r][j] = hi & fin;
  }
  __device__ __forceinline__ void load(const float* row_lo, const float* row_hi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float4* p = reinterpret_cast<const float4*>(r ? row_hi : row_lo);
      const float4 x = p[0], y = p[1];
      split_pair(r, 0, x.x, x.y);
      split_pair(r, 1, x.z, x.w);
      split_pair(r, 2, y.x, y.y);
      split_pair(r, 3, y.z, y.w);
    }
  }
  // lo*hi, mid*mid, hi*lo, mid*hi, hi*mid, hi*hi
  static __device__ __forceinline__ constexpr int row_term(int p) {
    return p == 0 ? 2 : p == 1 ? 1 : p == 2 ? 3 : p == 3 ? 1 : p == 4 ? 3 : 0;
  }
  static __device__ __forceinline__ constexpr int m_term(int p) {
    return p == 0 ? 0 : p == 1 ? 1 : p == 2 ? 2 : p == 3 ? 0 : p == 4 ? 1 : 0;
  }
};

// Starts the MMAs of one chunk. `b0` is the descriptor of the chunk's first
// k16 tile; tiles follow as [M term hi, mid, lo][step u].
template <typename T, int NB>
__device__ __forceinline__ void start_chunk(float (&acc)[32 * NB], const Frag<T>& f,
                                            uint64_t b0, bool first) {
  constexpr uint64_t kTile = (16 * 64 * NB * 2) >> 4;  // descriptor units
  wgmma_fence();
  uint32_t a[4];
#pragma unroll
  for (int p = 0; p < Frag<T>::kProducts; ++p) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      fragment(a, f.term[Frag<T>::row_term(p)], u);
      Mma<NB>::run(acc, a, b0 + (Frag<T>::m_term(p) * 2 + u) * kTile,
                   !(first && p == 0 && u == 0));
    }
  }
  wgmma_commit();
}

// Where a consumer finds chunk d of B: at its place when M is resident, else
// in the next stage of the ring, which it gives back when the chunk's MMAs
// are done.
struct BRing {
  uint32_t base, full, empty, chunk_bytes;
  int stages;
  bool resident;
  int take, parity, give;

  __device__ __forceinline__ uint32_t acquire(int d) {
    if (resident) return base + d * chunk_bytes;
    mbar_wait(full + 8 * take, parity);
    const uint32_t addr = base + take * chunk_bytes;
    if (++take == stages) take = 0, parity ^= 1;
    return addr;
  }
  __device__ __forceinline__ void give_back() {
    mbar_arrive(empty + 8 * give);
    if (++give == stages) give = 0;
  }
};

// Chunk d of a tile: start its MMAs from `cur`, then, while they run, wait
// for chunk d - 1 (which frees `nxt` and that chunk's ring stage) and load
// chunk d + 1 into `nxt`.
template <typename T, int NB>
__device__ __forceinline__ void chunk_step(float (&acc)[32 * NB], const Frag<T>& cur,
                                           Frag<T>& nxt, int d, int nch, BRing& ring,
                                           const T* row_lo, const T* row_hi) {
#ifndef VQ_SKIP_MMA
  start_chunk<T, NB>(acc, cur, b_descriptor(ring.acquire(d)), d == 0);
#else  // measurement only: tools/score_phases.py
  ring.acquire(d);
  wgmma_commit();
#endif
  if (d > 0) {
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    if (!ring.resident) ring.give_back();
  }
  if (d + 1 < nch) nxt.load(row_lo + (d + 1) * kChunk, row_hi + (d + 1) * kChunk);
}

// The streamed-depth mode's view of the ring: each stage holds a B chunk
// and, after it, the chunk's rows. `next` waits for the next stage and loads
// this thread's fragments of it; `cur` is that stage's shared address.
template <typename T>
struct StreamRing {
  BRing* ring;
  uint8_t* base;  // stage 0, generic address
  uint32_t row;   // this thread's rows within a stage, in bytes
  uint32_t cur;

  __device__ __forceinline__ void next(Frag<T>& f) {
    cur = ring->acquire(0);
    const T* p = reinterpret_cast<const T*>(base + (cur - ring->base) + row);
    f.load(p, p + 8 * kChunk);
  }
};

// Chunk d in the streamed-depth mode: start its MMAs from `cur`, then, while
// they run, wait for chunk d - 1 and give its stage back, and load chunk
// d + 1 from the next stage into `nxt`.
template <typename T, int NB>
__device__ __forceinline__ void stream_step(float (&acc)[32 * NB], const Frag<T>& cur,
                                            Frag<T>& nxt, int d, int nch, StreamRing<T>& sr) {
#ifndef VQ_SKIP_MMA
  start_chunk<T, NB>(acc, cur, b_descriptor(sr.cur), d == 0);
#else  // measurement only: tools/score_phases.py
  wgmma_commit();
#endif
  if (d > 0) {
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    sr.ring->give_back();
  }
  if (d + 1 < nch) sr.next(nxt);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------
//
// Shared memory: [B: all chunks of M when resident, else a ring of b_stages
// chunks (in the streamed-depth mode each followed by its rows)][row stages:
// warpgroup x stage x [64, fp], none when streamed][c][mbarriers].
// Barriers: full_a[wg][stage], empty_a[wg][stage], full_b[stage],
// empty_b[stage]. Named barriers 1 and 2 pass the tensor cores between the
// two consumer warpgroups when M is resident.

// kRagged: the tile holds fewer than K valid codes (the last tile of a K
// that is no multiple of the tile width), and its pad codes are masked.
// kMerge: one of several tiles, merged into the running (score, code) pair.
// kStream: the streamed-depth mode, in which a ring stage holds a B chunk
// and the chunk's rows of both warpgroups ([warpgroup][64 rows][32 depths]
// after the chunk), and there are no full-depth row stages (a_stages = 0).
// All three are instantiations of their own, so that a call of one full tile
// of shallow rows runs none of their code.
template <typename T, int NB, bool kRagged, bool kMerge, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
    score_argmin_kernel(const T* __restrict__ h, const __nv_bfloat16* __restrict__ b,
                        const float* __restrict__ c, int32_t* __restrict__ out,
                        float* __restrict__ best, int n, int fp, int resident, int a_stages,
                        int b_stages, int code0, int valid) {
  constexpr int K = 64 * NB;
  constexpr uint32_t kChunkBytes = 3 * 2 * 16 * K * 2;
  constexpr uint32_t kRingStage =
      kChunkBytes + (kStream ? kConsumers * kTileRows * kChunk * sizeof(T) : 0);
  extern __shared__ __align__(128) uint8_t smem[];
  const int nch = fp / kChunk;
  const uint32_t a_stage_bytes = kTileRows * fp * sizeof(T);
  uint8_t* b_s = smem;
  uint8_t* a_s = b_s + static_cast<size_t>(resident ? nch : b_stages) * kRingStage;
  float* c_s = reinterpret_cast<float*>(a_s + kConsumers * a_stages * a_stage_bytes);
  const uint32_t bars = smem_u32(c_s + K);
  const uint32_t full_a = bars, empty_a = bars + 8 * kConsumers * kMaxAStages;
  const uint32_t full_b = empty_a + 8 * kConsumers * kMaxAStages;
  const uint32_t empty_b = full_b + 8 * kMaxBStages;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kConsumers * kMaxAStages; ++i) {
      mbar_init(full_a + 8 * i, 1);
      mbar_init(empty_a + 8 * i, 128);
    }
    for (int i = 0; i < kMaxBStages; ++i) {
      mbar_init(full_b + 8 * i, 1);
      mbar_init(empty_b + 8 * i, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < K; i += kThreads) c_s[i] = i < valid ? c[i] : 0.f;
  __syncthreads();

  const int pairs = (n + 2 * kTileRows - 1) / (2 * kTileRows);
  // The shuffle tells the compiler that the role is uniform over the warp.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread for the rows, one for B ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if constexpr (kStream) {
      // One warp fills each stage: lane 0 the B chunk and the stage's byte
      // count, every lane the rows lane, lane + 32, ... of the pair.
      if (threadIdx.x / 32 == kConsumers * 4 + 1) {
        const int lane = threadIdx.x & 31;
        const uint8_t* b_bytes = reinterpret_cast<const uint8_t*>(b);
        constexpr uint32_t kRowBytes = kChunk * sizeof(T);
        int stage = 0, parity = 1;
        for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
          const long long row0 = 2LL * pair * kTileRows;
          const int rows = n - row0 < 2 * kTileRows ? static_cast<int>(n - row0)
                                                    : 2 * kTileRows;
          for (int d = 0; d < nch; ++d) {
            mbar_wait(empty_b + 8 * stage, parity);
            const uint32_t dst = smem_u32(b_s + stage * kRingStage);
            const uint32_t full = full_b + 8 * stage;
            if (lane == 0) {
              mbar_expect_tx(full, kChunkBytes + rows * kRowBytes);
              bulk_load(dst, b_bytes + d * kChunkBytes, kChunkBytes, full);
            }
            __syncwarp();
            for (int r = lane; r < rows; r += 32)
              bulk_load(dst + kChunkBytes + r * kRowBytes, h + (row0 + r) * fp + d * kChunk,
                        kRowBytes, full);
            if (++stage == b_stages) stage = 0, parity ^= 1;
          }
        }
      }
    } else if (threadIdx.x == kConsumers * 128) {
      int stage = 0, parity = 1;
      for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
        for (int w = 0; w < kConsumers; ++w) {
          const int slot = w * a_stages + stage;
          mbar_wait(empty_a + 8 * slot, parity);
          const long long row0 = (2LL * pair + w) * kTileRows;
          const long long left = n - row0;
          if (left > 0) {
            const uint32_t bytes = (left < kTileRows ? static_cast<int>(left) : kTileRows) *
                                   fp * sizeof(T);
            mbar_expect_tx(full_a + 8 * slot, bytes);
            bulk_load(smem_u32(a_s + slot * a_stage_bytes), h + row0 * fp, bytes,
                      full_a + 8 * slot);
          } else {
            mbar_arrive(full_a + 8 * slot);
          }
        }
        if (++stage == a_stages) stage = 0, parity ^= 1;
      }
    } else if (threadIdx.x == kConsumers * 128 + 32) {
      const uint8_t* b_bytes = reinterpret_cast<const uint8_t*>(b);
      if (resident) {
        mbar_expect_tx(full_b, nch * kChunkBytes);
        for (int d = 0; d < nch; ++d)
          bulk_load(smem_u32(b_s + d * kChunkBytes), b_bytes + d * kChunkBytes,
                    kChunkBytes, full_b);
      } else {
        int stage = 0, parity = 1;
        for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
          for (int d = 0; d < nch; ++d) {
            mbar_wait(empty_b + 8 * stage, parity);
            mbar_expect_tx(full_b + 8 * stage, kChunkBytes);
            bulk_load(smem_u32(b_s + stage * kChunkBytes), b_bytes + d * kChunkBytes,
                      kChunkBytes, full_b + 8 * stage);
            if (++stage == b_stages) stage = 0, parity ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: MMAs and the argmin ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x & 127) >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int row_in_tile = 16 * warp + g;
    float acc[32 * NB] = {};
    Frag<T> f0, f1;
    BRing ring = {smem_u32(b_s), full_b, empty_b, kRingStage, b_stages, resident != 0, 0, 0, 0};
    if (resident) {
      mbar_wait(full_b, 0);
      if (wg == 1) asm volatile("bar.arrive 1, 256;" ::: "memory");
    }
    int a_stage = 0, a_parity = 0;
    for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
      if constexpr (kStream) {
        // This thread's two rows of a stage lie after its B chunk.
        StreamRing<T> sring{&ring, b_s,
                            kChunkBytes + ((wg * kTileRows + row_in_tile) * kChunk + 8 * t) *
                                              static_cast<uint32_t>(sizeof(T)),
                            0};
        sring.next(f0);
        fence_regs(acc);
        for (int d = 0; d < nch; d += 2) {
          stream_step<T, NB>(acc, f0, f1, d, nch, sring);
          if (d + 1 < nch) stream_step<T, NB>(acc, f1, f0, d + 1, nch, sring);
        }
        wgmma_wait_all();
        fence_regs(acc);
        ring.give_back();
      } else {
        const int slot = wg * a_stages + a_stage;
        mbar_wait(full_a + 8 * slot, a_parity);
        if (++a_stage == a_stages) a_stage = 0, a_parity ^= 1;
        const T* row_lo =
            reinterpret_cast<const T*>(a_s + slot * a_stage_bytes) + row_in_tile * fp + 8 * t;
        const T* row_hi = row_lo + 8 * fp;
        f0.load(row_lo, row_hi);
        // This warpgroup's turn on the tensor cores.
        if (resident) asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
        fence_regs(acc);

        for (int d = 0; d < nch; d += 2) {
          chunk_step<T, NB>(acc, f0, f1, d, nch, ring, row_lo, row_hi);
          if (d + 1 < nch) chunk_step<T, NB>(acc, f1, f0, d + 1, nch, ring, row_lo, row_hi);
        }
        mbar_arrive(empty_a + 8 * slot);
        if (resident) asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
        wgmma_wait_all();
        fence_regs(acc);
        if (!resident) ring.give_back();
      }

#ifdef VQ_SKIP_EPILOGUE  // measurement only: tools/score_phases.py
      if (t == 0 && (2LL * pair + wg) * kTileRows + row_in_tile < n)
        out[(2LL * pair + wg) * kTileRows + row_in_tile] = __float_as_int(acc[0] + acc[3]);
      continue;
#endif
      // acc[4j + 2r + v] is the score of row g + 8r, code 8j + 2t + v.
      // Pass 1: add c, and the row's minimum (min.NaN keeps a NaN) over the
      // thread's codes, then over the quad. In a ragged tile the pad codes'
      // scores become +inf first: a zero column of M meets an infinite row
      // value as inf * 0 = NaN, which would win.
      float low[2] = {INFINITY, INFINITY};
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j) {
        const float2 cc = *reinterpret_cast<const float2*>(c_s + 8 * j + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * j + 2 * r] += cc.x;
          acc[4 * j + 2 * r + 1] += cc.y;
          if constexpr (kRagged) {
            if (8 * j + 2 * t >= valid) acc[4 * j + 2 * r] = INFINITY;
            if (8 * j + 2 * t + 1 >= valid) acc[4 * j + 2 * r + 1] = INFINITY;
          }
          low[r] = fmin_nan(low[r], acc[4 * j + 2 * r]);
          low[r] = fmin_nan(low[r], acc[4 * j + 2 * r + 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        low[r] = fmin_nan(low[r], __shfl_xor_sync(0xffffffffu, low[r], 1));
        low[r] = fmin_nan(low[r], __shfl_xor_sync(0xffffffffu, low[r], 2));
      }
      // Pass 2: the smallest code at the minimum. The compare and select
      // units run at half the FMA rate, so the common case spends one
      // compare and one FMA per score: every hit adds kHit + (its code less
      // 2t) to a sum, exact in f32, which then holds the number of hits and,
      // when that is one, the code. Several hits in one thread (duplicate
      // codes) or a NaN minimum (nothing equals it; the NaN scores are the
      // hits) take the scan instead.
      constexpr float kHit = 1024.f;
      float hits[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int v = 0; v < 2; ++v)
            hits[r] = fmaf(acc[4 * j + 2 * r + v] == low[r] ? 1.f : 0.f, kHit + (8 * j + v),
                           hits[r]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int sum = __float2int_rn(hits[r]);
        int code = sum >> 10 == 1 ? (sum & 1023) + 2 * t : INT32_MAX;
        if (sum >> 10 > 1 || low[r] != low[r]) {
          // A copy the compiler cannot see through: it would otherwise hoist
          // these compares out of the branch, into the common case.
          float rare_low = low[r];
          asm volatile("" : "+f"(rare_low));
#pragma unroll
          for (int j = 8 * NB - 1; j >= 0; --j)
#pragma unroll
            for (int v = 1; v >= 0; --v) {
              const float s = acc[4 * j + 2 * r + v];
              if (s == rare_low || s != s) code = 8 * j + 2 * t + v;
            }
        }
        code = min(code, __shfl_xor_sync(0xffffffffu, code, 1));
        code = min(code, __shfl_xor_sync(0xffffffffu, code, 2));
        const long long row = (2LL * pair + wg) * kTileRows + row_in_tile + 8 * r;
        if (t == 0 && row < n) {
          // Across code tiles (launched in order) the same rules as inside
          // one: a strictly smaller score wins, an equal one keeps the
          // earlier code, a NaN wins over any number and the first NaN stays.
          if constexpr (!kMerge) {
            out[row] = code;
          } else if (code0 == 0) {
            out[row] = code;
            best[row] = low[r];
          } else {
            const float held = best[row];
            if (low[r] < held || (low[r] != low[r] && held == held)) {
              out[row] = code0 + code;
              best[row] = low[r];
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The kernel for one launch: ragged and merging tiles, and the streamed
// depth, are instantiations of their own.
template <typename T, int NB, bool kStream>
auto kernel_for(bool ragged, bool merge) {
  return merge ? (ragged ? score_argmin_kernel<T, NB, true, true, kStream>
                         : score_argmin_kernel<T, NB, false, true, kStream>)
               : (ragged ? score_argmin_kernel<T, NB, true, false, kStream>
                         : score_argmin_kernel<T, NB, false, false, kStream>);
}

// Launches one kernel per tile of K codes (the last tile may be partial),
// in code order; `best` carries the running minimum score across tiles and
// is unused (may be null) when one tile covers all k codes.
template <typename T, int NB>
int launch_nb(const void* h, const void* b, const void* c, void* out, void* best, int n,
              int fp, int k, cudaStream_t stream) {
  constexpr int K = 64 * NB;
  const size_t chunk = 3 * 2 * 16 * K * 2;
  // one row stage of both warpgroups
  const size_t rows = static_cast<size_t>(kConsumers) * kTileRows * fp * sizeof(T);
  const size_t fixed = K * sizeof(float) + kBarriers * 8;
  const int nch = fp / kChunk;
  if (k > K && best == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // M resident with as many row stages as fit; else two row stages and a
  // ring of B chunks; else (rows too deep for two full-depth stages) a ring
  // of stages that each hold a B chunk and the rows' 32 depths of it.
  // ops/quantize.py:score_plan makes the same choice.
  int resident = 1, a_stages = kMaxAStages, b_stages = 0;
  bool streamed = false;
  while (a_stages > 2 && nch * chunk + a_stages * rows + fixed > kSmemLimit) --a_stages;
  size_t smem = nch * chunk + a_stages * rows + fixed;
  if (smem > kSmemLimit) {
    resident = 0;
    if (2 * chunk + 2 * rows + fixed <= kSmemLimit) {
      b_stages = static_cast<int>((kSmemLimit - 2 * rows - fixed) / chunk);
      if (b_stages > kMaxBStages) b_stages = kMaxBStages;
      smem = b_stages * chunk + 2 * rows + fixed;
    } else {
      const size_t stage = chunk + static_cast<size_t>(kConsumers) * kTileRows * kChunk * sizeof(T);
      streamed = true;
      a_stages = 0;
      b_stages = static_cast<int>((kSmemLimit - fixed) / stage);
      if (b_stages > kMaxBStages) b_stages = kMaxBStages;
      // two stages always fit at K <= 256; kept as the mode's stated limit
      if (b_stages < 2) return static_cast<int>(cudaErrorInvalidConfiguration);
      smem = b_stages * stage + fixed;
    }
  }
  cudaError_t err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  const int pairs = (n + 2 * kTileRows - 1) / (2 * kTileRows);
  const size_t tile_elems = nch * chunk / 2;  // bf16 elements of B per code tile
  for (int code0 = 0; code0 < k; code0 += K) {
    const int valid = k - code0 < K ? k - code0 : K;
    auto kernel = streamed ? kernel_for<T, NB, true>(valid < K, k > K)
                           : kernel_for<T, NB, false>(valid < K, k > K);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<pairs < sms ? pairs : sms, kThreads, smem, stream>>>(
        static_cast<const T*>(h),
        static_cast<const __nv_bfloat16*>(b) + (code0 / K) * tile_elems,
        static_cast<const float*>(c) + code0, static_cast<int32_t*>(out),
        static_cast<float*>(best), n, fp, resident, a_stages, b_stages, code0, valid);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
int launch(const void* h, const void* b, const void* c, void* out, void* best, int n,
           int fp, int k, int kt, void* stream) {
  if (n <= 0 || fp <= 0 || fp % kChunk != 0 || k < 1 || k > 65536) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kt) {
    case 64: return launch_nb<T, 1>(h, b, c, out, best, n, fp, k, s);
    case 128: return launch_nb<T, 2>(h, b, c, out, best, n, fp, k, s);
    case 192: return launch_nb<T, 3>(h, b, c, out, best, n, fp, k, s);
    case 256: return launch_nb<T, 4>(h, b, c, out, best, n, fp, k, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* vq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h [n, fp] (bf16 when h_is_bf16, else f32; fp a multiple of 32), b the
// prepared operand of M in tiles of kt codes (ops/quantize.py:prepare_scores),
// c [ceil(k / kt) * kt] f32 -> out int32 [n]. kt is 64, 128, 192 or 256 and
// 1 <= k <= 65536; `best` is f32 [n] scratch, needed when k > kt.
extern "C" int vq_score_argmin(const void* h, int h_is_bf16, const void* b,
                               const void* c, void* out, void* best, int n, int fp, int k,
                               int kt, void* stream) {
  if (h_is_bf16) return launch<__nv_bfloat16>(h, b, c, out, best, n, fp, k, kt, stream);
  return launch<float>(h, b, c, out, best, n, fp, k, kt, stream);
}

// z [n, dp] f32, b the prepared operand of -2 E^T, esq = ||e||^2 (padded as
// c above) -> out int32 [n].
extern "C" int vq_nearest_indices(const void* z, const void* b, const void* esq,
                                  void* out, void* best, int n, int dp, int k, int kt,
                                  void* stream) {
  return launch<float>(z, b, esq, out, best, n, dp, k, kt, stream);
}
