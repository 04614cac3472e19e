// Hopper warpgroup products (wgmma.mma_async, sm_90a) on bf16 tiles in
// shared memory, f32 accumulators in registers.
//
// A warpgroup (four consecutive warps, 128 threads) issues each product
// together.  Both operands are read from shared memory through 64-bit
// descriptors; a tile's rows are 64 or 128 bytes (32 or 64 bf16), stored in
// the 64- or 128-byte swizzle (the 16-byte chunk c of the row at byte
// offset o sits at chunk c ^ ((o >> 7) & 3) or c ^ ((o >> 7) & 7)), each
// tile 1,024-byte aligned.  One stored tile serves as either operand of
// either kind:
//   * K-major: the tile's rows are the M (or N) index, K runs along a row;
//     the 8-row groups are 8 rows apart (SBO), a k-step of 16 moves the
//     start 32 bytes along the row;
//   * MN-major (wgmma's transpose flag, 16-bit types only): the rows are
//     the K index, M (or N) runs along a row, one swizzle atom wide (64
//     elements in the 128-byte swizzle, 32 in the 64-byte one: the widths
//     here); the 8-row groups are 8 rows apart (SBO), a k-step of 16 moves
//     the start 16 rows.
// So a weight stored as (in, out) is the MN-major B of h . W and the
// K-major B of da . W^T, and an (edge, width) tile is the K-major A of its
// layer's product and the MN-major A or B of a weight gradient x^T . d.
// A width of 128 bf16 (256-byte rows) is two swizzle atoms: such a tile is
// stored as two 64-column halves, each a tile of 128-byte rows, `half`
// bytes apart.  As an MN-major B (m64n128k16) the descriptor's leading
// byte offset (LBO) steps from the first half to the second along N; as a
// K-major A the k-step's start moves 32 bytes along a half's row and, from
// k-step 4 on, into the second half (product_w128).
//
// Accumulator layout of m64nNk16 (PTX ISA), thread t of the warpgroup, warp
// w = t / 32, lane l: d[i] holds row 16 w + l / 4 + 8 ((i / 2) % 2) and
// column 8 (i / 4) + 2 (l % 4) + (i % 2).
//
// An accumulator's pairs are the A fragments of a product that reads A
// from registers (product_rs): the pair d[i], d[i + 1] is a[i / 8][(i / 2)
// % 4] of K = 16 (i / 8) .. + 15.
//
// Shared-memory writes by the threads reach the products only after
// fence_async_smem() and a barrier; accumulators written by the threads
// reach them after fence(); a product's accumulators are read after
// wait<0>() (fence_operand keeps the compiler from moving reads above it).
// Each warp's wait covers its own part of a product: a tile that a
// product reads is written again only after every warp's wait and a
// barrier.
#pragma once

#include <cstdint>

namespace wg {

// the descriptor's layout types
constexpr int kSwizzle128 = 1;
constexpr int kSwizzle64 = 2;

// Byte offset o of a tile of ROW_BYTES-byte rows (64 or 128) in its
// swizzle.
template <int ROW_BYTES>
__host__ __device__ __forceinline__ uint32_t swz(uint32_t o) {
  static_assert(ROW_BYTES == 64 || ROW_BYTES == 128, "64 or 128 bytes");
  return ROW_BYTES == 128 ? o ^ ((o >> 3) & 0x70) : o ^ ((o >> 3) & 0x30);
}
// Byte offset of (row, col) of a bf16 tile of ROW_BYTES-byte rows.
template <int ROW_BYTES>
__host__ __device__ __forceinline__ uint32_t at(int row, int col) {
  return swz<ROW_BYTES>(row * ROW_BYTES + col * 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The descriptor of a tile of ROW_BYTES-byte rows at `tile`, as a K-major
// or an MN-major operand (the start moved by desc_step for each k-step).
// lbo: the MN-major stride from one 64-column half to the next (bytes; a
// tile one atom wide never reads it).
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t desc(const void* tile,
                                         uint32_t lbo = 16) {
  constexpr uint64_t layout = ROW_BYTES == 128 ? kSwizzle128 : kSwizzle64;
  constexpr uint64_t sbo = 8 * ROW_BYTES;
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         ((sbo >> 4) << 32) | (layout << 62);
}
// The descriptor's start for k-step j (16 of K): 32 bytes along a row
// (K-major) or 16 rows on (MN-major).
template <int ROW_BYTES, bool MN_MAJOR>
__device__ __forceinline__ uint64_t desc_step(uint64_t d, int j) {
  const uint64_t bytes = MN_MAJOR ? 16 * ROW_BYTES * j : 32 * j;
  return d + (bytes >> 4);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of the warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The threads' shared-memory writes, visible to the products (the async
// proxy) once a barrier follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define MAGNET_WG_R8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A . B, m64n64k16, A and B bf16 in shared memory (descriptors a,
// b), TA / TB: A / B MN-major; d is overwritten when accumulate is 0.
template <int TA, int TB>
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : MAGNET_WG_R8(0), MAGNET_WG_R8(8), MAGNET_WG_R8(16), MAGNET_WG_R8(24)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}
// d (+)= A . B, m64n32k16, as mma_n64
template <int TA, int TB>
__device__ __forceinline__ void mma_n32(float (&d)[16], uint64_t a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : MAGNET_WG_R8(0), MAGNET_WG_R8(8)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}
// d (+)= A . B with A (64 x 16) in registers (rows 16 w .. + 15 of warp w:
// a[0] (g, 2t..2t+1), a[1] (g + 8, 2t..), a[2] (g, 2t + 8..), a[3] (g + 8,
// 2t + 8..), lane 4 g + t, the lower column in the low half), B in shared
// memory, MN-major when TB.
template <int TB>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : MAGNET_WG_R8(0), MAGNET_WG_R8(8), MAGNET_WG_R8(16), MAGNET_WG_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}
template <int TB>
__device__ __forceinline__ void mma_rs_n32(float (&d)[16],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : MAGNET_WG_R8(0), MAGNET_WG_R8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}
// d (+)= A . B, m64n128k16, A and B in shared memory, as mma_n64
template <int TA, int TB>
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, "
      "%67, %68;\n}\n"
      : MAGNET_WG_R8(0), MAGNET_WG_R8(8), MAGNET_WG_R8(16), MAGNET_WG_R8(24),
        MAGNET_WG_R8(32), MAGNET_WG_R8(40), MAGNET_WG_R8(48),
        MAGNET_WG_R8(56)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}
// d (+)= A . B, m64n128k16, A (64 x 16) in registers as mma_rs_n64's
template <int TB>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : MAGNET_WG_R8(0), MAGNET_WG_R8(8), MAGNET_WG_R8(16), MAGNET_WG_R8(24),
        MAGNET_WG_R8(32), MAGNET_WG_R8(40), MAGNET_WG_R8(48),
        MAGNET_WG_R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}
#undef MAGNET_WG_R8

// d (+)= A . B over K = 16 KSTEPS, issued (not committed, not waited):
// A (64 x K) of A_BYTES-byte rows, MN-major when TA; B (K x N) of
// B_BYTES-byte rows, MN-major when TB; N = 64 or 32 by d's size.
template <int KSTEPS, int TA, int TB, int A_BYTES, int B_BYTES, int R>
__device__ __forceinline__ void product(float (&d)[R], const void* a,
                                        const void* b, bool accumulate) {
  static_assert(R == 32 || R == 16, "m64n64 or m64n32");
  const uint64_t da = desc<A_BYTES>(a), db = desc<B_BYTES>(b);
#pragma unroll
  for (int j = 0; j < KSTEPS; ++j) {
    const uint64_t aj = desc_step<A_BYTES, TA != 0>(da, j);
    const uint64_t bj = desc_step<B_BYTES, TB != 0>(db, j);
    const int acc = (accumulate || j > 0) ? 1 : 0;
    if constexpr (R == 32)
      mma_n64<TA, TB>(d, aj, bj, acc);
    else
      mma_n32<TA, TB>(d, aj, bj, acc);
  }
}

// d (+)= A . B over K = 16 KSTEPS with A in registers, a[j] the fragment of
// k-step j (mma_rs_n64), B as ``product``'s; issued, not committed.
// N = 128 (R = 64) takes an MN-major B of two 64-column halves `half`
// bytes apart (the descriptor's LBO).
template <int KSTEPS, int TB, int B_BYTES, int R>
__device__ __forceinline__ void product_rs(float (&d)[R],
                                           const uint32_t (&a)[KSTEPS][4],
                                           const void* b, bool accumulate,
                                           uint32_t half = 16) {
  static_assert(R == 64 || R == 32 || R == 16, "m64n128, m64n64 or m64n32");
  static_assert(R != 64 || (TB == 1 && B_BYTES == 128), "n128: MN-major B");
  const uint64_t db = desc<B_BYTES>(b, half);
#pragma unroll
  for (int j = 0; j < KSTEPS; ++j) {
    const uint64_t bj = desc_step<B_BYTES, TB != 0>(db, j);
    const int acc = (accumulate || j > 0) ? 1 : 0;
    if constexpr (R == 64)
      mma_rs_n128<TB>(d, a[j], bj, acc);
    else if constexpr (R == 32)
      mma_rs_n64<TB>(d, a[j], bj, acc);
    else
      mma_rs_n32<TB>(d, a[j], bj, acc);
  }
}

// d (+)= A . B, m64n128 over K = 128 (8 k-steps): A (64 x 128) K-major in
// two 64-column halves `a_half` bytes apart (k-steps 0-3 in the first, 4-7
// in the second), B (128 x 128) MN-major in two 64-column halves `b_half`
// bytes apart; issued, not committed.
__device__ __forceinline__ void product_w128(float (&d)[64], const void* a,
                                             uint32_t a_half, const void* b,
                                             uint32_t b_half,
                                             bool accumulate) {
  const uint64_t da0 = desc<128>(a), da1 = desc<128>(
      static_cast<const unsigned char*>(a) + a_half);
  const uint64_t db = desc<128>(b, b_half);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t aj = desc_step<128, false>(j < 4 ? da0 : da1, j & 3);
    const uint64_t bj = desc_step<128, true>(db, j);
    mma_n128<0, 1>(d, aj, bj, (accumulate || j > 0) ? 1 : 0);
  }
}
template <int K>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// ---- receiver sums on the tensor cores ------------------------------------
//
// The sums of a tile's rows y (64 edges of a receiver-grouped CSR graph)
// over each run of equal receivers as one product D = S . Y: S (64 x 64,
// bf16 0/1) has S[R][e] = 1 where edge e lies in the tile's run R, Y is the
// tile's (edge, width) bf16 tile (the MN-major B), D (64 runs x width) f32.
// Each run's sum is the tensor cores' f32 sum of its bf16 values (exact
// products, a fixed order): the same bits from run to run.

// Bit e (0 < e < n_valid) set where edge e starts a run after the first:
// rcv[e] != rcv[e - 1].  Every lane of the warp enters and gets the mask.
__device__ __forceinline__ uint64_t run_starts(const int* rcv, int n_valid) {
  const int lane = threadIdx.x & 31;
  const bool lo = lane > 0 && lane < n_valid && rcv[lane] != rcv[lane - 1];
  const bool hi = 32 + lane < n_valid && rcv[32 + lane] != rcv[31 + lane];
  return static_cast<uint64_t>(__ballot_sync(0xffffffffu, lo)) |
         static_cast<uint64_t>(__ballot_sync(0xffffffffu, hi)) << 32;
}
// The first edge of run R (R < the tile's runs): the R-th start.
__device__ __forceinline__ int run_first(uint64_t starts, int R) {
  if (R == 0) return 0;
  for (int k = 1; k < R; ++k) starts &= starts - 1;  // drop the first R - 1
  return __ffsll(static_cast<long long>(starts)) - 1;
}
// S's A fragments (K = 64 edges in four k-steps; rows the runs):
// a[j][q] holds S[R][e], S[R][e + 1] of R = r0 + 8 (q % 2), e = 16 j + 8 (q
// / 2) + c0 (mma_rs_n64's layout), 1.0 as bf16 0x3F80: 1 where e lies in
// [first edge of R, first edge of R + 1), the last run ending at n_valid,
// rows past the runs empty.
__device__ __forceinline__ void run_matrix(uint32_t (&a)[4][4],
                                           uint64_t starts, int n_valid) {
  const int t = threadIdx.x & 127;
  const int r0 = 16 * (t >> 5) + ((t & 31) >> 2), c0 = 2 * (t & 3);
  const int n_runs = __popcll(starts) + 1;
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = r0 + 8 * h;
    lo[h] = R < n_runs ? run_first(starts, R) : 64;
    // the next start after lo (none: the run ends at n_valid)
    const uint64_t after =
        lo[h] < 63 ? starts & (~0ull << (lo[h] + 1)) : 0ull;
    hi[h] = R >= n_runs ? 64
            : after   ? __ffsll(static_cast<long long>(after)) - 1
                      : n_valid;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = q & 1, e = 16 * j + 8 * (q >> 1) + c0;
      a[j][q] = (e >= lo[h] && e < hi[h] ? 0x3F80u : 0u) |
                (e + 1 >= lo[h] && e + 1 < hi[h] ? 0x3F800000u : 0u);
    }
}
// D's rows to the receivers, as csr_tile's sums leave them: a run whose
// edges all lie in the tile to out[its receiver], the tile's first run
// when it started in a tile before to part row 2 tile, its last run when
// it goes on past the tile to part row 2 tile + 1 (the one run of a tile
// inside a longer receiver to row 2 tile); first_start = rowptr[rcv[0]],
// last_end = rowptr[rcv[n_valid - 1] + 1] (csr_tile::edge_ends).  d is the
// m64nC accumulator (R = C / 2 floats a thread).
template <int C, int TE, int R>
__device__ __forceinline__ void store_runs(const float (&d)[R],
                                           uint64_t starts, const int* rcv,
                                           int first_start, int last_end,
                                           int n_edges, int tile, int n_valid,
                                           float* __restrict__ out,
                                           float* __restrict__ part) {
  static_assert(R == C / 2, "an m64nC accumulator");
  const int t = threadIdx.x & 127;
  const int r0 = 16 * (t >> 5) + ((t & 31) >> 2), c0 = 2 * (t & 3);
  const int n_runs = __popcll(starts) + 1, base = tile * TE;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int run = r0 + 8 * hh;
    if (run >= n_runs) continue;
    const bool begins = run != 0 || first_start >= base;
    const bool ends = run != n_runs - 1 ||
                      min(last_end, n_edges) <= base + TE;
    float* dst = begins && ends
                     ? out + (size_t)rcv[run_first(starts, run)] * C
                     : part + (size_t)(2 * tile + (begins ? 1 : 0)) * C;
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j + c0) =
          make_float2(d[4 * j + 2 * hh], d[4 * j + 2 * hh + 1]);
  }
}

// The accumulator's place: row and column of d[i] for this thread.
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x & 127;
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

}  // namespace wg
