// Helpers of the edge kernels that walk a receiver-grouped CSR graph.
//
// tile128: the entries' names, the receiver search, and the tiles of
// consecutive edges a persistent block walks (every kernel that walks a CSR
// graph in tiles of consecutive edges).
//
// tf32x3 (every GraphNet and MPNN kernel): f32 products on the tensor cores
// in error-compensated TF32, see below; the forwards and the width-64
// GraphNet backward split their operands in integer arithmetic
// (split_fast).
//
// csr_tile (every forward that walks a CSR graph in tiles of consecutive
// edges): the receiver sums of a tile and the sum of the partial rows that
// a receiver leaves in each tile it crosses (the bf16 forwards form their
// tiles' sums on the tensor cores, wgmma.cuh, into the same partial rows).
#pragma once

#include <cstdint>

namespace tile128 {

// Values of the C entries' `entry` argument.
enum Entry : int { kPregathered = 0, kFold = 1, kPe = 2 };

constexpr int kW = 128;          // Ce = H = C of the width-128 builds

// A 32-bit load through the read-only path, issued where it is written: an
// asm volatile statement, which the compiler neither moves past the others
// nor sinks to its first use, so a value loaded a phase ahead of its use
// is in flight under that phase.
__device__ __forceinline__ int ldg_ahead(const int* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned ldg_ahead(const unsigned* p) {
  unsigned v;
  asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// The receiver of edge e: the last i with rowptr[i] <= e.
__device__ __forceinline__ int receiver_of(const int* __restrict__ rowptr,
                                           int n_nodes, int e) {
  int lo = 0, hi = n_nodes;  // rowptr[lo] <= e < rowptr[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (rowptr[mid] <= e) lo = mid; else hi = mid;
  }
  return lo;
}

// The receiver of edge base + lane, for a whole warp whose edges base ..
// base + 31 are consecutive: a 32-way search for the receiver of `base`
// (three rounds of loads at 16k nodes, where receiver_of takes fourteen),
// skipped when the caller knows a receiver `hint` >= 0 of an edge before
// `base`; then one load of the next 32 row starts, which place every edge
// whose receiver lies among them; an edge past them (a run of receivers of
// degree 0) takes receiver_of.  Lanes past n_valid get an unspecified
// value.
__device__ __forceinline__ int warp_receiver(const int* __restrict__ rowptr,
                                             int n_nodes, int base,
                                             int n_valid, int hint = -1) {
  const int lane = threadIdx.x & 31;
  int lo = hint < 0 ? 0 : hint;  // rowptr[lo] <= base < rowptr[hi]
  int hi = hint < 0 ? n_nodes : lo;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) >> 5;
    const int i = lo + lane * step;
    const unsigned le =
        __ballot_sync(0xffffffffu, i < hi && __ldg(rowptr + i) <= base);
    lo += (31 - __clz(le)) * step;  // lane 0 (i = lo) always holds
    hi = min(hi, lo + step);
  }
  const int e = base + lane;
  const int j = lo + 1 + lane;
  const int start = j <= n_nodes ? __ldg(rowptr + j) : 0x7fffffff;
  int r = lo;
#pragma unroll
  for (int s = 0; s < 32; ++s) r += __shfl_sync(0xffffffffu, start, s) <= e;
  const int window_end = __shfl_sync(0xffffffffu, start, 31);  // every lane
  if (lane < n_valid && e >= window_end) r = receiver_of(rowptr, n_nodes, e);
  return r;
}

// The tiles of TE edges of a persistent block: consecutive, [*t_beg,
// *t_end), so that each tile's receivers are found from the last receiver
// of the tile before.
template <int TE>
__device__ __forceinline__ void block_tiles(int n_edges, int* t_beg,
                                            int* t_end) {
  const int n_tiles = (n_edges + TE - 1) / TE;
  const int per_block = (n_tiles + gridDim.x - 1) / gridDim.x;
  *t_beg = blockIdx.x * per_block;
  *t_end = min(n_tiles, *t_beg + per_block);
}

// The receivers (and, GATHERS, the senders) of tile `tile`'s TE = 64
// edges into s_rcv / s_snd (zero past the edge count), found from `hint`, a
// receiver of an edge before the tile (or -1).  Two warps 2k and 2k + 1
// (warps 0 and 1, or a warpgroup's first two), 32 edges each; every lane of
// both enters.
template <int TE, bool GATHERS>
__device__ __forceinline__ void tile_indices(int* s_rcv, int* s_snd,
                                             const int* __restrict__ senders,
                                             const int* __restrict__ rowptr,
                                             int n_nodes, int n_edges,
                                             int tile, int hint) {
  static_assert(TE == 64, "two warps of 32 edges");
  const int warp = (threadIdx.x >> 5) & 1, lane = threadIdx.x & 31;
  const int base = tile * TE + 32 * warp;
  const int n_valid = min(32, n_edges - base);
  const int rv = warp_receiver(rowptr, n_nodes, base, n_valid, hint);
  const bool valid = lane < n_valid;
  s_rcv[32 * warp + lane] = valid ? rv : 0;
  if (GATHERS)
    s_snd[32 * warp + lane] = valid ? __ldg(senders + base + lane) : 0;
}

}  // namespace tile128

// Error-compensated TF32 ("3xTF32") products on the tensor cores, through
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
//
// Each f32 operand x is split into hi = tf32(x) (cvt.rna: round to
// nearest, ties away from zero, to a 10-bit mantissa) and lo = tf32(x - hi),
// and a . b is accumulated as a_lo . b_hi + a_hi . b_lo, then a_hi . b_hi,
// in f32 accumulators.  The dropped a_lo . b_lo and the rounding of lo
// leave ~2^-21 of |a b| per product, close to f32; one TF32 product alone
// leaves ~2^-11 (tests/test_torch_tf32_split.py shows both at the kernels'
// depths).  Fragments are read by threads from f32 shared memory at any
// strides and split in registers, so one stored tile serves a product, its
// transpose and the weight gradient alike (wgmma's tf32 form reads only
// K-major operands from shared memory, and a stored lo plane would double
// every tile and halve the blocks an SM holds); why mma.sync and not wgmma
// is in each kernel's note.
//
// Fragment layout (PTX ISA, m16n8k8 .tf32), lane = 4 g + t:
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// mm_rows32, mm_rows64 and mm_square128 assume blocks of 8 warps; mm_warp
// takes the warp's place in the result from its caller.
namespace tf32x3 {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// The forward kernels' split, in three instructions: hi = x rounded to
// TF32 in integer arithmetic (to nearest, ties away from zero, as cvt.rna
// rounds every finite x), lo = x - hi (exact in f32), whose low 13 bits
// the tensor cores drop as they read it as TF32.  Within a few 2^-22 of
// |a b| per product, as split().
__device__ __forceinline__ void split_fast(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b on one 16 x 8 x 8 tile.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// Operands in shared memory, split as their fragments are loaded.
// Raw: element (i, j) at p[i * is + j * js].  Swz: rows of 128 floats with
// the XOR swizzle of swz(); element (i, j) is row i, column j, or with tr
// row j, column i.  A Swz tile is read free of bank conflicts along its
// rows and down its columns alike, and keeps 16-byte chunks whole (for
// cp.async).
struct Raw {
  const float* p;
  int is, js;
};
struct Swz {
  const float* p;
  bool tr;
};

// The column offset of row r of a swizzled tile: bits 2-4 only, so a row
// of W = 32, 64 or 128 floats keeps its columns.
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }
template <int W = 128>
__device__ __forceinline__ int swz_at(int r, int c) {
  static_assert(W % 32 == 0, "swizzled rows are a multiple of 32 floats");
  return r * W + (c ^ swz(r));
}

__device__ __forceinline__ float elem(const Raw& o, int i, int j) {
  return o.p[i * o.is + j * o.js];
}
__device__ __forceinline__ float elem(const Swz& o, int i, int j) {
  return o.tr ? o.p[swz_at(j, i)] : o.p[swz_at(i, j)];
}

// Swizzled tiles (rows of W floats) whose fragments are read by ldmatrix,
// one instruction a fragment, and split by split_fast (the forward
// kernels' operands): LdsmRows, A(m, k) = row m, column k; LdsmCols,
// B(k, n) = row n, column k (B stored transposed).  ldmatrix
// reads 8 x 8 16-bit blocks, that is 8 x 4 f32 blocks: lane l names a row
// of block l / 8 and receives element (l / 4, l % 4) of each block, an
// m16n8k8 .tf32 fragment's layout.
template <int W>
struct LdsmRows {
  const float* p;
};
template <int W>
struct LdsmCols {
  const float* p;
};

// B(k, n) = row k, column n of a swizzled tile of rows of W floats (a
// weight as stored, (in, out)), read by scalar loads (ldmatrix cannot
// transpose 32-bit elements) and split by split_fast: lanes (g, t) read
// rows k0 + t, columns n0 + g, 32 banks.
template <int W>
struct RowsB {
  const float* p;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const float* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// Rows m0..m0+15, columns k0..k0+7 of A(m, k).
template <class Op>
__device__ __forceinline__ void load_a(FragA& f, const Op& a, int m0,
                                       int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  split(elem(a, m0 + g, k0 + t), f.hi[0], f.lo[0]);
  split(elem(a, m0 + g + 8, k0 + t), f.hi[1], f.lo[1]);
  split(elem(a, m0 + g, k0 + t + 4), f.hi[2], f.lo[2]);
  split(elem(a, m0 + g + 8, k0 + t + 4), f.hi[3], f.lo[3]);
}

// Rows k0..k0+7, columns n0..n0+7 of B(k, n).
template <class Op>
__device__ __forceinline__ void load_b(FragB& f, const Op& b, int k0,
                                       int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  split(elem(b, k0 + t, n0 + g), f.hi[0], f.lo[0]);
  split(elem(b, k0 + t + 4, n0 + g), f.hi[1], f.lo[1]);
}

// The same fragments by ldmatrix: blocks (m0, k0), (m0 + 8, k0),
// (m0, k0 + 4), (m0 + 8, k0 + 4) are a0..a3; (n0, k0), (n0, k0 + 4) of
// the transposed B are b0, b1 (lanes 16-31 name the rows again).
template <int W>
__device__ __forceinline__ void load_a(FragA& f, const LdsmRows<W>& a,
                                       int m0, int k0) {
  const int lane = threadIdx.x & 31, blk = lane >> 3;
  uint32_t r[4];
  ldsm_x4(r, a.p + swz_at<W>(m0 + (lane & 7) + 8 * (blk & 1),
                             k0 + 4 * (blk >> 1)));
#pragma unroll
  for (int q = 0; q < 4; ++q)
    split_fast(__uint_as_float(r[q]), f.hi[q], f.lo[q]);
}
template <int W>
__device__ __forceinline__ void load_b(FragB& f, const LdsmCols<W>& b,
                                       int k0, int n0) {
  const int lane = threadIdx.x & 31;
  uint32_t r[2];
  ldsm_x2(r, b.p + swz_at<W>(n0 + (lane & 7), k0 + 4 * ((lane >> 3) & 1)));
#pragma unroll
  for (int q = 0; q < 2; ++q)
    split_fast(__uint_as_float(r[q]), f.hi[q], f.lo[q]);
}

template <int W>
__device__ __forceinline__ void load_b(FragB& f, const RowsB<W>& b, int k0,
                                       int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  split_fast(b.p[swz_at<W>(k0 + t, n0 + g)], f.hi[0], f.lo[0]);
  split_fast(b.p[swz_at<W>(k0 + t + 4, n0 + g)], f.hi[1], f.lo[1]);
}

// A(m, k) = row k, column m of a swizzled tile of rows of W floats (an
// activation tile read down its columns, the weight gradients' A), by
// scalar loads and split_fast: lanes (g, t) read rows k0 + t, columns
// m0 + g, 32 banks, as RowsB.
template <int W>
struct ColsA {
  const float* p;
};
template <int W>
__device__ __forceinline__ void load_a(FragA& f, const ColsA<W>& a, int m0,
                                       int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  split_fast(a.p[swz_at<W>(k0 + t, m0 + g)], f.hi[0], f.lo[0]);
  split_fast(a.p[swz_at<W>(k0 + t, m0 + g + 8)], f.hi[1], f.lo[1]);
  split_fast(a.p[swz_at<W>(k0 + t + 4, m0 + g)], f.hi[2], f.lo[2]);
  split_fast(a.p[swz_at<W>(k0 + t + 4, m0 + g + 8)], f.hi[3], f.lo[3]);
}

// d += a . b in three TF32 products, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// d += a_hi . b_hi and corr += a_lo . b_hi + a_hi . b_lo, the caller adding
// corr into d once the product is done.  The tensor cores add the products
// of a block to the accumulator aligned to the largest addend and truncate
// the rest, so every small term added to a large accumulator loses its low
// bits toward zero, and over a layer and a receiver's edges those losses
// add up on one side; the small terms kept apart lose bits only at their
// own scale (emulated: the worst element of a 199-edge receiver at width
// 128 falls from 1.0 to 0.16 of the 1e-4 bound, against 0.20 with every
// sum rounded to nearest; tests/test_torch_fold_tiles.py).
__device__ __forceinline__ void mma3_apart(float (&d)[4], float (&corr)[4],
                                           const FragA& a, const FragB& b) {
  mma(corr, a.lo, b.hi);
  mma(corr, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// The row and column of accumulator element c of the 16 x 8 tile whose
// corner is (m0, n0).
__device__ __forceinline__ int acc_row(int m0, int c) {
  return m0 + ((threadIdx.x & 31) >> 2) + 8 * (c >> 1);
}
__device__ __forceinline__ int acc_col(int n0, int c) {
  return n0 + 2 * (threadIdx.x & 3) + (c & 1);
}

// acc += A . B for a 32-row tile: A(m, k) (32 x K), B(k, n) (K x 128).
// Warp w owns columns 16 w .. 16 w + 15: acc[mi][ni] is the 16 x 8 tile at
// rows 16 mi, columns 16 w + 8 ni.
template <int K, class OA, class OB>
__device__ __forceinline__ void mm_rows32(float (&acc)[2][2][4],
                                          const OA& a, const OB& b) {
  const int n0 = (threadIdx.x >> 5) * 16;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    FragA fa[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) load_a(fa[mi], a, 16 * mi, k0);
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      FragB fb;
      load_b(fb, b, k0, n0 + 8 * ni);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma3(acc[mi][ni], fa[mi], fb);
    }
  }
}

// acc + corr += A . B on one warp's MI x NI tiles of 16 x 8, at rows m0 +
// 16 mi and columns n0 + 8 ni of the result: A(m, k) (.. x K), B(k, n)
// (K x ..), K a multiple of 8, the small terms in corr (mma3_apart).  Each
// A fragment serves NI tiles, each B fragment MI.
template <int MI, int NI, int K, class OA, class OB>
__device__ __forceinline__ void mm_warp(float (&acc)[MI][NI][4],
                                        float (&corr)[MI][NI][4],
                                        const OA& a, const OB& b, int m0,
                                        int n0) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    FragA fa[MI];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) load_a(fa[mi], a, m0 + 16 * mi, k0);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      FragB fb;
      load_b(fb, b, k0, n0 + 8 * ni);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        mma3_apart(acc[mi][ni], corr[mi][ni], fa[mi], fb);
    }
  }
}

// acc + corr += A . B for a 64-row tile in blocks of 8 warps: A(m, k)
// (64 x K), B(k, n) (K x N), N = 128, 64 or 32.  Warp w owns rows
// 32 (w & 1) .. + 31 and columns (N / 4) (w >> 1) .. + N / 4 - 1:
// acc[mi][ni] is the 16 x 8 tile at rows 32 (w & 1) + 16 mi, columns
// (N / 4) (w >> 1) + 8 ni.
template <int N, int K, class OA, class OB>
__device__ __forceinline__ void mm_rows64(float (&acc)[2][N / 32][4],
                                          float (&corr)[2][N / 32][4],
                                          const OA& a, const OB& b) {
  static_assert(N == 128 || N == 64 || N == 32,
                "mm_rows64 forms 128, 64 or 32 columns");
  const int w = threadIdx.x >> 5;
  mm_warp<2, N / 32, K>(acc, corr, a, b, 32 * (w & 1), (N / 4) * (w >> 1));
}

// acc += A . B for a 128 x 128 result: A(m, k) (128 x K), B(k, n)
// (K x 128), K a multiple of 8.  Warp w owns rows 32 (w & 3) .. + 31 and
// columns 64 (w >> 2) .. + 63: acc[mi][ni] is the 16 x 8 tile at rows
// 32 (w & 3) + 16 mi, columns 64 (w >> 2) + 8 ni.
template <int K, class OA, class OB>
__device__ __forceinline__ void mm_square128(float (&acc)[2][8][4],
                                             const OA& a, const OB& b) {
  const int w = threadIdx.x >> 5, m0 = 32 * (w & 3), n0 = 64 * (w >> 2);
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 8) {
    FragA fa[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) load_a(fa[mi], a, m0 + 16 * mi, k0);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      FragB fb;
      load_b(fb, b, k0, n0 + 8 * ni);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma3(acc[mi][ni], fa[mi], fb);
    }
  }
}

// 16 bytes from global to shared memory without passing through registers;
// zeros where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[r][0..W-1] <- row(r) for r < TE, zeros where row(r) is null, without
// waiting (the caller commits the group), by a block of Threads threads.
// dst rows are ld floats apart, ld a multiple of 4, or (ld == 0) dst is a
// SwzW<W> tile; `any` is a readable global address, named in place of a
// null row (no byte of it is read).
template <int TE, int W = 128, int Threads = 256, class Row>
__device__ __forceinline__ void rows_async(float* dst, int ld,
                                           const float* any, Row row) {
  constexpr int kChunks = W / 4;  // 16-byte chunks a row
  for (int k = threadIdx.x; k < TE * kChunks; k += Threads) {
    const int r = k / kChunks, c = (k % kChunks) * 4;
    const float* src = row(r);
    cp_async16(dst + (ld ? r * ld + c : swz_at<W>(r, c)), src ? src + c : any,
               src != nullptr);
  }
}

}  // namespace tf32x3

// The receiver sums of a forward that walks a receiver-grouped CSR graph
// in tiles of TE consecutive edges (tile t holds edges TE t .. TE t +
// TE - 1), without atomics.  Within a tile, each run of equal receivers is
// summed in CSR order; a receiver whose edges all lie in the tile is
// written to out, and one that crosses a tile boundary leaves one partial
// row per tile in part: row 2 t + 1 if it starts in tile t (the tile's
// last run), else row 2 t (the tile's first run).  cross_tile_sum_kernel
// then adds each such receiver's partial rows in tile order.  Every sum has
// the same association from run to run, so out has the same bits; a
// receiver of degree 0 is never written (out arrives zeroed).  Blocks of
// kThreads threads (the kernels) and of C threads (the partial-row sum).
namespace csr_tile {

constexpr int kThreads = 256;

// The sums of tile `tile` (n_valid of its edges exist) over the values
// ref(e, c) of its rows e and columns c < C, whose receivers are s_rcv[e],
// in two steps.  (1) Thread (c, q) = (tid % C, tid / C) sums column c over
// segment q, rows S q .. S q + S - 1 (Q = kThreads / C segments of S = TE /
// Q rows), in order: a run that starts and ends inside the segment is
// written to out; the segment's first and last run leave their sums in
// place of the segment's first and last value.  (2) Threads c < C join the
// segments in order.  ref(e, c) is a float& into the block's tile, read
// and written by thread (c, q) alone in step 1.  Every thread enters (a
// barrier separates the steps).
template <int TE, int C, class Ref>
__device__ __forceinline__ void receiver_sums(Ref ref, const int* s_rcv,
                                              const int* __restrict__ rowptr,
                                              int n_edges, int tile,
                                              int n_valid,
                                              float* __restrict__ out,
                                              float* __restrict__ part) {
  constexpr int Q = kThreads / C, S = TE / Q;
  static_assert(kThreads % C == 0 && TE % Q == 0 && S >= 2,
                "segments of two rows or more");
  const int c = threadIdx.x % C, q = threadIdx.x / C;
  const int base = tile * TE;
  // a run's whole sum in this tile: to out, or to the tile's partial row
  auto flush = [&](int r, float s) {
    const bool starts = __ldg(rowptr + r) >= base;
    const bool ends = min(__ldg(rowptr + r + 1), n_edges) <= base + TE;
    float* dst = starts && ends
                     ? out + (size_t)r * C
                     : part + (size_t)(2 * tile + (starts ? 1 : 0)) * C;
    dst[c] = s;
  };

  const int e0 = q * S, e1 = min(e0 + S, n_valid);
  if (e0 < e1) {
    int r = s_rcv[e0];
    float s = 0.f, first = 0.f;
    bool in_first = true;
#pragma unroll 4
    for (int e = e0; e < e1; ++e) {
      const int re = s_rcv[e];
      const float v = ref(e, c);
      if (re != r) {
        if (in_first)
          first = s;
        else
          out[(size_t)r * C + c] = s;  // starts and ends in the segment
        in_first = false;
        r = re;
        s = 0.f;
      }
      s += v;
    }
    if (in_first) {
      ref(e0, c) = s;
    } else {
      ref(e0, c) = first;
      ref(e1 - 1, c) = s;
    }
  }
  __syncthreads();
  if (q == 0) {
    int cur = -1;
    float acc = 0.f;
    for (int k = 0; k < Q && k * S < n_valid; ++k) {
      const int a = k * S, z = min(a + S, n_valid) - 1;
      const int rf = s_rcv[a], rl = s_rcv[z];
      const float f = ref(a, c);
      if (rf == cur) {
        acc += f;
      } else {
        if (cur >= 0) flush(cur, acc);
        cur = rf;
        acc = f;
      }
      if (rl != rf) {
        flush(cur, acc);
        cur = rl;
        acc = ref(z, c);
      }
    }
    if (cur >= 0) flush(cur, acc);
  }
}

// The row starts that tell whether a tile's first and last runs of equal
// receivers cross it (the others cannot), for a tile whose receivers are
// s_rcv (n_valid >= 1 edges): (rowptr[s_rcv[0]], rowptr[s_rcv[n_valid - 1]
// + 1]), loaded where called, without waiting (ldg_ahead); wg::store_runs
// reads them.
__device__ __forceinline__ int2 edge_ends(const int* __restrict__ rowptr,
                                          const int* s_rcv, int n_valid) {
  return make_int2(tile128::ldg_ahead(rowptr + s_rcv[0]),
                   tile128::ldg_ahead(rowptr + s_rcv[n_valid - 1] + 1));
}

// The receiver that crosses the boundary at edge TE (b + 1) (block b) and
// starts in the tile before it: out[r] = its partial rows added in tile
// order.  A receiver that crosses several boundaries is summed by the
// block of its first; a block whose boundary starts a receiver writes
// nothing.  Launched with n_tiles - 1 blocks of C threads.
template <int TE, int C>
__global__ void __launch_bounds__(C)
cross_tile_sum_kernel(const int* __restrict__ rowptr,
                      const float* __restrict__ part, float* __restrict__ out,
                      int n_nodes, int n_edges) {
  const int e = (blockIdx.x + 1) * TE;
  const int r = tile128::receiver_of(rowptr, n_nodes, e);
  const int beg = rowptr[r];
  if (beg >= e || beg < e - TE) return;
  const int t0 = beg / TE, t1 = (min(rowptr[r + 1], n_edges) - 1) / TE;
  const int c = threadIdx.x;
  float s = part[(size_t)(2 * t0 + 1) * C + c];
  for (int t = t0 + 1; t <= t1; ++t) s += part[(size_t)(2 * t) * C + c];
  out[(size_t)r * C + c] = s;
}

}  // namespace csr_tile
