// Fused InteractionNetwork edge pipeline, backward, f32, three entries.
//
// fold (kFold) replaces the TPU kernel
// magnet_tpu/ops/pallas_kernels.py:_fused2r_bwd_pallas as
// _make_fused2r(fold_e=True).bwd calls it (public entry
// fused_edge_tail_agg2rf; the oracle is autodiff of _fused2re_ref_impl);
// pregathered (kPregathered) replaces _fused_bwd_pallas, the VJP of
// fused_edge_tail_agg (the oracle is _fused_ref_bwd); pe (kPe) replaces
// _fused2_bwd_pallas, the kernel of the VJP of fused_edge_tail_agg2 (the
// oracle is autodiff of _fused2_ref_impl).
//
// Given the forward's operands and g (N, C), for every edge j -> i of a
// receiver-grouped CSR graph it recomputes
//
//     z = e0[e] . W_e + b_e + pxj[j] + pxi[i]     (fold)
//     z = h0[e] + pxi[i]                          (pregathered)
//     z = pe[e] + pxj[j] + pxi[i]                 (pe)
//     h_0 = relu(z)
//     h_k = relu(h_{k-1} . W_k + b_k)  for k = 1..L1
//     y = h_L1 . W_out + b_out;  xhat = (y - mean) * rstd   (eps 1e-5)
//
// and returns, all f32:
//     fold:        d_e0 (E, Ce) = dz . W_e^T,  d_pxj[j] (N, H) += dz
//     pregathered: d_h0 (E, H) = dz  (the sender gather's cotangent is the
//                  caller's: a segment sum over the sender CSR)
//     pe:          d_pe (E, H) = dz  (d_pxj likewise the caller's: the
//                  segment sum of dz over the sender CSR, as the JAX VJP
//                  reduces it outside the kernel)
//     d_pxi[i] (N, H) += dz              and, packed into one buffer,
//     dW_e, db_e (fold only), dW_k, db_k, dW_out, db_out, d_ln_s, d_ln_b,
// with dy = rstd (g ln_s - mean(g ln_s) - xhat mean(g ln_s xhat)),
// da_L1 = (dy . W_out^T) [h_L1 > 0], da_{k-1} = (da_k . W_k^T) [h_{k-1} >
// 0], dz = da_0, dW_k = h_{k-1}^T . da_k, db_k = sum da_k (and likewise
// for W_out from h_L1 and dy, for W_e from e0 and dz).  relu's derivative
// at 0 is 0; a receiver of degree 0 has no edge, so its d_pxi row stays 0.
//
// Compiled builds: fold (Ce, H, C) = (32, 64, 32) and (128, 128, 128);
// pregathered and pe (H, C) = (64, 32) and (128, 128); L1 in 0..3.  The
// width-64 and width-128 builds are two designs.
//
// The edges are the first rowptr[N] <= E rows, read on the card
// (tile128::live_edges), as in the forward: a graph padded to a fixed E
// for a captured training step has dead rows past rowptr[N].  Every grid
// is sized for the E rows; every kernel splits the live edges over the
// blocks it would take for them alone (TileBlocks, StridedBlocks,
// RangeBlocks below), a block past that split exits whole, and the
// fixed-order sums read the partials of those blocks alone.  So the
// weight gradients and d_src's live rows are those of the graph without
// the padding, bit for bit; d_src's dead rows are zero, and nothing of
// them reaches d_pxj, d_pxi or a weight gradient.
//
// Design at width 64 (namespace w64; fold (32, 64, 32), pregathered and
// pe (64, 32)): one kernel, every product on the tensor cores.
//   * A persistent block of 512 threads (16 warps, one block per SM) walks
//     consecutive tiles of 64 CSR edges (tile128::block_tiles); warps 0 and
//     1 find the next tile's receivers (and senders) from the last receiver
//     of this one (tile128::warp_receiver).
//   * Every weight stays in shared memory for the whole launch, as stored
//     (in, out) and XOR-swizzled: one copy serves W (RowsB, scalar loads)
//     and W^T (LdsmCols, ldmatrix).  The tile's activations h_0..h_L1 and
//     one more plane live in swizzled (64, 64) planes, y and dy in a
//     (64, 32) tile; nothing of (E, H) reaches device memory but the
//     pregathered entry's d_h0 and the pe entry's d_pe, their outputs.
//     The next tile's input rows (e0, h0 or pe) arrive by cp.async while
//     this tile computes.  The fold's first-layer accumulators start at
//     b_e + pxj[s] + pxi[i], read through L2; the pregathered entry forms
//     relu(h0 + pxi[i]) with pxi read likewise, and the pe entry
//     relu((pe + pxj[s]) + pxi[i]) with both node rows read likewise (the
//     forward's order of the sums, so the recompute has its bits), its
//     sender ids staged beside the receivers.  178,432 bytes of shared
//     memory (fold), 169,472 (pregathered) and 169,984 (pe) at L1 = 3.
//   * Each layer of the backward is one phase between two barriers: the
//     weight gradient h_{k-1}^T . da_k (A read down the columns of the
//     activation plane by scalar loads, ColsA, free of bank conflicts on
//     the swizzle) and the data gradient da_{k-1} = (da_k . W_k^T) [h_{k-1}
//     > 0] into the plane of h_k, dead by then (so da_j sits in plane
//     j + 1 and dz in plane 1): one barrier a layer, with one plane more
//     than the activations.
//   * Products: 3xTF32 (tf32x3::mm_warp, mma.sync m16n8k8, operands split
//     by split_fast, the small products in an accumulator of their own);
//     warp w forms 16 rows and 16 columns of a 64 x 64 result (8 of a
//     64 x 32 or 32 x 64 one).
//   * Weight gradients: the tensor cores truncate what they add to a large
//     accumulator, and a block's running sums span its whole edge range
//     (~510 edges at MAgNet[CNN] 1D's training graph, ~2,270 at 2D's
//     batch-32 graph), so each tile's dW is formed in fresh accumulators
//     and added to the thread's running f32 sums (32 registers at L1 = 3)
//     with ordinary adds.  The bias gradients are column sums of the
//     gradient planes, a thread a column and an eighth of the rows
//     (d_ln_s, d_ln_b: a shuffle sum over a warp's four edges, kept per
//     warp in shared memory).  A block writes its partial sums once, and a
//     second small kernel adds the blocks' partials in block order, so the
//     weight gradients are the same from run to run.
//   * fold: d_pxj is scattered over senders with f32 atomicAdd into a
//     zeroed buffer; d_pxi is summed over each run of equal receivers in an
//     eighth of a tile and added with one atomicAdd per run.  Both differ
//     in the last bits from run to run; d_e0 / d_h0 / d_pe and the weight
//     gradients do not.  pe: d_pe = dz is the caller's to sum over the
//     sender CSR for d_pxj (no atomics), as the JAX VJP does.
// What bounds it on an H100: recompute, data and weight gradients are each
// the forward's multiply-adds: 3 x 16,384 an edge for the fold at L1 = 3
// (3 x 14,336 pregathered), against e0 read and d_e0 written once (256 B an
// edge): bound by operations.  At MAgNet[CNN] 1D's training graph (67,680
// edges) 6.65 GFLOP, 0.0993 ms on the f32 CUDA cores or 0.0403 ms as three
// TF32 products at 495 TFLOP/s; the pregathered entry at 2D's batch-32
// graph (299,894 edges) 0.385 / 0.156 ms; the pe entry (3 x 14,336, pe read
// and d_pe written, 512 B an edge) at 1D's training graph 0.087 / 0.035 ms.  mma.sync and not wgmma: the
// products read W as stored and transposed and the activation planes along
// their rows and down their columns, while wgmma's tf32 form reads only
// K-major operands from shared memory.  One block of 16 warps an SM and
// not two of 8: two would hold the weights twice (2 x 65 KB), forcing
// 32-edge tiles and 64 running dW registers a thread.
//
// Design at width 128 (all three entries, Ce = H = C = 128, L1 <= 3).
// Five f32 weight gradients (320 KB at L1 = 3) fit neither a block's
// 227 KB of shared memory nor its registers, and neither do the five
// weights the recompute and the data gradients need, so the backward is
// two hand-written kernels in one launch sequence, not one fused kernel:
//   (a) the recompute and the data-gradient chain, as one pass per layer
//       over every edge (edge_pass_kernel): h_0 (fold: e0 . W_e + b_e +
//       pxj[j] + pxi[i]; pregathered, pe: an elementwise kernel), h_1..h_L1,
//       y and LayerNorm's backward to dy, then da_L1..da_1 and dz through
//       each W^T masked by h > 0, and, fold, d_e0 = dz . W_e^T.  Each pass
//       keeps its one weight resident in shared memory for the whole launch
//       (no weight is reloaded per tile), walks 32-edge tiles on a
//       persistent grid, and fetches the next tile's rows with cp.async
//       while the current tile computes; 103 KB of shared memory and at
//       most 128 registers, so two blocks of 8 warps share an SM (splitting the weight and each tile once in shared memory would
//       save the warps' repeated splits but needs 203 KB, one block per SM,
//       and these passes are held by latency more than by the splits).
//       Each h_k and each layer's output gradient (dz, da_1..da_L1,
//       dy) is written once to a scratch buffer the wrapper allocates: at
//       MAgNet[GNN]'s training batch (67,572 edges, L1 = 3) 9 planes of 512 B
//       per edge, 311 MB written and read back, ~0.19 ms at 3.35 TB/s, in
//       place of the per-tile read-modify-write of every dW partial in
//       device memory (~1.35 GB a launch) of the design before;
//   (b) wgrad_kernel, a tall-skinny product dW_k = sum_e h_k[e]^T da_k[e]
//       (with db_k = sum_e da_k[e]) for every weight at once: the edges are
//       split into ranges over the blocks, each block keeps its 128 x 128
//       result in 64 f32 accumulators a thread across its range (32-edge
//       slabs double-buffered with cp.async, 70 KB), and writes it once; a
//       last
//       kernel adds the ranges' partials in range order, so the weight
//       gradients are the same from run to run.  d_ln_s / d_ln_b are summed
//       per block in the LN pass and added the same way.
// d_pxj (fold) and d_pxi are scattered from dz by scatter_kernel with f32
// atomics (one per element for d_pxj, one per run of equal receivers in a
// half tile for d_pxi): their last bits vary from run to run.
// Every product runs on the tensor cores in error-compensated TF32
// (tf32x3, csrc/tile_mm.cuh): ~2^-21 relative per product, so a recomputed
// pre-activation stays far closer to the f32 one than the relu-tie band
// that chip_smoke.py guards (1e-5 of the layer's RMS); one TF32 pass
// (~5e-4) would not.  mma.sync m16n8k8 and not wgmma: the passes read W as
// stored (forward) and transposed (backward) and kernel (b) reads both
// tiles down their columns, while wgmma's tf32 form reads only K-major
// operands from shared memory; mma.sync's fragments are loaded by threads
// from f32 shared memory at any strides and split into hi / lo in
// registers, so no lo plane doubles a weight.
// Bound at MAgNet[GNN]'s training batch (~67.6k LR u HR edges, L1 = 3):
// fold 3 x 81,920 multiply-adds per edge = 33 GFLOP, ~0.49 ms at 67 TFLOP/s
// on the f32 CUDA cores, or 99 GFLOP as issued in three TF32 products,
// ~0.20 ms at 495 TFLOP/s; pe 3 x 65,536.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (magnet_tpu_torch/ops/cuda_build.py does this).


#include <cuda_runtime.h>

#include <atomic>

#include "tile_mm.cuh"

namespace {

constexpr float kLnEps = 1e-5f;
constexpr int kMaxDevices = 64;

// The blocks of a launch that hold partial sums, as a function of the live
// edges (tile128::live_edges): each launch splits the live edges alone,
// so that on a padded graph its partials, and their sum, are those of the
// graph without the padding.
//
// TileBlocks: runs of consecutive 64-edge tiles on at most `cap` blocks,
// the fewest tiles a block, then the fewest blocks (the width-64 backward).
struct TileBlocks {
  int cap;
  __host__ __device__ int operator()(int live) const {
    const int n_tiles = (live + 63) / 64;
    if (n_tiles == 0) return 0;
    const int per = (n_tiles + cap - 1) / cap;
    return (n_tiles + per - 1) / per;
  }
};
// StridedBlocks: 32-edge tiles strided over the grid's `grid` blocks, or
// over one block a tile where there are fewer tiles (the LayerNorm pass).
struct StridedBlocks {
  int grid;
  __host__ __device__ int operator()(int live) const {
    const int n_tiles = (live + 31) / 32;
    return n_tiles < grid ? n_tiles : grid;
  }
};
// RangeBlocks: ranges of `chunk(live)` edges, whole 32-edge slabs, enough
// of them for `want` blocks (the width-128 weight gradients).
struct RangeBlocks {
  int want;
  __host__ __device__ int chunk(int live) const {
    const int n_slabs = (live + 31) / 32;
    return (n_slabs + want - 1) / want * 32;
  }
  __host__ __device__ int operator()(int live) const {
    return live > 0 ? (live + chunk(live) - 1) / chunk(live) : 0;
  }
};

// wgrad[p] = sum over the first count(live) blocks, in block order, of
// partial[b][p].
template <class Count>
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ wgrad,
                                       const int* __restrict__ rowptr,
                                       int n_nodes, int n_rows, Count count,
                                       int total) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const int n_blocks = count(tile128::live_edges(rowptr, n_nodes, n_rows));
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * total + p];
  wgrad[p] = s;
}

// Rows [live, n_rows) of the (n_rows, width) array d_src set to zero, by
// every thread of the grid: a padded graph's dead rows get no gradient.
__device__ __forceinline__ void zero_dead_rows(float* __restrict__ d_src,
                                               int live, int n_rows,
                                               int width) {
  const size_t n = (size_t)(n_rows - live) * width / 4;
  float4* dst = reinterpret_cast<float4*>(d_src + (size_t)live * width);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

namespace w64 {

using tile128::Entry;
using tile128::kFold;
using tile128::kPe;
using tile128::kPregathered;

constexpr int kCe = 32;          // the fold's edge-latent width
constexpr int kH = 64;           // hidden width
constexpr int kC = 32;           // output width
constexpr int kTE = 64;          // edges per tile
constexpr int kThreads = 512;    // 16 warps, one block per SM
constexpr int kWarps = kThreads / 32;

// Offsets, in floats, into dynamic shared memory and into the packed
// weight-gradient buffer; the pregathered and pe entries have no W_e and
// b_e and stage one tile of h0 or pe rows where the fold keeps two of e0;
// the pregathered entry has no senders.
template <int L1, Entry E>
struct Layout {
  static constexpr bool FOLD = E == kFold;
  static constexpr bool GATHERS = E != kPregathered;
  static constexpr int plane = kTE * kH;          // a swizzled (kTE, kH) tile
  static constexpr int we = 0;                    // (kCe, kH), swizzled
  static constexpr int wr = we + (FOLD ? kCe * kH : 0);  // L1 x (kH, kH)
  static constexpr int wo = wr + L1 * kH * kH;    // (kH, kC)
  static constexpr int be = wo + kH * kC;         // (kH)
  static constexpr int br = be + (FOLD ? kH : 0);  // (L1, kH)
  static constexpr int bo = br + L1 * kH;         // (kC)
  static constexpr int ls = bo + kC;              // (kC)
  static constexpr int act = ls + kC;             // L1 + 2 planes
  static constexpr int y = act + (L1 + 2) * plane;  // (kTE, kC): y, then dy
  static constexpr int src = y + kTE * kC;        // 2 x (kTE, kCe) or (kTE, kH)
  static constexpr int ln = src + (FOLD ? 2 * kTE * kCe : plane);
  static constexpr int rcv = ln + kWarps * 2 * kC;  // 2 x (kTE) int, two tiles
  static constexpr int snd = rcv + 2 * kTE;       // 2 x (kTE) int
  static constexpr int floats = snd + (GATHERS ? 2 * kTE : 0);

  static constexpr int g_we = 0;
  static constexpr int g_be = g_we + (FOLD ? kCe * kH : 0);
  static constexpr int g_wr = g_be + (FOLD ? kH : 0);
  static constexpr int g_br = g_wr + L1 * kH * kH;
  static constexpr int g_wo = g_br + L1 * kH;
  static constexpr int g_bo = g_wo + kH * kC;
  static constexpr int g_ls = g_bo + kC;
  static constexpr int g_lb = g_ls + kC;
  static constexpr int g_total = g_lb + kC;
};

// The part of an (R x N) product that a warp forms: rows 16 (w % (R / 16))
// .. + 15 and columns 8 NI (w / (R / 16)) .. + 8 NI - 1 of the result,
// acc[0][ni] the 16 x 8 tile at column 8 ni of them.
template <int R, int N>
struct Prod {
  static constexpr int NI = R * N / (kWarps * 128);
  static_assert(NI >= 1 && R % 16 == 0 && kWarps % (R / 16) == 0,
                "the warps cover the result");
  float acc[1][NI][4], corr[1][NI][4];
  int m0, n0;

  __device__ __forceinline__ Prod() {
    const int w = threadIdx.x >> 5;
    m0 = 16 * (w % (R / 16));
    n0 = 8 * NI * (w / (R / 16));
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[0][ni][c] = corr[0][ni][c] = 0.f;
  }
  // acc = f(row, column) on the thread's elements
  template <class F>
  __device__ __forceinline__ void init(F f) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[0][ni][c] = f(tf32x3::acc_row(m0, c),
                          tf32x3::acc_col(n0 + 8 * ni, c));
  }
  // acc += A . B, A(m, k) (R x K), B(k, n) (K x N), in 3xTF32
  template <int K, class OA, class OB>
  __device__ __forceinline__ void run(const OA& a, const OB& b) {
    tf32x3::mm_warp<1, NI, K>(acc, corr, a, b, m0, n0);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[0][ni][c] += corr[0][ni][c];
  }
  // f(row, column, v0, v1) on the thread's pairs of adjacent elements
  template <class F>
  __device__ __forceinline__ void pairs(F f) const {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(tf32x3::acc_row(m0, 2 * h), tf32x3::acc_col(n0 + 8 * ni, 0),
          acc[0][ni][2 * h], acc[0][ni][2 * h + 1]);
  }
  // a swizzled (R, N) tile <- acc, through relu when RELU, or where
  // mask > 0 (the same place of a tile of the same shape) when mask is set
  template <bool RELU>
  __device__ __forceinline__ void store(float* t,
                                        const float* mask = nullptr) const {
    pairs([&](int r, int c, float v0, float v1) {
      const int o = tf32x3::swz_at<N>(r, c);
      if (RELU) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      } else if (mask != nullptr) {
        const float2 m = *reinterpret_cast<const float2*>(mask + o);
        v0 = m.x > 0.f ? v0 : 0.f;
        v1 = m.y > 0.f ? v1 : 0.f;
      }
      *reinterpret_cast<float2*>(t + o) = make_float2(v0, v1);
    });
  }
  // run += acc: a tile's weight gradient into the running sums
  __device__ __forceinline__ void add_to(float (&run)[1][NI][4]) const {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) run[0][ni][c] += acc[0][ni][c];
  }
  // out[row * N + column] = run, the running sums in this part's places
  __device__ __forceinline__ void write(float* out,
                                        const float (&run)[1][NI][4]) const {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[tf32x3::acc_row(m0, c) * N + tf32x3::acc_col(n0 + 8 * ni, c)] =
            run[0][ni][c];
  }
};

// dst <- n_mat (K x N) weights w as stored, each a swizzled tile of rows of
// N floats.
template <int K, int N>
__device__ __forceinline__ void load_weights(float* dst,
                                             const float* __restrict__ w,
                                             int n_mat) {
  for (int k = threadIdx.x; k < n_mat * K * N; k += kThreads)
    dst[(k / (K * N)) * K * N + tf32x3::swz_at<N>((k / N) % K, k % N)] =
        __ldg(w + k);
}

// The thread's column sum over the tile's part of a swizzled (kTE, W)
// tile: column tid % W, rows (tid / W) R .. + R - 1 with R = kTE W /
// kThreads (the bias gradients; a warp reads one row's 32 columns).
template <int W>
__device__ __forceinline__ float column_part(const float* t) {
  constexpr int R = kTE * W / kThreads;
  const int c = threadIdx.x % W, r0 = (threadIdx.x / W) * R;
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) s += t[tf32x3::swz_at<W>(r0 + r, c)];
  return s;
}

// The sum, in row-part order, of column c's parts that column_part<W> left
// at sums[tid] (one float a thread).
template <int W>
__device__ __forceinline__ float column_total(const float* sums, int c) {
  float s = 0.f;
  for (int q = 0; q < kThreads / W; ++q) s += sums[q * W + c];
  return s;
}

// LayerNorm's backward over the tile's y (a swizzled (kTE, kC) tile), in
// place: dy = rstd (dx - mean(dx) - xhat mean(dx xhat)), dx = g ln_s, with
// the row's mean and rstd recomputed (two-pass variance, eps 1e-5).  Eight
// threads an edge, thread q of edge e holding columns q + 8 j (free of bank
// conflicts); gv holds g[i] on them (zero past the tile's edges).  The
// tile's g xhat and g, summed over each warp's four edges, are added to
// the warp's row of s_ln (d_ln_s, then d_ln_b).
__device__ __forceinline__ void layer_norm_bwd(float* s_y, const float* s_ls,
                                               const float (&gv)[kC / 8],
                                               float* s_ln) {
  constexpr int CP = kC / 8;
  const int e = threadIdx.x >> 3, q = threadIdx.x & 7;
  float v[CP];
  float mu = 0.f;
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    v[j] = s_y[tf32x3::swz_at<kC>(e, q + 8 * j)];
    mu += v[j];
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) mu += __shfl_xor_sync(0xffffffffu, mu, o);
  mu *= 1.f / kC;
  float var = 0.f;
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const float d = v[j] - mu;
    var = fmaf(d, d, var);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
  var *= 1.f / kC;
  const float rstd = rsqrtf(var + kLnEps);
  float m1 = 0.f, m2 = 0.f, dx[CP], gx[CP], gs[CP];
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    v[j] = (v[j] - mu) * rstd;  // xhat
    dx[j] = gv[j] * s_ls[q + 8 * j];
    m1 += dx[j];
    m2 = fmaf(dx[j], v[j], m2);
    gx[j] = gv[j] * v[j];
    gs[j] = gv[j];
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    m1 += __shfl_xor_sync(0xffffffffu, m1, o);
    m2 += __shfl_xor_sync(0xffffffffu, m2, o);
  }
  m1 *= 1.f / kC;
  m2 *= 1.f / kC;
#pragma unroll
  for (int j = 0; j < CP; ++j)
    s_y[tf32x3::swz_at<kC>(e, q + 8 * j)] = rstd * (dx[j] - m1 - v[j] * m2);
#pragma unroll
  for (int j = 0; j < CP; ++j)
#pragma unroll
    for (int o = 8; o < 32; o <<= 1) {
      gx[j] += __shfl_xor_sync(0xffffffffu, gx[j], o);
      gs[j] += __shfl_xor_sync(0xffffffffu, gs[j], o);
    }
  if ((threadIdx.x & 31) < 8) {
    float* row = s_ln + (threadIdx.x >> 5) * 2 * kC;
#pragma unroll
    for (int j = 0; j < CP; ++j) {
      row[q + 8 * j] += gx[j];
      row[kC + q + 8 * j] += gs[j];
    }
  }
}

template <int L1, Entry E>
__global__ void __launch_bounds__(kThreads, 1)
edge_tail_bwd_kernel(const float* __restrict__ src,
                     const float* __restrict__ we,
                     const float* __restrict__ be,
                     const float* __restrict__ pxj,
                     const float* __restrict__ pxi,
                     const int* __restrict__ senders,
                     const int* __restrict__ rowptr,
                     const float* __restrict__ w_rest,
                     const float* __restrict__ b_rest,
                     const float* __restrict__ w_out,
                     const float* __restrict__ b_out,
                     const float* __restrict__ ln_s,
                     const float* __restrict__ g, float* __restrict__ d_src,
                     float* __restrict__ d_pxj, float* __restrict__ d_pxi,
                     float* __restrict__ partial, int n_nodes, int n_rows,
                     int cap) {
  using L = Layout<L1, E>;
  using namespace tf32x3;
  constexpr bool FOLD = L::FOLD, GATHERS = L::GATHERS;
  constexpr int NL = L1 > 0 ? L1 : 1;
  constexpr int kIn = FOLD ? kCe : kH;  // the staged rows' width
  // the live edges (read while the weights load), split over the blocks
  // the launch would take for them alone (TileBlocks); the dead rows'
  // d_src is zero, and a block past that split holds no tile and writes
  // no partial
  const int n_edges = tile128::live_edges(rowptr, n_nodes, n_rows);
  extern __shared__ __align__(16) float w64_smem[];
  float* s_we = w64_smem + L::we;
  float* s_wr = w64_smem + L::wr;
  float* s_wo = w64_smem + L::wo;
  float* s_be = w64_smem + L::be;
  float* s_br = w64_smem + L::br;
  float* s_bo = w64_smem + L::bo;
  float* s_ls = w64_smem + L::ls;
  float* s_y = w64_smem + L::y;
  float* s_ln = w64_smem + L::ln;
  int* s_rcv = reinterpret_cast<int*>(w64_smem + L::rcv);
  int* s_snd = reinterpret_cast<int*>(w64_smem + L::snd);
  // plane k: h_k, and the gradient da_{k-1} once h_k is dead
  auto plane = [&](int k) { return w64_smem + L::act + k * L::plane; };
  // the staged rows of tile buffer `buf` (the fold keeps two)
  auto staged = [&](int buf) {
    return w64_smem + L::src + (FOLD ? buf * kTE * kCe : 0);
  };
  const int tid = threadIdx.x, warp = tid >> 5;

  if (FOLD) {
    load_weights<kCe, kH>(s_we, we, 1);
    if (tid < kH) s_be[tid] = __ldg(be + tid);
  }
  load_weights<kH, kH>(s_wr, w_rest, L1);
  load_weights<kH, kC>(s_wo, w_out, 1);
  for (int k = tid; k < L1 * kH; k += kThreads) s_br[k] = __ldg(b_rest + k);
  if (tid < kC) {
    s_bo[tid] = __ldg(b_out + tid);
    s_ls[tid] = __ldg(ln_s + tid);
  }
  for (int k = tid; k < kWarps * 2 * kC; k += kThreads) s_ln[k] = 0.f;
  const int n_split = TileBlocks{cap}(n_edges);
  zero_dead_rows(d_src, n_edges, n_rows, kIn);
  if ((int)blockIdx.x >= n_split) return;  // the whole block

  // the thread's parts of the weight gradients, summed over its tiles in
  // f32 (Prod's places), and of the bias gradients (column_part's)
  float run_wr[NL][1][Prod<kH, kH>::NI][4] = {};
  float run_wo[1][Prod<kH, kC>::NI][4] = {};
  float run_we[1][Prod<kCe, kH>::NI][4] = {};
  float run_br[NL] = {}, run_bo = 0.f, run_be = 0.f;

  int t_beg, t_end;
  tile128::block_tiles<kTE>(n_edges, &t_beg, &t_end, n_split);
  // tile `tile`'s input rows (e0, h0 or pe) into `dst`, one committed group
  auto stage = [&](int tile, float* dst) {
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    rows_async<kTE, kIn, kThreads>(dst, 0, src, [&](int e) {
      return e < n_valid ? src + (size_t)(base + e) * kIn : nullptr;
    });
    cp_async_commit();
  };
  if (t_beg < t_end) {
    if (warp < 2)
      tile128::tile_indices<kTE, GATHERS>(s_rcv, s_snd, senders, rowptr,
                                          n_nodes, n_edges, t_beg, -1);
    stage(t_beg, staged(0));
  }
  __syncthreads();  // the weights and the first tile's indices

  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    const int* rcv = s_rcv + cur * kTE;
    const int* snd = s_snd + cur * kTE;
    const bool more = tile + 1 < t_end;

    // h_0: fold, relu(e0 . W_e + z0) with z0 = b_e + pxj[s] + pxi[i]
    // loaded while the rows arrive; pregathered, relu(h0 + pxi[i]); pe,
    // relu((pe + pxj[s]) + pxi[i])
    {
      Prod<kTE, kH> p;
      if (FOLD)
        p.init([&](int e, int n) {
          return e < n_valid ? s_be[n] + __ldg(pxj + (size_t)snd[e] * kH + n) +
                                   __ldg(pxi + (size_t)rcv[e] * kH + n)
                             : 0.f;
        });
      cp_async_wait<0>();
      __syncthreads();  // the rows are in; the last tile is done
      if (more && warp < 2)
        tile128::tile_indices<kTE, GATHERS>(
            s_rcv + nxt * kTE, s_snd + nxt * kTE, senders, rowptr, n_nodes,
            n_edges, tile + 1, rcv[n_valid - 1]);
      if (FOLD) {
        if (more) stage(tile + 1, staged(nxt));  // read last by dW_e
        p.template run<kCe>(LdsmRows<kCe>{staged(cur)}, RowsB<kH>{s_we});
        p.template store<true>(plane(0));
      } else {
        for (int k = tid; k < kTE * kH / 4; k += kThreads) {
          const int e = k >> 4, c = (k & 15) * 4, o = swz_at<kH>(e, c);
          float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          if (e < n_valid) {
            float4 a = *reinterpret_cast<const float4*>(staged(0) + o);
            if (E == kPe) {
              const float4 j = __ldg(reinterpret_cast<const float4*>(
                  pxj + (size_t)snd[e] * kH + c));
              a = make_float4(a.x + j.x, a.y + j.y, a.z + j.z, a.w + j.w);
            }
            const float4 b = __ldg(
                reinterpret_cast<const float4*>(pxi + (size_t)rcv[e] * kH + c));
            z = make_float4(fmaxf(a.x + b.x, 0.f), fmaxf(a.y + b.y, 0.f),
                            fmaxf(a.z + b.z, 0.f), fmaxf(a.w + b.w, 0.f));
          }
          *reinterpret_cast<float4*>(plane(0) + o) = z;
        }
      }
    }
    __syncthreads();  // h_0 written; the h0 / pe staging tile is free
    if (!FOLD && more) stage(tile + 1, staged(0));

    // h_1 .. h_L1
#pragma unroll
    for (int k = 1; k <= L1; ++k) {
      Prod<kTE, kH> p;
      const float* b = s_br + (k - 1) * kH;
      p.init([&](int, int n) { return b[n]; });
      p.template run<kH>(LdsmRows<kH>{plane(k - 1)},
                         RowsB<kH>{s_wr + (k - 1) * kH * kH});
      p.template store<true>(plane(k));
      __syncthreads();
    }

    // y = h_L1 . W_out + b_out; g[i] for LayerNorm's backward, loaded
    // before the product so that its latency hides behind it
    float gv[kC / 8];
    {
      const int e = tid >> 3, q = tid & 7;
#pragma unroll
      for (int j = 0; j < kC / 8; ++j)
        gv[j] = e < n_valid ? __ldg(g + (size_t)rcv[e] * kC + q + 8 * j) : 0.f;
      Prod<kTE, kC> p;
      p.init([&](int, int c) { return s_bo[c]; });
      p.template run<kH>(LdsmRows<kH>{plane(L1)}, RowsB<kC>{s_wo});
      p.template store<false>(s_y);
    }
    __syncthreads();
    layer_norm_bwd(s_y, s_ls, gv, s_ln);  // dy over y
    __syncthreads();

    // the output layer: dW_out += h_L1^T . dy, db_out, and da_L1 = (dy .
    // W_out^T) where h_L1 > 0, into plane L1 + 1
    {
      Prod<kH, kC> w;
      w.template run<kTE>(ColsA<kH>{plane(L1)}, RowsB<kC>{s_y});
      w.add_to(run_wo);
      run_bo += column_part<kC>(s_y);
      Prod<kTE, kH> d;
      d.template run<kC>(LdsmRows<kC>{s_y}, LdsmCols<kC>{s_wo});
      d.template store<false>(plane(L1 + 1), plane(L1));
    }
    __syncthreads();

    // the tail layers, last to first: dW_k += h_{k-1}^T . da_k, db_k, and
    // da_{k-1} = (da_k . W_k^T) where h_{k-1} > 0, over h_k (plane k)
#pragma unroll
    for (int k = L1; k >= 1; --k) {
      Prod<kH, kH> w;
      w.template run<kTE>(ColsA<kH>{plane(k - 1)}, RowsB<kH>{plane(k + 1)});
      w.add_to(run_wr[k - 1]);
      run_br[k - 1] += column_part<kH>(plane(k + 1));
      Prod<kTE, kH> d;
      d.template run<kH>(LdsmRows<kH>{plane(k + 1)},
                         LdsmCols<kH>{s_wr + (k - 1) * kH * kH});
      d.template store<false>(plane(k), plane(k - 1));
      __syncthreads();
    }

    // dz = da_0, in plane 1: fold, dW_e += e0^T . dz, db_e, d_e0 = dz .
    // W_e^T and d_pxj[s] += dz; pregathered, d_h0 = dz; pe, d_pe = dz; then
    // d_pxi[i] += dz
    const float* dz = plane(1);
    if (FOLD) {
      Prod<kCe, kH> w;
      w.template run<kTE>(ColsA<kCe>{staged(cur)}, RowsB<kH>{dz});
      w.add_to(run_we);
      run_be += column_part<kH>(dz);
      Prod<kTE, kCe> d;
      d.template run<kH>(LdsmRows<kH>{dz}, LdsmCols<kH>{s_we});
      d.pairs([&](int e, int c, float v0, float v1) {
        if (e < n_valid)
          *reinterpret_cast<float2*>(d_src + (size_t)(base + e) * kCe + c) =
              make_float2(v0, v1);
      });
      for (int k = tid; k < n_valid * kH; k += kThreads) {
        const int e = k >> 6, n = k & (kH - 1);
        atomicAdd(d_pxj + (size_t)snd[e] * kH + n, dz[swz_at<kH>(e, n)]);
      }
    } else {
      for (int k = tid; k < n_valid * kH / 4; k += kThreads) {
        const int e = k >> 4, c = (k & 15) * 4;
        *reinterpret_cast<float4*>(d_src + (size_t)(base + e) * kH + c) =
            *reinterpret_cast<const float4*>(dz + swz_at<kH>(e, c));
      }
    }
    {
      constexpr int kPart = kTE * kH / kThreads;  // edges of an eighth
      const int n = tid & (kH - 1);
      const int e_beg = (tid / kH) * kPart;
      const int e_end = min(e_beg + kPart, n_valid);
      if (e_beg < e_end) {
        int at = rcv[e_beg];
        float s = 0.f;
        for (int e = e_beg; e < e_end; ++e) {
          if (rcv[e] != at) {
            atomicAdd(d_pxi + (size_t)at * kH + n, s);
            s = 0.f;
            at = rcv[e];
          }
          s += dz[swz_at<kH>(e, n)];
        }
        atomicAdd(d_pxi + (size_t)at * kH + n, s);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every plane is free: the bias parts go through plane 0

  // this block's partial gradients, in the packed layout
  float* p = partial + (size_t)blockIdx.x * L::g_total;
  float* sums = plane(0);  // one row of kThreads parts a bias gradient
#pragma unroll
  for (int k = 0; k < L1; ++k) {
    Prod<kH, kH>().write(p + L::g_wr + k * kH * kH, run_wr[k]);
    sums[k * kThreads + tid] = run_br[k];
  }
  Prod<kH, kC>().write(p + L::g_wo, run_wo);
  sums[L1 * kThreads + tid] = run_bo;
  if (FOLD) {
    Prod<kCe, kH>().write(p + L::g_we, run_we);
    sums[(L1 + 1) * kThreads + tid] = run_be;
  }
  __syncthreads();
  if (tid < L1 * kH) {
    p[L::g_br + tid] =
        column_total<kH>(sums + (tid / kH) * kThreads, tid % kH);
  } else if (tid < L1 * kH + kC) {
    p[L::g_bo + tid - L1 * kH] =
        column_total<kC>(sums + L1 * kThreads, tid - L1 * kH);
  } else if (tid < L1 * kH + 3 * kC) {  // d_ln_s, then d_ln_b
    const int c = tid - L1 * kH - kC;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += s_ln[w * 2 * kC + c];
    p[L::g_ls + c] = s;
  } else if (FOLD && tid < L1 * kH + 3 * kC + kH) {
    const int c = tid - L1 * kH - 3 * kC;
    p[L::g_be + c] = column_total<kH>(sums + (L1 + 1) * kThreads, c);
  }
}

// The persistent grid's cap (SMs x resident blocks per SM) on the current
// device.  The shared-memory opt-in and the device queries run once per
// device and instantiation; later launches read the cache.
template <int L1, Entry E>
cudaError_t grid_cap(size_t smem_bytes, int* cap) {
  static std::atomic<int> cache[kMaxDevices];  // 0: unset
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && (*cap = cache[device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  auto kernel = edge_tail_bwd_kernel<L1, E>;
  int optin = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return err;
  if (smem_bytes > (size_t)optin) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem_bytes)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem_bytes)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *cap = n_sm * per_sm;
  if (cached) cache[device].store(*cap, std::memory_order_relaxed);
  return cudaSuccess;
}

template <int L1, Entry E>
size_t smem_bytes() {
  return sizeof(float) * (size_t)Layout<L1, E>::floats;
}

// The kernel on a persistent grid of at most scratch_blocks blocks, each a
// run of consecutive tiles of the live edges (TileBlocks: every block that
// holds a partial at least one tile), then the fixed-order sum of those
// blocks' partials.  The grid is sized for all n_rows rows, and so holds
// the live edges' split whatever their count.
template <int L1, Entry E>
int launch(const float* src, const float* we, const float* be,
           const float* pxj, const float* pxi, const int* senders,
           const int* rowptr, const float* w_rest, const float* b_rest,
           const float* w_out, const float* b_out, const float* ln_s,
           const float* g, float* d_src, float* d_pxj, float* d_pxi,
           float* wgrad, float* partial, int n_nodes, int n_rows,
           int scratch_blocks, cudaStream_t stream) {
  using L = Layout<L1, E>;
  const size_t smem = smem_bytes<L1, E>();
  int cap = 0;
  const cudaError_t err = grid_cap<L1, E>(smem, &cap);
  if (err != cudaSuccess) return (int)err;
  if (cap > scratch_blocks) cap = scratch_blocks;
  const int n_tiles = n_nodes > 0 ? (n_rows + kTE - 1) / kTE : 0;
  if (n_tiles > 0 && cap < 1) return (int)cudaErrorInvalidValue;
  const int blocks = n_tiles < cap ? n_tiles : cap;
  if (blocks > 0) {
    edge_tail_bwd_kernel<L1, E><<<blocks, kThreads, smem, stream>>>(
        src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
        ln_s, g, d_src, d_pxj, d_pxi, partial, n_nodes, n_rows, cap);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return (int)launched;
  }
  reduce_partials_kernel<<<(L::g_total + 255) / 256, 256, 0, stream>>>(
      partial, wgrad, rowptr, n_nodes, n_tiles > 0 ? n_rows : 0,
      TileBlocks{cap > 0 ? cap : 1}, L::g_total);
  return (int)cudaGetLastError();
}

}  // namespace w64

namespace w128 {

using tile128::Entry;
using tile128::kFold;
using tile128::kPe;
using tile128::kPregathered;
using tile128::kW;
constexpr int kThreads = 256;  // 8 warps
constexpr int kTE = 32;        // edges per tile of a pass
constexpr int kLd = kW + 4;    // shared row stride of an edge tile, floats
constexpr int kLdT = kW + 8;   // the same, for tiles read down their columns
constexpr int kTile = kTE * kLd;

// The passes of kernel (a), each one product of one layer over every edge.
enum Pass : int {
  kFirst,      // h_0 = relu(e0 . W_e + b_e + pxj[s] + pxi[r])      (fold)
  kForward,    // h_k = relu(h_{k-1} . W_k + b_k)
  kOutput,     // y = h_L1 . W_out + b_out, then dy (LayerNorm backward)
  kBack,       // da_{k-1} = (da_k . W_k^T) where h_{k-1} > 0
  kBackPlain,  // d_e0 = dz . W_e^T                                 (fold)
};

struct PassArgs {
  const float* x;     // (E, kW) the product's input rows
  const float* w;     // (kW, kW) the weight, (in, out)
  const float* bias;  // (kW) kFirst, kForward, kOutput
  const float* mask;  // (E, kW) kBack: the output is kept where mask > 0
  float* out;         // (E, kW)
  const float* pxj;   // kFirst
  const float* pxi;   // kFirst
  const int* senders;  // kFirst
  const int* rowptr;   // the live edges; kFirst, kOutput: the receivers
  const float* g;      // kOutput: (N, kW) the output's cotangent
  const float* ln_s;   // kOutput
  float* ln_part;      // kOutput: block b writes its d_ln_s, d_ln_b sums
                       // (2 kW floats) at ln_part + b * 2 kW
  bool zero_dead;      // out's rows past the live edges set to zero
  int n_nodes, n_rows;
};

// the weight's row stride: forward passes read W[k][n] down the rows of k,
// backward passes W[n][k] along them; each stride keeps its reads free of
// bank conflicts
template <Pass P>
__host__ __device__ constexpr int weight_ld() {
  return P == kBack || P == kBackPlain ? kLd : kLdT;
}

// shared memory: the weight (68-70 KB), two input tiles and the tile's
// indices: 103 KB, so that two blocks share an SM
template <Pass P>
__host__ __device__ constexpr int pass_smem_floats() {
  return kW * weight_ld<P>() + 2 * kTile + 2 * kTE;
}

// One pass: a persistent block keeps the layer's weight in shared memory
// for the whole launch and walks 32-edge tiles of the live edges, strided
// over as many blocks as the launch would take for them alone
// (StridedBlocks), each tile's input rows fetched with cp.async into a
// second buffer while the previous tile computes; the product is a tf32x3
// 32 x 128 tile (a warp owns 16 columns), split as its fragments are
// loaded.  A block past that stride takes no tile (kOutput: its d_ln_s,
// d_ln_b row is not summed).
template <Pass P>
__global__ void __launch_bounds__(kThreads, 2) edge_pass_kernel(PassArgs a) {
  using namespace tf32x3;
  constexpr bool kBwd = P == kBack || P == kBackPlain;
  constexpr int ldw = weight_ld<P>();
  extern __shared__ __align__(16) float w128_smem[];
  float* s_w = w128_smem;
  float* s_x = s_w + kW * ldw;   // two tiles (kOutput: then y, xhat)
  int* s_snd = reinterpret_cast<int*>(s_x + 2 * kTile);
  int* s_rcv = s_snd + kTE;
  const int tid = threadIdx.x, warp = tid >> 5;
  const Raw w_op = kBwd ? Raw{s_w, 1, ldw} : Raw{s_w, ldw, 1};  // W^T or W
  const int n_edges = tile128::live_edges(a.rowptr, a.n_nodes, a.n_rows);

  for (int k = tid; k < kW * kW / 4; k += kThreads)
    *reinterpret_cast<float4*>(s_w + (k >> 5) * ldw + (k & 31) * 4) =
        __ldg(reinterpret_cast<const float4*>(a.w) + k);

  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int stride = StridedBlocks{(int)gridDim.x}(n_edges);
  auto prefetch = [&](int tile, int buf) {
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    rows_async<kTE>(s_x + buf * kTile, kLd, a.x, [&](int r) {
      return r < n_valid ? a.x + (size_t)(base + r) * kW : nullptr;
    });
    cp_async_commit();
  };
  float acc_ln = 0.f;  // kOutput: tid < kW d_ln_s[tid], else d_ln_b[tid - kW]
  if (a.zero_dead) zero_dead_rows(a.out, n_edges, a.n_rows, kW);

  if ((int)blockIdx.x < n_tiles) prefetch(blockIdx.x, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += stride, ++it) {
    const int cur = it & 1;
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    const float* x = s_x + cur * kTile;
    if (tile + stride < n_tiles)
      prefetch(tile + stride, cur ^ 1);
    else
      cp_async_commit();  // an empty group keeps the count
    if ((P == kFirst || P == kOutput) && warp == 0) {
      const int rv =
          tile128::warp_receiver(a.rowptr, a.n_nodes, base, n_valid);
      const bool valid = tid < n_valid;
      s_snd[tid] = P == kFirst && valid ? a.senders[base + tid] : 0;
      s_rcv[tid] = valid ? rv : 0;
    }
    cp_async_wait<1>();
    __syncthreads();

    // what the epilogue reads from device memory, loaded before the product
    // so that the loads' latency hides behind it: the bias and, kFirst, the
    // gathered node rows, added after the product; kBack, the mask
    float pre[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = acc_row(16 * mi, c);
          const int n = acc_col(16 * warp + 8 * ni, c);
          float v = 0.f;
          if (P == kFirst && e < n_valid)
            v = __ldg(a.bias + n) + __ldg(a.pxj + (size_t)s_snd[e] * kW + n) +
                __ldg(a.pxi + (size_t)s_rcv[e] * kW + n);
          else if (P == kForward || P == kOutput)
            v = __ldg(a.bias + n);
          else if (P == kBack && e < n_valid)
            v = __ldg(a.mask + (size_t)(base + e) * kW + n);
          pre[mi][ni][c] = v;
        }
    float acc[2][2][4] = {};
    mm_rows32<kW>(acc, Raw{x, kLd, 1}, w_op);
    if (P == kFirst || P == kForward || P == kOutput)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] += pre[mi][ni][c];

    if (P != kOutput) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // elements 2h, 2h + 1: one row
            const int e = acc_row(16 * mi, 2 * h);
            if (e >= n_valid) continue;
            const size_t o =
                (size_t)(base + e) * kW + acc_col(16 * warp + 8 * ni, 0);
            float2 v = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
            if (P == kFirst || P == kForward) {
              v.x = fmaxf(v.x, 0.f);
              v.y = fmaxf(v.y, 0.f);
            } else if (P == kBack) {
              v.x = pre[mi][ni][2 * h] > 0.f ? v.x : 0.f;
              v.y = pre[mi][ni][2 * h + 1] > 0.f ? v.y : 0.f;
            }
            *reinterpret_cast<float2*>(a.out + o) = v;
          }
    } else {
      // y over the input tile, once every warp has read it
      float* s_y = s_x + cur * kTile;
      __syncthreads();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s_y[acc_row(16 * mi, c) * kLd + acc_col(16 * warp + 8 * ni, c)] =
                acc[mi][ni][c];
      __syncthreads();
      // LayerNorm backward, eight threads per edge: the row's mean and rstd,
      // xhat over y in place, and
      // dy = rstd * (dx - mean(dx) - xhat * mean(dx * xhat)), dx = g * ln_s
      constexpr int CP = kW / 8;
      const int le = tid >> 3, c0 = (tid & 7) * CP;
      const bool valid = le < n_valid;
      const float* gp = a.g + (size_t)s_rcv[le] * kW + c0;
      float v[CP], gv[CP];
      float mu = 0.f, m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        v[c] = s_y[le * kLd + c0 + c];
        gv[c] = valid ? __ldg(gp + c) : 0.f;
        mu += v[c];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mu += __shfl_xor_sync(0xffffffffu, mu, o);
      mu *= 1.f / kW;
      float var = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const float d = v[c] - mu;
        var = fmaf(d, d, var);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        var += __shfl_xor_sync(0xffffffffu, var, o);
      var *= 1.f / kW;
      const float rstd = rsqrtf(var + kLnEps);
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        v[c] = (v[c] - mu) * rstd;  // xhat
        s_y[le * kLd + c0 + c] = v[c];
        const float dx = gv[c] * __ldg(a.ln_s + c0 + c);
        m1 += dx;
        m2 = fmaf(dx, v[c], m2);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        m1 += __shfl_xor_sync(0xffffffffu, m1, o);
        m2 += __shfl_xor_sync(0xffffffffu, m2, o);
      }
      m1 *= 1.f / kW;
      m2 *= 1.f / kW;
      if (valid) {
        float* dy = a.out + (size_t)(base + le) * kW + c0;
#pragma unroll
        for (int c = 0; c < CP; c += 4) {
          float4 d;
          d.x = rstd * (gv[c] * __ldg(a.ln_s + c0 + c) - m1 - v[c] * m2);
          d.y = rstd * (gv[c + 1] * __ldg(a.ln_s + c0 + c + 1) - m1 -
                        v[c + 1] * m2);
          d.z = rstd * (gv[c + 2] * __ldg(a.ln_s + c0 + c + 2) - m1 -
                        v[c + 2] * m2);
          d.w = rstd * (gv[c + 3] * __ldg(a.ln_s + c0 + c + 3) - m1 -
                        v[c + 3] * m2);
          *reinterpret_cast<float4*>(dy + c) = d;
        }
      }
      __syncthreads();  // xhat written
      // d_ln_s, d_ln_b: column sums over the tile's edges, one thread each
      const int c = tid & (kW - 1);
      float s = 0.f;
      for (int e = 0; e < n_valid; ++e) {
        const float ge = __ldg(a.g + (size_t)s_rcv[e] * kW + c);
        s += tid < kW ? ge * s_y[e * kLd + c] : ge;
      }
      acc_ln += s;
    }
    __syncthreads();  // before the next prefetch overwrites this tile
  }
  cp_async_wait<0>();
  if (P == kOutput) a.ln_part[(size_t)blockIdx.x * 2 * kW + tid] = acc_ln;
}

// h_0 = relu(src[e] + pxi[r]), plus pxj[s] for the pe entry: the
// pregathered and pe entries' first layer, one warp per edge.
template <Entry E>
__global__ void __launch_bounds__(kThreads) first_input_kernel(
    const float* __restrict__ src, const float* __restrict__ pxj,
    const float* __restrict__ pxi, const int* __restrict__ senders,
    const int* __restrict__ rowptr, float* __restrict__ h0, int n_nodes,
    int n_rows) {
  const int lane = threadIdx.x & 31;
  const int n_edges = tile128::live_edges(rowptr, n_nodes, n_rows);
  for (int e = (blockIdx.x * kThreads + threadIdx.x) >> 5; e < n_edges;
       e += (gridDim.x * kThreads) >> 5) {
    const int r = tile128::receiver_of(rowptr, n_nodes, e);
    float4 z = __ldg(reinterpret_cast<const float4*>(src + (size_t)e * kW) + lane);
    const float4 q =
        __ldg(reinterpret_cast<const float4*>(pxi + (size_t)r * kW) + lane);
    z.x += q.x;
    z.y += q.y;
    z.z += q.z;
    z.w += q.w;
    if (E == kPe) {
      const float4 p = __ldg(
          reinterpret_cast<const float4*>(pxj + (size_t)senders[e] * kW) + lane);
      z.x += p.x;
      z.y += p.y;
      z.z += p.z;
      z.w += p.w;
    }
    z.x = fmaxf(z.x, 0.f);
    z.y = fmaxf(z.y, 0.f);
    z.z = fmaxf(z.z, 0.f);
    z.w = fmaxf(z.w, 0.f);
    reinterpret_cast<float4*>(h0 + (size_t)e * kW)[lane] = z;
  }
}

// d_pxi[r] += dz over the receivers (one atomicAdd per run of equal
// receivers in each half of a 32-edge tile) and, fold, d_pxj[s] += dz with
// one atomicAdd per element.
template <bool FOLD>
__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const float* __restrict__ dz, const int* __restrict__ senders,
    const int* __restrict__ rowptr, float* __restrict__ d_pxj,
    float* __restrict__ d_pxi, int n_nodes, int n_rows) {
  __shared__ int s_snd[kTE], s_rcv[kTE];
  const int tid = threadIdx.x, n = tid & (kW - 1);
  const int n_edges = tile128::live_edges(rowptr, n_nodes, n_rows);
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    if (tid < kTE) {  // warp 0
      const int rv = tile128::warp_receiver(rowptr, n_nodes, base, n_valid);
      if (tid < n_valid) {
        s_snd[tid] = FOLD ? senders[base + tid] : 0;
        s_rcv[tid] = rv;
      }
    }
    __syncthreads();
    constexpr int kHalf = kTE / 2;
    const int e_beg = (tid >> 7) * kHalf;
    const int e_end = min(e_beg + kHalf, n_valid);
    if (e_beg < e_end) {
      int at = s_rcv[e_beg];
      float s = 0.f;
      for (int e = e_beg; e < e_end; ++e) {
        const float v = __ldg(dz + (size_t)(base + e) * kW + n);
        if (FOLD) atomicAdd(d_pxj + (size_t)s_snd[e] * kW + n, v);
        if (s_rcv[e] != at) {
          atomicAdd(d_pxi + (size_t)at * kW + n, s);
          s = 0.f;
          at = s_rcv[e];
        }
        s += v;
      }
      atomicAdd(d_pxi + (size_t)at * kW + n, s);
    }
    __syncthreads();
  }
}

// The packed weight-gradient layout, in floats; d_ln_s and d_ln_b follow
// at ls.
struct Packed {
  int we, be, wr, br, wo, bo, ls;
  __host__ __device__ Packed(bool fold, int l1) {
    we = 0;
    be = we + (fold ? kW * kW : 0);
    wr = be + (fold ? kW : 0);
    br = wr + l1 * kW * kW;
    wo = br + l1 * kW;
    bo = wo + kW * kW;
    ls = bo + kW;
  }
};

constexpr int kMaxPairs = 5;  // W_e, three tail weights, W_out

// Kernel (b): dW = sum_e A[e]^T D[e] and db = sum_e D[e] for each weight
// (blockIdx.y) over one range of the live edges (blockIdx.x; RangeBlocks:
// the ranges the launch would take for the live edges alone, a block past
// them exits whole); the block writes its partial at partial + blockIdx.x
// * stride + off_w / off_b.
struct WgradArgs {
  const float* a[kMaxPairs];  // (E, kW) the layer's input rows
  const float* d[kMaxPairs];  // (E, kW) its output's gradient rows
  int off_w[kMaxPairs], off_b[kMaxPairs];
  float* partial;
  const int* rowptr;
  int stride, want, n_nodes, n_rows;
};

constexpr int kSlab = 32;  // edges per slab of kernel (b)
constexpr int kSlabTile = kSlab * kLdT;

// A 128 x 128 tf32x3 product over each 32-edge slab, both slabs read down
// their columns (hence the kLdT stride), split as fragments are loaded; 64
// f32 accumulators a thread over the block's whole edge range; slabs
// double-buffered with cp.async (70 KB: two blocks share an SM).
__global__ void __launch_bounds__(kThreads, 1) wgrad_kernel(WgradArgs args) {
  using namespace tf32x3;
  extern __shared__ __align__(16) float w128_smem[];
  float* s_a = w128_smem;                  // two slabs
  float* s_d = w128_smem + 2 * kSlabTile;  // two slabs
  __shared__ float s_bsum[kW];
  const int tid = threadIdx.x, warp = tid >> 5, pair = blockIdx.y;
  const float* A = args.a[pair];
  const float* D = args.d[pair];
  const int n_edges =
      tile128::live_edges(args.rowptr, args.n_nodes, args.n_rows);
  const RangeBlocks ranges{args.want};
  if ((int)blockIdx.x >= ranges(n_edges)) return;  // the whole block
  const int e_beg = blockIdx.x * ranges.chunk(n_edges);
  const int e_end = min(n_edges, e_beg + ranges.chunk(n_edges));
  const int n_slabs = e_end > e_beg ? (e_end - e_beg + kSlab - 1) / kSlab : 0;
  auto prefetch = [&](int slab, int buf) {
    const int base = e_beg + slab * kSlab;
    rows_async<kSlab>(s_a + buf * kSlabTile, kLdT, A, [&](int r) {
      return base + r < e_end ? A + (size_t)(base + r) * kW : nullptr;
    });
    rows_async<kSlab>(s_d + buf * kSlabTile, kLdT, D, [&](int r) {
      return base + r < e_end ? D + (size_t)(base + r) * kW : nullptr;
    });
    cp_async_commit();
  };
  float acc[2][8][4] = {};
  float bsum = 0.f;  // column tid & 127 over rows (tid >> 7) * 16 .. + 15
  if (n_slabs > 0) prefetch(0, 0);
  for (int slab = 0; slab < n_slabs; ++slab) {
    const int cur = slab & 1;
    if (slab + 1 < n_slabs)
      prefetch(slab + 1, cur ^ 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* a = s_a + cur * kSlabTile;
    const float* d = s_d + cur * kSlabTile;
    mm_square128<kSlab>(acc, Raw{a, 1, kLdT}, Raw{d, kLdT, 1});  // A^T . D
    for (int e = (tid >> 7) * 16; e < (tid >> 7) * 16 + 16; ++e)
      bsum += d[e * kLdT + (tid & (kW - 1))];
    __syncthreads();  // before the next prefetch overwrites this slab
  }
  cp_async_wait<0>();
  float* p = args.partial + (size_t)blockIdx.x * args.stride;
  float* pw = p + args.off_w[pair];
  const int m0 = 32 * (warp & 3), n0 = 64 * (warp >> 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        pw[acc_row(m0 + 16 * mi, c) * kW + acc_col(n0 + 8 * ni, c)] =
            acc[mi][ni][c];
  if (tid >= kW) s_bsum[tid - kW] = bsum;
  __syncthreads();
  if (tid < kW) p[args.off_b[pair] + tid] = bsum + s_bsum[tid];
}

// Resident blocks of `kernel` per SM and the SM count on the current device
// at `smem` bytes of dynamic shared memory; the opt-in and the queries run
// once per device and kernel.
template <auto Kernel>
cudaError_t resident(size_t smem, int* per_sm, int* n_sm) {
  static std::atomic<int> cache[kMaxDevices];  // per_sm << 16 | n_sm; 0 unset
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int v = device < kMaxDevices ? cache[device].load(std::memory_order_relaxed)
                               : 0;
  if (v == 0) {
    int sms = 0, blocks = 0;
    if ((err = cudaFuncSetAttribute(Kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, Kernel, kThreads, smem)) != cudaSuccess)
      return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    v = blocks << 16 | sms;
    if (device < kMaxDevices) cache[device].store(v, std::memory_order_relaxed);
  }
  *per_sm = v >> 16;
  *n_sm = v & 0xffff;
  return cudaSuccess;
}

// One pass over every edge on a persistent grid of at most `max_blocks`
// blocks (0: as many as are resident), sized for all a.n_rows rows;
// returns the blocks launched.
template <Pass P>
cudaError_t run_pass(const PassArgs& a, int max_blocks, cudaStream_t stream,
                     int* launched = nullptr) {
  const size_t smem = sizeof(float) * (size_t)pass_smem_floats<P>();
  int per_sm = 0, n_sm = 0;
  cudaError_t err = resident<edge_pass_kernel<P>>(smem, &per_sm, &n_sm);
  if (err != cudaSuccess) return err;
  const int n_tiles = (a.n_rows + kTE - 1) / kTE;
  int blocks = per_sm * n_sm;
  if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
  if (blocks > n_tiles) blocks = n_tiles;
  if (launched) *launched = blocks;
  if (blocks == 0) return cudaSuccess;
  edge_pass_kernel<P><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The backward as one launch sequence: kernel (a) as 2 L1 + 4 passes
// (pregathered, pe: an elementwise first layer and 2 L1 + 2 passes) that
// recompute h_0..h_L1, run LayerNorm's backward and the data gradients down
// to dz, each h_k and each layer's output gradient written to `scratch`;
// the scatter of dz; kernel (b) for every weight gradient; the fixed-order
// sums of the block partials.  Every grid is sized for the n_rows rows;
// every kernel walks the live edges (tile128::live_edges) and splits them
// as it would split them alone, so a padded graph's dead rows change no
// sum; the pass that writes d_src zeroes its dead rows.
template <Entry E>
int launch(const float* src, const float* we, const float* be,
           const float* pxj, const float* pxi, const int* senders,
           const int* rowptr, const float* w_rest, const float* b_rest,
           const float* w_out, const float* b_out, const float* ln_s,
           const float* g, float* d_src, float* d_pxj, float* d_pxi,
           float* wgrad_out, float* partial, float* scratch, int n_nodes,
           int n_rows, int l1, int scratch_blocks, cudaStream_t stream) {
  constexpr bool FOLD = E == kFold;
  const Packed L(FOLD, l1);
  const size_t plane = (size_t)n_rows * kW;
  if (n_nodes == 0) n_rows = 0;
  // act[k] = h_k, k = 0..L1; grad[k] = da_k (grad[0] = dz, grad[L1 + 1] =
  // dy); the pregathered and pe entries' dz is their d_src
  float* act[4];
  float* grad[5];
  for (int k = 0; k <= l1; ++k) act[k] = scratch + k * plane;
  float* next = scratch + (l1 + 1) * plane;
  for (int k = 0; k <= l1 + 1; ++k) {
    if (k == 0 && !FOLD) {
      grad[0] = d_src;
      continue;
    }
    grad[k] = next;
    next += plane;
  }
  const float* w_of[5];  // w_of[k]: the weight whose output gradient is grad[k]
  const float* b_of[5];
  w_of[0] = we;
  b_of[0] = be;
  for (int k = 1; k <= l1; ++k) {
    w_of[k] = w_rest + (size_t)(k - 1) * kW * kW;
    b_of[k] = b_rest + (size_t)(k - 1) * kW;
  }
  w_of[l1 + 1] = w_out;
  b_of[l1 + 1] = b_out;

  PassArgs a{};
  a.pxj = pxj;
  a.pxi = pxi;
  a.senders = senders;
  a.rowptr = rowptr;
  a.g = g;
  a.ln_s = ln_s;
  // the LN pass's block partials follow the planes in the scratch
  float* ln_part = next;
  a.ln_part = ln_part;
  a.n_nodes = n_nodes;
  a.n_rows = n_rows;
  cudaError_t err = cudaSuccess;
  int ln_blocks = 0;
  if (n_rows > 0) {
    // recompute h_0
    if (FOLD) {
      a.x = src;
      a.w = we;
      a.bias = be;
      a.out = act[0];
      if ((err = run_pass<kFirst>(a, 0, stream)) != cudaSuccess)
        return (int)err;
    } else {
      int per_sm = 0, n_sm = 0;
      if ((err = resident<first_input_kernel<E>>(0, &per_sm, &n_sm)) !=
          cudaSuccess)
        return (int)err;
      first_input_kernel<E><<<per_sm * n_sm, kThreads, 0, stream>>>(
          src, pxj, pxi, senders, rowptr, act[0], n_nodes, n_rows);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    // h_1..h_L1
    for (int k = 1; k <= l1; ++k) {
      a.x = act[k - 1];
      a.w = w_of[k];
      a.bias = b_of[k];
      a.out = act[k];
      if ((err = run_pass<kForward>(a, 0, stream)) != cudaSuccess)
        return (int)err;
    }
    // y, then dy and the blocks' d_ln_s, d_ln_b (one partial row a block)
    a.x = act[l1];
    a.w = w_out;
    a.bias = b_out;
    a.out = grad[l1 + 1];
    if ((err = run_pass<kOutput>(a, 2 * scratch_blocks, stream,
                                 &ln_blocks)) !=
        cudaSuccess)
      return (int)err;
    // da_L1 .. da_0 = dz (pregathered, pe: d_src)
    for (int k = l1 + 1; k >= 1; --k) {
      a.x = grad[k];
      a.w = w_of[k];
      a.mask = act[k - 1];
      a.out = grad[k - 1];
      a.zero_dead = !FOLD && k == 1;
      if ((err = run_pass<kBack>(a, 0, stream)) != cudaSuccess)
        return (int)err;
    }
    if (FOLD) {  // d_e0 = dz . W_e^T
      a.x = grad[0];
      a.w = we;
      a.out = d_src;
      a.zero_dead = true;
      if ((err = run_pass<kBackPlain>(a, 0, stream)) != cudaSuccess)
        return (int)err;
    }
    int per_sm = 0, n_sm = 0;
    if ((err = resident<scatter_kernel<FOLD>>(0, &per_sm, &n_sm)) !=
        cudaSuccess)
      return (int)err;
    const int n_tiles = (n_rows + kTE - 1) / kTE;
    const int sblocks = n_tiles < per_sm * n_sm ? n_tiles : per_sm * n_sm;
    scatter_kernel<FOLD><<<sblocks, kThreads, 0, stream>>>(
        grad[0], senders, rowptr, d_pxj, d_pxi, n_nodes, n_rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  // kernel (b): one partial row per edge range, as many ranges as fill the
  // card once (at most scratch_blocks rows); a grid of RangeBlocks' most
  WgradArgs wa{};
  int pairs = 0;
  for (int k = FOLD ? 0 : 1; k <= l1 + 1; ++k, ++pairs) {
    wa.a[pairs] = k == 0 ? src : act[k - 1];
    wa.d[pairs] = grad[k];
    wa.off_w[pairs] = k == 0 ? L.we : k <= l1 ? L.wr + (k - 1) * kW * kW : L.wo;
    wa.off_b[pairs] = k == 0 ? L.be : k <= l1 ? L.br + (k - 1) * kW : L.bo;
  }
  RangeBlocks ranges{1};
  if (n_rows > 0) {
    const size_t smem = sizeof(float) * 4 * (size_t)kSlabTile;
    int per_sm = 0, n_sm = 0;
    if ((err = resident<wgrad_kernel>(smem, &per_sm, &n_sm)) != cudaSuccess)
      return (int)err;
    int want = per_sm * n_sm / pairs;
    if (want > scratch_blocks) want = scratch_blocks;
    if (want < 1) want = 1;
    ranges.want = want;
    const int n_slabs = (n_rows + kSlab - 1) / kSlab;
    wa.partial = partial;
    wa.rowptr = rowptr;
    wa.stride = L.ls;
    wa.want = want;
    wa.n_nodes = n_nodes;
    wa.n_rows = n_rows;
    wgrad_kernel<<<dim3(n_slabs < want ? n_slabs : want, pairs), kThreads,
                   smem, stream>>>(wa);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  reduce_partials_kernel<<<(L.ls + 255) / 256, 256, 0, stream>>>(
      partial, wgrad_out, rowptr, n_nodes, n_rows, ranges, L.ls);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<1, 2 * kW, 0, stream>>>(
      ln_part, wgrad_out + L.ls, rowptr, n_nodes, n_rows,
      StridedBlocks{ln_blocks}, 2 * kW);
  return (int)cudaGetLastError();
}

}  // namespace w128

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success.  Launches on `stream` and does not
// synchronise.  entry (an Entry): kFold, src is e0 (n_edges, ce) and d_src
// its gradient, and we, be, pxj, senders and d_pxj are used; kPregathered,
// src is h0 (n_edges, h) and d_src its gradient, and those five are
// ignored (they may be null); kPe, src is pe (n_edges, h) and d_src its
// gradient, pxj and senders are read, we, be and d_pxj ignored.  d_pxj and
// d_pxi must arrive zeroed; wgrad holds, packed, dW_e (ce, h) and db_e (h)
// (fold only), dW_rest (l1, h, h), db_rest (l1, h), dW_out (h, c), db_out
// (c), d_ln_s (c), d_ln_b (c); partial is scratch for scratch_blocks x
// that many floats; scratch (width 128 only, else ignored) holds
// (2 l1 + 3) (fold) or (2 l1 + 2) planes of n_edges x 128 floats, then
// 2 scratch_blocks rows of 256.  Every float array is 16-byte aligned.
// The compiled builds are those of the header, each for
// l1 in 0..3; others return cudaErrorInvalidValue.
int fused_edge_tail_agg_bwd_f32(
    const float* src, const float* we, const float* be, const float* pxj,
    const float* pxi, const int* senders, const int* rowptr,
    const float* w_rest, const float* b_rest, const float* w_out,
    const float* b_out, const float* ln_s, const float* g, float* d_src,
    float* d_pxj, float* d_pxi, float* wgrad, float* partial, float* scratch,
    int n_nodes, int n_edges, int ce, int h, int c, int l1, int entry,
    int scratch_blocks, void* stream) {
  using tile128::kFold;
  using tile128::kPe;
  using tile128::kPregathered;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = h == 64 && c == 32, wide = h == 128 && c == 128;
  const bool gathers = pxj != nullptr && senders != nullptr;
  if (l1 < 0 || l1 > 3) return (int)cudaErrorInvalidValue;
  if (entry == kFold &&
      (!gathers || we == nullptr || be == nullptr || d_pxj == nullptr))
    return (int)cudaErrorInvalidValue;
  if (entry == kPe && !gathers) return (int)cudaErrorInvalidValue;
  if (wide && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (entry == kFold && ce == 128 && wide)
    return w128::launch<kFold>(src, we, be, pxj, pxi, senders, rowptr, w_rest,
                               b_rest, w_out, b_out, ln_s, g, d_src, d_pxj,
                               d_pxi, wgrad, partial, scratch, n_nodes, n_edges,
                               l1, scratch_blocks, s);
  if (entry == kPregathered && wide)
    return w128::launch<kPregathered>(
        src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
        ln_s, g, d_src, d_pxj, d_pxi, wgrad, partial, scratch, n_nodes, n_edges,
        l1, scratch_blocks, s);
  if (entry == kPe && wide)
    return w128::launch<kPe>(src, we, be, pxj, pxi, senders, rowptr, w_rest,
                             b_rest, w_out, b_out, ln_s, g, d_src, d_pxj,
                             d_pxi, wgrad, partial, scratch, n_nodes, n_edges,
                             l1, scratch_blocks, s);
  if (!narrow || (entry == kFold ? ce != 32
                                  : entry != kPregathered && entry != kPe))
    return (int)cudaErrorInvalidValue;
#define MAGNET_BWD_ENTRY(L1V, E)                                             \
  w64::launch<L1V, E>(src, we, be, pxj, pxi, senders, rowptr, w_rest,        \
                      b_rest, w_out, b_out, ln_s, g, d_src, d_pxj, d_pxi,    \
                      wgrad, partial, n_nodes, n_edges, scratch_blocks, s)
#define MAGNET_BWD_CASE(L1V)                                                 \
  case L1V:                                                                  \
    return entry == kFold  ? MAGNET_BWD_ENTRY(L1V, kFold)                    \
           : entry == kPe ? MAGNET_BWD_ENTRY(L1V, kPe)                       \
                          : MAGNET_BWD_ENTRY(L1V, kPregathered)
  switch (l1) {
    MAGNET_BWD_CASE(0);
    MAGNET_BWD_CASE(1);
    MAGNET_BWD_CASE(2);
    MAGNET_BWD_CASE(3);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MAGNET_BWD_CASE
#undef MAGNET_BWD_ENTRY
}

// Bytes of dynamic shared memory a block of the width-64 backward takes for
// entry kFold, kPregathered or kPe at l1 in 0..3; -1 for any other build.
int fused_edge_tail_agg_bwd_w64_smem(int entry, int l1) {
  using tile128::kFold;
  using tile128::kPe;
  using tile128::kPregathered;
  if (entry != kFold && entry != kPregathered && entry != kPe) return -1;
#define MAGNET_SMEM_CASE(L1V)                                          \
  case L1V:                                                            \
    return (int)(entry == kFold  ? w64::smem_bytes<L1V, kFold>()       \
                 : entry == kPe ? w64::smem_bytes<L1V, kPe>()          \
                                : w64::smem_bytes<L1V, kPregathered>())
  switch (l1) {
    MAGNET_SMEM_CASE(0);
    MAGNET_SMEM_CASE(1);
    MAGNET_SMEM_CASE(2);
    MAGNET_SMEM_CASE(3);
    default:
      return -1;
  }
#undef MAGNET_SMEM_CASE
}

}  // extern "C"
