// Fused InteractionNetwork edge pipeline, bf16 operands, width 128, in
// three entries: fold at (Ce, H, C) = (128, 128, 128), pe and pregathered
// at (H, C) = (128, 128), forward and backward, L1 in 0..3.
//
// Replaces the TPU kernels of magnet_tpu/ops/pallas_kernels.py on bf16
// operands at MAgNet[GNN]'s width (its graph_dtype=bf16; ln_s and ln_b stay
// f32):
//   * fold: _fused2r_fwd_pallas (#8) and _fused2r_bwd_pallas (#9, with
//     dpxj_in_kernel=True) as the fold-e public entry fused_edge_tail_agg2rf
//     calls them (operands e0, W_e with the edge scale folded in, b_e, pxj,
//     pxi, W_k, b_k, W_out, b_out);
//   * pe: _fused2_fwd_pallas (#6) and _fused2_bwd_pallas (#7), the public
//     entry fused_edge_tail_agg2 (operands pe = s e0 . W_e + (1 - s) b_e
//     formed by the caller in bf16, pxj, pxi, W_k, b_k, W_out, b_out);
//   * pregathered: _fused_fwd_pallas (#2) and _fused_bwd_pallas (#3), the
//     public entry fused_edge_tail_agg and its VJP _fused_bwd (operands
//     h0 = bf16(pxj[s] + pe) formed by the caller, pxi, W_k, b_k, W_out,
//     b_out).  Its rounding points, read from the Pallas bodies, are the pe
//     entry's without the pxj term: h_0 = bf16(relu(f32(h0) + f32(pxi[i])))
//     (the body's relu(h0 + onehot . pxi), exact in f32), d_h0 = bf16(dz)
//     (the body's f32 dh0, cast by _fused_bwd), d_pxi the f32 sums of
//     bf16(dz) (the body's onehot . bf16(d_h)), cast once.  Where they
//     differ from the pe entry: no f32 dz is written, since d_pxj is not
//     this kernel's (the caller's sender gather sums bf16(d_h0) over the
//     sender CSR, as the JAX gather_sender VJP sums its bf16 cotangent),
//     and neither pxj nor the senders are read.
// The arithmetic is the TPU kernels', rounding where they round:
//
//   forward, for every edge j -> i of a receiver-grouped CSR graph
//     z    = f32(e0[e] . W_e) + b_e + pxj[j] + pxi[i]      (fold, f32)
//     z    = (f32(pe[e]) + f32(pxj[j])) + f32(pxi[i])       (pe, f32)
//     z    = f32(h0[e]) + f32(pxi[i])                       (pregathered)
//     h_0  = bf16(relu(z));  h_k = bf16(relu(f32(h_{k-1} . W_k) + b_k))
//     y    = f32(h_L1 . W_out) + b_out;  y = LayerNorm(y)  (f32, two-pass)
//     out[i] = sum over the edges of i of bf16(y), in f32     (N, C) f32
//   backward, given g (N, C) f32, with the activations recomputed
//     d_out = bf16(g[i]); LayerNorm's backward in f32 to dy;
//     dW_out = h_L1^T . bf16(dy), db_out = sum dy (f32);
//     da_L1 = (bf16(dy) . W_out^T) [h_L1 > 0];
//     dW_k = h_{k-1}^T . bf16(da_k), db_k = sum da_k,
//     da_{k-1} = (bf16(da_k) . W_k^T) [h_{k-1} > 0];   dz = da_0;
//     fold: d_e0 = bf16(bf16(dz) . W_e^T) (E, Ce) bf16;
//           dW_e = e0^T . bf16(dz), db_e = sum dz;  d_pxj[j] += bf16(dz);
//     pe:   dz written unrounded (E, H) f32, for the caller's f32 segment
//           sum over the sender CSR (d_pxj = bf16 of that sum, as the JAX
//           VJP reduces the f32 dz outside its kernel), and d_pe = bf16(dz);
//     pregathered: d_h0 = bf16(dz);
//     d_pxi[i] += bf16(dz) (f32 sums);
//     d_ln_s = sum bf16(g) xhat, d_ln_b = sum bf16(g);
// every product on bf16 operands with f32 accumulation, every weight
// gradient summed in f32; the caller casts each gradient to its operand's
// dtype, as the JAX VJPs do.  The plain versions are
// magnet_tpu_torch/ops/fused_edge.py:fused_edge_tail_agg_bf16_plain /
// _bwd_plain (fold), fused_edge_tail_agg_pe_bf16_plain / _bwd_plain and
// fused_edge_tail_agg_pregathered_bf16_plain / _bwd_plain, each at any
// width.
//
// The forward keeps every weight resident once, unpadded, in one block;
// the backward, whose five 128 x 128 f32 weight gradients (320 KB) exceed a
// block's 227 KB, gives each weight a block of its own, the blocks of one
// thread block cluster passing activations and gradients through
// distributed shared memory:
//   * forward (#8, #6, #2; fwd::wgmma_fwd_kernel): one block of 256
//     threads an SM, block b over tiles [b T / B, (b + 1) T / B) of 64 CSR
//     edges; its two warpgroups each walk half of them (the first the first
//     half, rounded up) with their own tiles and named barriers.  Every
//     weight (W_e, W_1 .. W_L1, W_out) lies once in shared memory as stored
//     (in, out), in two 64-column halves of 128-byte rows in the 128-byte
//     swizzle, loaded by cp.async before the walk: the MN-major B of an
//     m64n128k16 wgmma (csrc/wgmma.cuh), its descriptor's LBO the step
//     from one half to the other.  The fold's first product, e0 . W_e,
//     reads the staged e0 tile (K-major A, two halves) onto accumulators
//     started at b_e + (pxj[s] + pxi[i]); pe and pregathered form h_0
//     elementwise from the staged rows straight into the A fragments of the
//     first tail product; every later product reads A from registers (the
//     accumulators of the one before, bias first, relu and rounded to bf16
//     in place), k ascending, so no barrier comes between the layers.  y +
//     b_out and LayerNorm (two-pass, f32) run in the accumulators (each
//     row's statistics over the four threads of its quad); bf16(y) goes to
//     the warpgroup's tile, and the receiver sums are one more product, D =
//     S . Y (wgmma.cuh: S the 0/1 matrix of the tile's runs of equal
//     receivers), each run's row of D to out, or for a receiver that
//     crosses a tile to its partial row, added in tile order by
//     cross_tile_sum_kernel: no atomics, out has the same bits run to run.
//     A tile's e0 / pe / h0 rows are staged by cp.async into the tile the
//     one before has read, and its node rows (pxj[s], pxi[i]) loaded into
//     registers, while that tile's first tail product runs; the next
//     indices are loaded at the start of a tile and searched there
//     (IndexLoad).
//     232,448 bytes of shared memory for the fold at L1 = 3 (199,680 pe
//     and pregathered): one block an SM;
//   * the backward's products are mma.sync.aligned.m16n8k16 bf16 x bf16 ->
//     f32, their fragments read by ldmatrix from shared tiles whose bf16
//     rows are padded to 136 elements (272 bytes: the eight rows of an
//     ldmatrix block fall on distinct banks).  One copy of a weight, as
//     stored (in, out), serves both products: h . W reads it by
//     ldmatrix.trans, da . W^T by plain ldmatrix (the transposing form
//     works on 16-bit elements, so no second copy); the weight gradients
//     read both their (edge, width) tiles down their columns by
//     ldmatrix.trans;
//   * backward (#9, #7, #3), two launches (bwd::launch): (a) a grid of
//     clusters of n CTAs, one a weight (fold: W_e, W_1 .. W_L1, W_out, n =
//     L1 + 2; pe and pregathered: W_1 .. W_L1, W_out, n = L1 + 1), as many
//     clusters as the card holds at once (cudaOccupancyMaxActiveClusters),
//     each over a range of consecutive 64-edge tiles; (b) the clusters'
//     partial rows added in cluster order, so that the weight and bias
//     gradients are the same from run to run.  In step s CTA p runs the
//     forward of tile s - p (h_p = bf16(relu(h_{p-1} . W + b)) from the
//     forward's initial values in the forward's product order, so the h_k
//     have the forward's bits, sent into CTA p + 1's ring) and the backward
//     of tile s - (2 n - 2 - p) (dW += h_{p-1}^T . d on the ring's h_{p-1},
//     da = (d . W^T) masked by h_{p-1} > 0, its unrounded column sums the
//     bias gradient of the layer before, bf16(da) sent into CTA p - 1's two
//     gradient tiles); then the cluster meets at one barrier.  A tile's
//     h_{p-1} waits in CTA p's ring from its forward to its backward, 2 (n
//     - p) tiles (the first CTA's 2 n); each CTA's dW stays in 64 f32
//     accumulators a thread for its whole range (tests/
//     test_torch_bwd128_bf16.py emulates the truncation: far inside the
//     tolerances).  The output CTA forms y = h_L1 . W_out + b_out and
//     LayerNorm's backward to bf16(dy) in the same step as its backward.
//     The first CTA forms h_0 (pe, pregathered: elementwise from staged
//     rows; fold: e0 . W_e from b_e + (pxj[s] + pxi[i])), re-reads e0 for
//     dW_e and d_e0 = bf16(bf16(dz) . W_e^T), writes d_src (and the pe's f32
//     dz), and adds bf16(dz) into d_pxi (one atomicAdd per run of equal
//     receivers in half a tile) and, fold, d_pxj (one per element): f32
//     atomics, whose last bits vary before the caller's rounding to bf16.
//     The rows a step reads from global memory (e0, the node rows, g) are
//     staged by cp.async in the step before, the tile indices two tiles
//     ahead (IndexLoad), so no step waits on a load it issued.  No (E, 128)
//     plane leaves the chip: HBM sees e0 / pe / h0 (and e0 twice), the node
//     rows, g and the outputs.  231,936 bytes of shared memory: one CTA an
//     SM; 22 clusters of 5 (fold) and 30 of 4 (pe, pregathered) on an H100.
// What bounds it on an H100: at L1 = 3 the fold forward does Ce H + L1 H^2
// + H C = 81,920 multiply-adds an edge (pe and pregathered 65,536), the
// backward three times that; at MAgNet[GNN]'s training graph (67,572 edges)
// 33.2 GFLOP, 0.034 ms at the dense bf16 rate of 989 TFLOP/s: bound by
// operations.  The pipeline runs far from it: a (64 x 128 x 128) mma.sync
// product takes ~1,500 cycles of an SM (its ldmatrix traffic, 128 KB, near
// the SM's shared-memory rate), and the steps go at the pace of the first
// and the output CTAs, which add to their three products the staging, the
// atomics and d_src, and LayerNorm, about twice a middle CTA's work
// (magnet_tpu_torch/probe_bwd128.py times each part; PERF.md keeps the
// numbers).  mma.sync and not wgmma there: the products read their
// operands from padded tiles, transposed or not.
// Registers, bytes and spills of each kernel (ptxas -v, one build for
// sm_90a): see fused_edge_tail_agg_bf16_w128_smem, _fwd_smem and
// chip_smoke.py's gnn_bf16_kernel phase, which prints ptxas's lines;
// PERF.md keeps them.
//
// The edges are the first rowptr[N] <= E rows, read on the card
// (tile128::live_edges), as in the f32 sources and the width-64 bf16 one: a
// graph padded to a fixed E for a captured training step (ops/graph.py
// pad_edges) has dead rows past rowptr[N].  E sets the grids and the
// scratch; the forward splits the live tiles over the blocks a launch would
// take for them alone, and the backward the live tiles over the clusters an
// unpadded launch would run, so every block's (every cluster's) tiles, its
// partial row and the fixed-order sums of the partial rows are those of the
// launch without the padding.  A forward block past that split exits whole
// once its copies have landed; a cluster past it exits with all its CTAs
// together before their first cluster barrier.  The backward writes zeros
// into d_src's dead rows (and the pe entry's dz's).  So a padded launch
// computes, bit for bit, what the launch without the padding does (the f32
// node gradients up to the order of their atomics).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (magnet_tpu_torch/ops/cuda_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "tile_mm.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tile128::Entry;
using tile128::kFold;
using tile128::kPe;
using tile128::kPregathered;
using tile128::kW;
using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

constexpr float kLnEps = 1e-5f;
constexpr int kTE = 64;           // edges per tile
constexpr int kThreads = 256;     // 8 warps
constexpr int kLd = kW + 8;       // bf16 row stride of a shared tile
constexpr int kLdF = kW + 4;      // f32 row stride of the y tile
constexpr int kPieces = kTE * kW / 8;  // 16-byte pieces of a tile's rows
constexpr int kMaxDevices = 64;
constexpr int kMaxL1 = 3;

// ---- bf16 products on the tensor cores -----------------------------------
//
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, lane = 4 g + t:
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//                a3 (g + 8, 2t + 8..)
//   B (16 x 8):  b0 (2t..2t+1, g), b1 (2t + 8.., g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// each register holding two bf16 values, the lower index in its low half.
// ldmatrix.x4 gives lanes 8 j .. 8 j + 7 the row addresses of matrix j and
// every lane (g, t) element (g, 2t..2t+1) of each of the four 8 x 8
// matrices; with .trans, element (2t..2t+1, g) of each.

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// two f32 values rounded to bf16 (to nearest, ties to even), lo first
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// bf16(relu((f32(a) + f32(b)) + f32(c))) of three pairs of bf16 values
__device__ __forceinline__ uint32_t relu_sum3(uint32_t a, uint32_t b,
                                              uint32_t c) {
  const float2 x = unpack(a), y = unpack(b), z = unpack(c);
  return pack_rn(fmaxf((x.x + y.x) + z.x, 0.f), fmaxf((x.y + y.y) + z.y, 0.f));
}
// bf16(relu(f32(a) + f32(c))) of two pairs of bf16 values
__device__ __forceinline__ uint32_t relu_sum2(uint32_t a, uint32_t c) {
  const float2 x = unpack(a), z = unpack(c);
  return pack_rn(fmaxf(x.x + z.x, 0.f), fmaxf(x.y + z.y, 0.f));
}
// h_0 of 8 columns from 16 bytes of src, pxj (GATHERS) and pxi each
template <bool GATHERS>
__device__ __forceinline__ uint4 first_layer8(uint4 a, uint4 j, uint4 i) {
  if (GATHERS)
    return make_uint4(relu_sum3(a.x, j.x, i.x), relu_sum3(a.y, j.y, i.y),
                      relu_sum3(a.z, j.z, i.z), relu_sum3(a.w, j.w, i.w));
  return make_uint4(relu_sum2(a.x, i.x), relu_sum2(a.y, i.y),
                    relu_sum2(a.z, i.z), relu_sum2(a.w, i.w));
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// The (64 x 128) product of a tile: warp w forms rows m0 = 32 (w & 1) ..
// + 31 and columns n0 = 32 (w >> 1) .. + 31; acc[mi][ni] is the 16 x 8
// tile at (m0 + 16 mi, n0 + 8 ni).
__device__ __forceinline__ int tile_m0() { return 32 * ((threadIdx.x >> 5) & 1); }
__device__ __forceinline__ int tile_n0() { return 32 * (threadIdx.x >> 6); }
__device__ __forceinline__ int acc_row(int mi, int c) {
  return tile_m0() + 16 * mi + lane_g() + 8 * (c >> 1);
}
__device__ __forceinline__ int acc_col(int ni, int c) {
  return tile_n0() + 8 * ni + 2 * lane_t() + (c & 1);
}

// acc += A . B over K, A(m, k) = a[m kLd + k] (bf16 rows) and
//   WT = false: B(k, n) = b[k kLd + n], a weight as stored (in, out);
//   WT = true:  B(k, n) = b[n kLd + k], the transpose of one.
template <int K, bool WT>
__device__ __forceinline__ void mm_tile(float (&acc)[2][4][4], const bf16* a,
                                        const bf16* b) {
  const int lane = threadIdx.x & 31;
  const bf16* pa = a + (tile_m0() + (lane & 15)) * kLd + ((lane >> 4) << 3);
  const bf16* pb =
      WT ? b + (tile_n0() + (lane & 7) + ((lane >> 4) << 3)) * kLd +
               (((lane >> 3) & 1) << 3)
         : b + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLd + tile_n0() +
               ((lane >> 4) << 3);
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t fa[2][4], fb[2][4];  // fb[j]: columns n0 + 16 j .. + 15
    ldsm(fa[0], pa + k0);
    ldsm(fa[1], pa + 16 * kLd + k0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (WT)
        ldsm(fb[j], pb + 16 * j * kLd + k0);
      else
        ldsm_t(fb[j], pb + k0 * kLd + 16 * j);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma(acc[mi][ni], fa[mi], fb[ni >> 1][2 * (ni & 1)],
            fb[ni >> 1][2 * (ni & 1) + 1]);
  }
}

// acc = bias on the thread's columns (bf16 bias, f32 accumulators)
__device__ __forceinline__ void bias_init(float (&acc)[2][4][4],
                                          const bf16* __restrict__ bias) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const float2 b = ld_bf16x2(bias + acc_col(ni, 0));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      acc[mi][ni][0] = acc[mi][ni][2] = b.x;
      acc[mi][ni][1] = acc[mi][ni][3] = b.y;
    }
  }
}

// The fold's first accumulators from the tile's staged node rows: acc =
// b_e + (pxj[sender] + pxi[receiver]), zero past n_valid
__device__ __forceinline__ void fold_init_rows(float (&acc)[2][4][4],
                                               const bf16* __restrict__ be,
                                               const bf16* pj_rows,
                                               const bf16* pi_rows,
                                               int n_valid) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = acc_row(mi, 2 * h);
      const bool valid = e < n_valid;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = acc_col(ni, 0);
        const float2 b = ld_bf16x2(be + n);
        const float2 j = ld_bf16x2(pj_rows + e * kLd + n);
        const float2 i = ld_bf16x2(pi_rows + e * kLd + n);
        acc[mi][ni][2 * h] = valid ? b.x + (j.x + i.x) : 0.f;
        acc[mi][ni][2 * h + 1] = valid ? b.y + (j.y + i.y) : 0.f;
      }
    }
}

// f(row, column, v0, v1) on the thread's pairs of neighbouring columns
template <class F>
__device__ __forceinline__ void acc_pairs(const float (&acc)[2][4][4], F f) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(acc_row(mi, 2 * h), acc_col(ni, 0), acc[mi][ni][2 * h],
          acc[mi][ni][2 * h + 1]);
}

// dst row r, columns c .. c + 7 <- 16 bytes of src (or zeros where src is
// null), by cp.async without waiting
__device__ __forceinline__ void piece_async(bf16* dst, const bf16* src,
                                            const bf16* any) {
  cp_async16(dst, src ? src : any, src != nullptr);
}

// Resident blocks of `kernel` per SM and the SM count, with the
// shared-memory opt-in, once per device (`cache`, zeros: unset).
template <class Kernel>
cudaError_t residency(Kernel kernel, size_t smem,
                      std::atomic<int> (&cache)[kMaxDevices], int* per_sm,
                      int* n_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int v = device < kMaxDevices ? cache[device].load(std::memory_order_relaxed)
                               : 0;
  if (v == 0) {
    int optin = 0, sms = 0, blocks = 0;
    if ((err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
        cudaSuccess)
      return err;
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, kernel, kThreads, smem)) != cudaSuccess)
      return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    v = blocks << 16 | sms;
    if (device < kMaxDevices) cache[device].store(v, std::memory_order_relaxed);
  }
  *per_sm = v >> 16;
  *n_sm = v & 0xffff;
  return cudaSuccess;
}

// The blocks (or clusters) a launch over n_edges live edges splits them
// over: their tiles, or `cap` where there are more; block b walks tiles
// [b T / B, (b + 1) T / B).
__host__ __device__ __forceinline__ int split_blocks(int n_edges, int cap) {
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  return n_tiles < cap ? n_tiles : cap;
}

// Rows [live, n_rows) of an array of RB-byte rows set to zero, 16 bytes a
// store, by every thread of the grid: a padded graph's dead rows get no
// gradient.
template <int RB>
__device__ __forceinline__ void zero_dead_rows(void* rows, int live,
                                               int n_rows) {
  static_assert(RB % 16 == 0, "16-byte stores");
  const size_t n = (size_t)(n_rows - live) * (RB / 16);
  uint4* dst = reinterpret_cast<uint4*>(static_cast<unsigned char*>(rows) +
                                        (size_t)live * RB);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = make_uint4(0u, 0u, 0u, 0u);
}

// wgrad[p] = sum over the clusters that hold a partial row (split_blocks of
// the live edges), in cluster order, of partial[c][p].
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ wgrad,
                                       const int* __restrict__ rowptr,
                                       int n_nodes, int n_rows, int cap,
                                       int total) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const int n_blocks =
      split_blocks(tile128::live_edges(rowptr, n_nodes, n_rows), cap);
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * total + p];
  wgrad[p] = s;
}

// A warp's share of tile128::tile_indices (its 32 edges from base), split
// around the step's products so that the loads' latency hides under them:
// issue() loads the 32 row starts after the receiver `hint` of an edge
// before base (>= 0) and the senders; finish() forms the receivers as
// tile128::warp_receiver does from that hint (the count of row starts at or
// before each edge by a five-step search over the sorted starts in place of
// its 32 comparisons) and stores both.
struct IndexLoad {
  int start, snd;

  // AHEAD: the loads issued here (tile128::ldg_ahead), not where the
  // compiler would sink them
  template <bool GATHERS, bool AHEAD = false>
  __device__ __forceinline__ void issue(const int* __restrict__ rowptr,
                                        const int* __restrict__ senders,
                                        int n_nodes, int base, int n_valid,
                                        int hint) {
    const int lane = threadIdx.x & 31;
    const int j = hint + 1 + lane;
    if constexpr (AHEAD) {
      start = tile128::ldg_ahead(rowptr + (j <= n_nodes ? j : n_nodes));
      if (j > n_nodes) start = 0x7fffffff;
      snd = GATHERS ? tile128::ldg_ahead(
                          senders + (lane < n_valid ? base + lane : 0))
                    : 0;
      if (lane >= n_valid) snd = 0;
    } else {
      start = j <= n_nodes ? __ldg(rowptr + j) : 0x7fffffff;
      snd = GATHERS && lane < n_valid ? __ldg(senders + base + lane) : 0;
    }
  }

  template <bool GATHERS>
  __device__ __forceinline__ void finish(int* s_rcv, int* s_snd,
                                         const int* __restrict__ rowptr,
                                         int n_nodes, int base, int n_valid,
                                         int hint) const {
    const int lane = threadIdx.x & 31;
    const int e = base + lane;
    int below = 0;  // starts at or before e, of the first 31 (sorted)
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(0xffffffffu, start, below + step - 1) <= e) below += step;
    int r = hint + below;
    const int window_end = __shfl_sync(0xffffffffu, start, 31);
    if (lane < n_valid && e >= window_end)
      r = tile128::receiver_of(rowptr, n_nodes, e);
    s_rcv[lane] = lane < n_valid ? r : 0;
    if (GATHERS) s_snd[lane] = snd;
  }
};

// The warpgroup's named barrier (1 + its index; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + grp) : "memory");
}

// ---- forward ---------------------------------------------------------------

namespace fwd {

constexpr int kGroups = 2;            // warpgroups a block, each its tiles
constexpr int kHalf = kTE * 128;      // a 64-column half of a (kTE, kW) tile
constexpr int kTileW = 2 * kHalf;     // a bf16 (kTE, kW) tile
constexpr int kWHalf = kW * 128;      // a 64-column half of a (kW, kW) weight
constexpr int kWeight = 2 * kWHalf;   // a bf16 (kW, kW) weight
static_assert(kGroups * 128 == kThreads, "two warpgroups a block");

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Byte offset of (r, c) of a bf16 tile of R rows of kW stored as two
// 64-column halves, each of 128-byte rows in the 128-byte swizzle
// (wgmma.cuh).
template <int R>
__host__ __device__ __forceinline__ uint32_t at2(int r, int c) {
  return (c >> 6) * (R * 128) + wg::at<128>(r, c & 63);
}

// Offsets, in bytes, into dynamic shared memory (from its first 1,024-byte
// boundary): one part a warpgroup, then the weights, each resident once
// as stored (in, out) in two 64-column halves (W_1 .. W_L1 last, so that
// nothing else moves with L1): 231,424 bytes for the fold at L1 = 3, one
// block an SM.
template <Entry E>
struct Layout {
  static constexpr int F = E == kFold ? 1 : 0;  // e0 and W_e
  // a warpgroup's part, from its start
  static constexpr int src = 0;               // e0 / pe / h0 (kTE, kW)
  static constexpr int y = src + kTileW;      // bf16(y) (kTE, kW)
  static constexpr int idx = y + kTileW;      // 2 x rcv, 2 x snd (kTE)
  static constexpr int group_bytes = round_up(idx + 4 * kTE * 4, 1024);
  static constexpr int we = kGroups * group_bytes;  // W_e
  static constexpr int wo = we + F * kWeight;       // W_out
  static constexpr int wr = wo + kWeight;           // W_1 .. W_L1
  // + the base's alignment
  __host__ __device__ static constexpr int bytes(int l1) {
    return wr + l1 * kWeight + 1024;
  }
};
static_assert(Layout<kFold>::bytes(kMaxL1) <= 232448, "one block an SM");

// `rows` rows of kW bf16 (global, 16-byte aligned) into a tile of two
// 64-column halves of `rows` rows each (at2), zeros from row n_valid on,
// by the 128 threads of a warpgroup (t) or the block's (kThreads) through
// cp.async; the caller commits.
template <int THREADS, class Row>
__device__ __forceinline__ void stage_w128(unsigned char* tile, int rows,
                                           int n_valid, int t,
                                           const void* any, Row row) {
  for (int p = t; p < rows * 16; p += THREADS) {
    const int r = p >> 4, k = p & 15;
    const bool valid = r < n_valid;
    const unsigned char* s =
        valid ? reinterpret_cast<const unsigned char*>(row(r)) + 16 * k
              : reinterpret_cast<const unsigned char*>(any);
    cp_async16(tile + (k >> 3) * (rows * 128) +
                   wg::swz<128>(r * 128 + (k & 7) * 16),
               s, valid);
  }
}

// The thread's pairs of node rows in the accumulator layout: v[h][j] holds
// columns 8 j + 2 t, + 1 of row r0 + 8 h of the tile, row(r) the node row
// of edge r (zeros past n_valid).  They are both the fold's z addends
// (accumulator pair i: h = (i / 2) % 2, j = i / 4) and h_0's A fragments
// (a[j][q]: h = q % 2, j = 2 j + q / 2).
template <class Row>
__device__ __forceinline__ void node_pairs(uint32_t (&v)[2][16], int r0,
                                           int c0, int n_valid, Row row) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const bf16* p = row(r < n_valid ? r : 0);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      v[h][j] = tile128::ldg_ahead(
          reinterpret_cast<const unsigned*>(p + 8 * j + c0));
      if (r >= n_valid) v[h][j] = 0u;
    }
  }
}

// acc = v[column] of a bf16 vector (global) on every element of an m64n128
// accumulator
__device__ __forceinline__ void init_bias(float (&d)[64],
                                          const bf16* __restrict__ v,
                                          int c0) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b = ld_bf16x2(v + 8 * j + c0);
    d[4 * j] = d[4 * j + 2] = b.x;
    d[4 * j + 1] = d[4 * j + 3] = b.y;
  }
}

// bf16(relu(d)) of an m64n128 accumulator into the A fragments of the
// product that reads it next (wgmma.cuh)
__device__ __forceinline__ void relu_pack(const float (&d)[64],
                                          uint32_t (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 64; i += 2)
    a[i >> 3][(i >> 1) & 3] = pack_rn(fmaxf(d[i], 0.f), fmaxf(d[i + 1], 0.f));
}

// E: kFold (src is e0; we and be are read), kPe (src is pe) or
// kPregathered (src is h0; pxj and senders are not read).
template <Entry E>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_fwd_kernel(const bf16* __restrict__ src, const bf16* __restrict__ we,
                 const bf16* __restrict__ be, const bf16* __restrict__ pxj,
                 const bf16* __restrict__ pxi,
                 const int* __restrict__ senders,
                 const int* __restrict__ rowptr,
                 const bf16* __restrict__ w_rest,
                 const bf16* __restrict__ b_rest,
                 const bf16* __restrict__ w_out,
                 const bf16* __restrict__ b_out,
                 const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, float* __restrict__ out,
                 float* __restrict__ part, int n_nodes, int n_rows, int l1,
                 int cap) {
  using L = Layout<E>;
  constexpr bool FOLD = E == kFold, GATHERS = E != kPregathered;
  // the live edges, the load issued now and read after the weights' copies
  // are issued; the rows past them (a padded graph's) are not read
  const int n_edges = tile128::live_edges(rowptr, n_nodes, n_rows);
  extern __shared__ __align__(16) unsigned char bf16w_fwd_smem[];
  unsigned char* sm = bf16w_fwd_smem + ((1024 - (wg::smem_addr(bf16w_fwd_smem)
                                                 & 1023)) & 1023);
  const int tid = threadIdx.x, grp = tid >> 7, t = tid & 127, w = t >> 5;
  unsigned char* s_we = sm + L::we;
  unsigned char* s_wr = sm + L::wr;
  unsigned char* s_wo = sm + L::wo;
  unsigned char* gp = sm + grp * L::group_bytes;
  unsigned char* s_src = gp + L::src;
  unsigned char* s_y = gp + L::y;
  int* s_rcv = reinterpret_cast<int*>(gp + L::idx);
  int* s_snd = s_rcv + 2 * kTE;

  // every weight by cp.async, once, resident for the whole walk
  auto weight_rows = [](const bf16* m) {
    return [m](int r) { return m + (size_t)r * kW; };
  };
  if constexpr (FOLD)
    stage_w128<kThreads>(s_we, kW, kW, tid, we, weight_rows(we));
  for (int k = 0; k < l1; ++k)
    stage_w128<kThreads>(s_wr + k * kWeight, kW, kW, tid, w_rest,
                         weight_rows(w_rest + (size_t)k * kW * kW));
  stage_w128<kThreads>(s_wo, kW, kW, tid, w_out, weight_rows(w_out));
  cp_async_commit();

  // the block's tiles [b0, b1) of the live edges, balanced over the blocks
  // the launch takes for them alone (split_blocks); a block past those
  // exits whole once its copies (the resident weights) have landed;
  // warpgroup 0 walks the first half (rounded up), warpgroup 1 the rest
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int n_split = split_blocks(n_edges, cap);
  if ((int)blockIdx.x >= n_split) {
    cp_async_wait<0>();
    return;
  }
  const int b0 = (int)((long long)blockIdx.x * n_tiles / n_split);
  const int b1 = (int)((long long)(blockIdx.x + 1) * n_tiles / n_split);
  const int mid = b0 + (b1 - b0 + 1) / 2;
  const int t_beg = grp == 0 ? b0 : mid, t_end = grp == 0 ? mid : b1;

  const int r0 = 16 * w + ((t & 31) >> 2), c0 = 2 * (t & 3);
  // a tile's e0 / pe / h0 rows, staged by cp.async; its node rows, loaded
  // into registers (nj: pxj[s], ni: pxi[i]) a tile ahead of their use
  uint32_t nj[2][16], ni[2][16];
  auto stage_tile = [&](int tile, const int* rcv, const int* snd) {
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    stage_w128<128>(s_src, kTE, n_valid, t, src,
                    [&](int r) { return src + (size_t)(base + r) * kW; });
    if constexpr (GATHERS)
      node_pairs(nj, r0, c0, n_valid,
                 [&](int r) { return pxj + (size_t)snd[r] * kW; });
    node_pairs(ni, r0, c0, n_valid,
               [&](int r) { return pxi + (size_t)rcv[r] * kW; });
  };

  // while the weights arrive: the first tile's indices (a full search) and
  // rows; a warpgroup without a tile commits an empty group, so that every
  // thread's wait below covers the weights alone
  if (t_beg < t_end) {
    if (w < 2)
      tile128::tile_indices<kTE, GATHERS>(s_rcv, s_snd, senders, rowptr,
                                          n_nodes, n_edges, t_beg, -1);
    group_sync(grp);  // the first tile's indices
    stage_tile(t_beg, s_rcv, s_snd);
  }
  cp_async_commit();
  cp_async_wait<1>();
  wg::fence_async_smem();
  __syncthreads();  // the weights

  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    const int* rcv = s_rcv + cur * kTE;
    const bool more = tile + 1 < t_end;
    float acc[64];
    // bf16 A fragments of the chain's products (K = kW), each layer's
    // output rounded in place; alive until the wait that covers the
    // product that reads them (fence_operand)
    uint32_t a[kW / 16][4];

    cp_async_wait<0>();  // this tile's rows
    wg::fence_async_smem();
    group_sync(grp);  // the rows are in; the last tile's sums are done
    // the row starts the receiver sums read, loaded now; warps 0 and 1: the
    // next tile's indices, loads issued now, the search finished under the
    // first tail product
    const int2 ends = csr_tile::edge_ends(rowptr, rcv, n_valid);
    const int next_base = (tile + 1) * kTE + 32 * w;
    const int next_valid = min(32, n_edges - next_base);
    IndexLoad next;
    if (more && w < 2)
      next.issue<GATHERS, true>(rowptr, senders, n_nodes, next_base,
                                next_valid, rcv[n_valid - 1]);
    // the next tile's indices stored, then its rows staged into the tiles
    // this one has read and its node rows loaded into registers: issued
    // while a product runs
    auto advance = [&]() {
      if (more && w < 2)
        next.finish<GATHERS>(s_rcv + nxt * kTE + 32 * w,
                             s_snd + nxt * kTE + 32 * w, rowptr, n_nodes,
                             next_base, next_valid, rcv[n_valid - 1]);
      __syncwarp();  // the lanes meet before the warpgroup's barrier
      group_sync(grp);  // every warp has read the rows (the fold's product
                        // retired by its wait); the next indices written
      if (more)
        stage_tile(tile + 1, s_rcv + nxt * kTE, s_snd + nxt * kTE);
      cp_async_commit();
    };

    // h_0: fold bf16(relu(e0 . W_e + (b_e + (pxj[s] + pxi[i])))), the
    // accumulators started at z (zero past n_valid); pe
    // bf16(relu((pe + pxj[s]) + pxi[i])) and pregathered bf16(relu(h0 +
    // pxi[i])) elementwise from the staged rows straight into the A
    // fragments
    if constexpr (FOLD) {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int h = (i >> 1) & 1, j = i >> 2;
        const float2 b = ld_bf16x2(be + 8 * j + c0);
        const float2 pj = unpack(nj[h][j]), pi = unpack(ni[h][j]);
        const bool valid = r0 + 8 * h < n_valid;
        acc[i] = valid ? b.x + (pj.x + pi.x) : 0.f;
        acc[i + 1] = valid ? b.y + (pj.y + pi.y) : 0.f;
      }
      wg::fence_operand(acc);
      wg::fence();
      wg::product_w128(acc, s_src, kHalf, s_we, kWHalf, true);
      wg::commit();
    } else {
#pragma unroll
      for (int j = 0; j < kW / 16; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q & 1, jj = 2 * j + (q >> 1);
          const uint32_t x = *reinterpret_cast<const uint32_t*>(
              s_src + at2<kTE>(r0 + 8 * h, 8 * jj + c0));
          const uint32_t i = ni[h][jj];
          if constexpr (E == kPe)
            a[j][q] = relu_sum3(x, nj[h][jj], i);
          else
            a[j][q] = relu_sum2(x, i);
        }
    }
    if constexpr (FOLD) {
      wg::wait<0>();
      wg::fence_operand(acc);
      relu_pack(acc, a);
    }

    // h_k = bf16(relu(h_{k-1} . W_k + b_k)), k = 1 .. L1, each from the
    // registers the layer below left: no barrier between them but the one
    // of advance() under the first; k ascending as the backward's recompute
    for (int k = 1; k <= l1; ++k) {
      init_bias(acc, b_rest + (size_t)(k - 1) * kW, c0);
      wg::fence_operand(acc);
      wg::fence();
      wg::product_rs<kW / 16, 1, 128>(acc, a, s_wr + (k - 1) * kWeight, true,
                                      kWHalf);
      wg::commit();
      if (k == 1) advance();
      wg::wait<0>();
      wg::fence_operand(acc);
      wg::fence_operand(a);
      relu_pack(acc, a);
    }

    // y = h_L1 . W_out + b_out; LayerNorm in the accumulators, each row's
    // statistics over the four threads of its quad (two-pass variance);
    // bf16(y) into the warpgroup's tile; then the receiver sums as one
    // product of it, D = S . Y (wgmma.cuh: S the tile's runs of equal
    // receivers, each warp's own copy from a ballot), D's rows to out or,
    // for the receivers that cross a tile boundary, to the partial rows
    init_bias(acc, b_out, c0);
    wg::fence_operand(acc);
    wg::fence();
    wg::product_rs<kW / 16, 1, 128>(acc, a, s_wo, true, kWHalf);
    wg::commit();
    // the tile's runs of equal receivers and S's fragments while y's
    // product runs
    const uint64_t starts = wg::run_starts(rcv, n_valid);
    uint32_t s_a[kTE / 16][4];
    wg::run_matrix(s_a, starts, n_valid);
    wg::wait<0>();
    wg::fence_operand(acc);
    wg::fence_operand(a);
    if (l1 == 0) advance();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mu = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        mu += acc[4 * j + 2 * hh] + acc[4 * j + 2 * hh + 1];
      mu += __shfl_xor_sync(0xffffffffu, mu, 1);
      mu += __shfl_xor_sync(0xffffffffu, mu, 2);
      mu *= 1.f / kW;
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const float d = acc[4 * (q >> 1) + 2 * hh + (q & 1)] - mu;
        var = fmaf(d, d, var);
      }
      var += __shfl_xor_sync(0xffffffffu, var, 1);
      var += __shfl_xor_sync(0xffffffffu, var, 2);
      var *= 1.f / kW;
      const float rstd = rsqrtf(var + kLnEps);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + c0;
        const float2 s = __ldg(reinterpret_cast<const float2*>(ln_s + c));
        const float2 b = __ldg(reinterpret_cast<const float2*>(ln_b + c));
        *reinterpret_cast<uint32_t*>(s_y + at2<kTE>(r0 + 8 * hh, c)) =
            pack_rn((acc[4 * j + 2 * hh] - mu) * rstd * s.x + b.x,
                    (acc[4 * j + 2 * hh + 1] - mu) * rstd * s.y + b.y);
      }
    }
    wg::fence_async_smem();
    group_sync(grp);  // bf16(y) written
    wg::fence();
    wg::product_rs<kTE / 16, 1, 128>(acc, s_a, s_y, false, kHalf);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc);
    wg::fence_operand(s_a);
    wg::store_runs<kW, kTE>(acc, starts, rcv, ends.x, ends.y, n_edges, tile,
                            n_valid, out, part);
  }
}

// kernels the last call launched (its own count, for the checks)
std::atomic<int> last_launches{0};

// The blocks the card holds at once of the kernel (SMs x the blocks an SM
// holds) into *cap, the shared-memory opt-in with the first call; one for
// every l1.
template <Entry E>
cudaError_t fwd_cap(int* cap) {
  static std::atomic<int> cache[kMaxDevices];
  int per_sm = 0, n_sm = 0;
  const cudaError_t err =
      residency(wgmma_fwd_kernel<E>, (size_t)Layout<E>::bytes(kMaxL1), cache,
                &per_sm, &n_sm);
  *cap = per_sm * n_sm;
  return err;
}

// The blocks a call of n_edges rows takes (min(tiles, the blocks the card
// holds at once)) into *blocks.
template <Entry E>
cudaError_t grid(int n_edges, int* blocks) {
  int cap = 0;
  const cudaError_t err = fwd_cap<E>(&cap);
  if (err != cudaSuccess) return err;
  *blocks = split_blocks(n_edges, cap);
  return cudaSuccess;
}

// The kernel, block b over tiles [b T / B, (b + 1) T / B) of the live
// edges, on a grid sized for all n_rows rows (so it holds their split
// whatever their count), then the sum of the partial rows of the receivers
// that cross a tile (its blocks at or past the live edges exit): two
// launches (one for a single tile).
template <Entry E>
int launch(const bf16* src, const bf16* we, const bf16* be, const bf16* pxj,
           const bf16* pxi, const int* senders, const int* rowptr,
           const bf16* w_rest, const bf16* b_rest, const bf16* w_out,
           const bf16* b_out, const float* ln_s, const float* ln_b, float* out,
           float* part, int n_nodes, int n_rows, int l1,
           cudaStream_t stream) {
  int cap = 0, launches = 0;
  cudaError_t err = fwd_cap<E>(&cap);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes > 0 && n_rows > 0) {
    const int n_tiles = (n_rows + kTE - 1) / kTE;
    wgmma_fwd_kernel<E><<<split_blocks(n_rows, cap), kThreads,
                          Layout<E>::bytes(l1), stream>>>(
        src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
        ln_s, ln_b, out, part, n_nodes, n_rows, l1, cap);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ++launches;
    if (n_tiles > 1) {
      csr_tile::cross_tile_sum_kernel<kTE, kW><<<n_tiles - 1, kW, 0, stream>>>(
          rowptr, part, out, n_nodes, n_rows);
      ++launches;
    }
  }
  last_launches.store(launches, std::memory_order_relaxed);
  return (int)cudaGetLastError();
}

}  // namespace fwd

// ---- backward --------------------------------------------------------------

namespace bwd {

constexpr int kMaxCtas = kMaxL1 + 2;        // W_e (fold), W_1 .. W_L1, W_out
constexpr int kRing = 2 * (kMaxL1 + 1);     // the deepest stash, in tiles
constexpr int kIdxRing = 2 * kMaxCtas + 1;  // tiles of indices kept
constexpr int kTileBytes = kTE * kLd * 2;   // one padded bf16 (kTE, kW) tile

// Offsets, in bytes, into a CTA's dynamic shared memory (231,936 bytes: one
// CTA an SM): its weight, its ring of input tiles, the two tiles of the
// gradient the next CTA sends back, a staging tile (the pre-gathered first
// CTA's pxi rows) and the ring of tile indices.  The output CTA keeps in
// its ring past its two slots the f32 y tile, two tiles of g rows (this
// step's and the next's, f32) and LayerNorm's row statistics, and bf16(dy)
// in its first gradient tile (no CTA sends it one); the fold's first CTA
// stages in its ring e0 (slots 0-1 for the forward's tiles, 2-3 for the
// backward's) and the node rows pxj[s] (4-5) and pxi[r] (6-7).  The sums'
// halves go at the end into the gradient tiles.
struct Layout {
  static constexpr int w = 0;                               // bf16 (kW, kLd)
  static constexpr int ring = w + kW * kLd * 2;             // kRing tiles
  static constexpr int in = ring + kRing * kTileBytes;      // 2 tiles
  static constexpr int stage = in + 2 * kTileBytes;         // 1 tile
  static constexpr int idx = stage + kTileBytes;   // kIdxRing x 2 kTE int
  static constexpr int bytes = idx + kIdxRing * 2 * kTE * 4;
  static constexpr int y = ring + 2 * kTileBytes;           // f32 (kTE, kLdF)
  static constexpr int g = y + kTE * kLdF * 4;              // 2 f32 tiles
  static constexpr int stat = g + 2 * kTE * kLdF * 4;       // 4 kTE f32
  static constexpr int part = in;                           // 8 kW f32, last
};
static_assert(Layout::stat + 4 * kTE * 4 <= Layout::in, "y, g in the ring");
static_assert(8 * kW * 4 <= 2 * kTileBytes, "the sums in the gradient tiles");


// ---- thread block clusters ----------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
// Every thread of every CTA of the cluster arrives, its shared-memory
// writes (local and remote) released; then waits for all, acquiring them.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The shared::cluster address of `p`'s place in CTA `rank`'s shared memory
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_remote(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" :: "r"(addr), "r"(v)
               : "memory");
}

// acc += x^T . d over a tile's kTE edges, x and d (kTE, kW) bf16 tiles both
// read down their columns by ldmatrix.trans: warp w forms rows 32 (w & 3)
// .. + 31 and columns 64 (w >> 2) .. + 63 of the (kW x kW) weight gradient,
// 64 f32 accumulators a thread.
__device__ __forceinline__ void wgrad_tile(float (&acc)[2][8][4],
                                           const bf16* x, const bf16* d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = 32 * (warp & 3), n0 = 64 * (warp >> 2);
  // lane addresses of the ldmatrix.trans blocks: A(m, k) = x[k kLd + m],
  // B(k, n) = d[k kLd + n]
  const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * kLd + m0 +
                    (((lane >> 3) & 1) << 3);
  const int d_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLd + n0 +
                    ((lane >> 4) << 3);
#pragma unroll
  for (int k0 = 0; k0 < kTE; k0 += 16) {
    uint32_t fa[2][4], fb[4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_t(fa[mi], x + a_off + k0 * kLd + 16 * mi);
#pragma unroll
    for (int j = 0; j < 4; ++j) ldsm_t(fb[j], d + d_off + k0 * kLd + 16 * j);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        mma(acc[mi][ni], fa[mi], fb[ni >> 1][2 * (ni & 1)],
            fb[ni >> 1][2 * (ni & 1) + 1]);
  }
}

struct Args {
  const bf16* src;     // (E, kW) e0 (fold), pe (pe) or h0 (pregathered)
  const bf16* we;      // fold
  const bf16* be;      // fold
  const bf16* pxj;     // fold, pe
  const bf16* pxi;
  const int* senders;  // fold, pe
  const int* rowptr;
  const bf16* w_rest;
  const bf16* b_rest;
  const bf16* w_out;
  const bf16* b_out;
  const float* ln_s;
  const float* g;      // (N, kW) the output's cotangent
  bf16* d_src;         // (E, kW) d_e0, d_pe or d_h0
  float* dz32;         // pe: (E, kW) dz unrounded
  float* d_pxj;        // fold: (N, kW), added into
  float* d_pxi;        // (N, kW), added into
  float* partial;      // a row of `total` floats a cluster
  int total;
  int n_nodes;
  int n_rows;          // E, the edge rows: the live edges and a dead tail
  int l1;
  int cap;             // the clusters a launch of many tiles runs
};

// The backward of one call as a pipeline over a cluster of n CTAs, one a
// weight (CTA p holds packed weight p: W_e (fold), W_1 .. W_L1, W_out), each
// on one SM, its weight resident.  Cluster c walks its consecutive tiles
// t = 0 .. cnt - 1 in steps; in step s CTA p runs
//   * the forward of tile s - p: h_p = bf16(relu(x . W + b)) of its input
//     x = h_{p-1} (or, the output CTA, y = x . W_out + b_out and LayerNorm's
//     backward to bf16(dy)), sent on into CTA p + 1's ring;
//   * the backward of tile s - (2 n - 2 - p), whose bf16 gradient d CTA p +
//     1 sent in the step before: dW += x^T . d on the x of its ring, and da
//     = (d . W^T) masked by x > 0, sent back into CTA p - 1's gradient
//     tiles;
// then all n meet at one cluster barrier.  The clusters split the live
// edges' tiles as an unpadded launch would (split_blocks over a.cap); a
// cluster past that split exits, every CTA of it together, before its first
// barrier.  A tile's x waits in the ring of
// CTA p from its forward to its backward, 2 (n - p) slots (the first CTA's
// 2 n, counting the tile its rows are staged for); the first CTA also forms
// h_0 (pe, pregathered) or re-reads e0 (fold), writes d_src (and the pe's
// dz32), and adds bf16(dz) into d_pxi (and, fold, d_pxj) with atomics.
// The recompute runs the forward's products in its order from the same
// initial values, so the h_k have the forward's bits.  At the end each CTA
// writes its dW (and its bias sums) once into the cluster's row of
// `partial`.
template <Entry E>
__global__ void __launch_bounds__(kThreads, 1) cluster_bwd_kernel(Args a) {
  using L = Layout;
  constexpr bool FOLD = E == kFold, GATHERS = E != kPregathered;
  extern __shared__ __align__(16) unsigned char bf16w_bwd_smem[];
  unsigned char* sm = bf16w_bwd_smem;
  bf16* s_w = reinterpret_cast<bf16*>(sm + L::w);
  bf16* s_ring = reinterpret_cast<bf16*>(sm + L::ring);
  bf16* s_in = reinterpret_cast<bf16*>(sm + L::in);
  bf16* s_stage = reinterpret_cast<bf16*>(sm + L::stage);
  int* s_idx = reinterpret_cast<int*>(sm + L::idx);
  float* s_part = reinterpret_cast<float*>(sm + L::part);
  float* s_stat = reinterpret_cast<float*>(sm + L::stat);
  float* s_y = reinterpret_cast<float*>(sm + L::y);
  const int tid = threadIdx.x, warp = tid >> 5;
  // the live edges, the load issued now and read after the weight's copies
  // are issued; the rows past them (a padded graph's) are not read
  const int n_edges = tile128::live_edges(a.rowptr, a.n_nodes, a.n_rows);

  const int n = (FOLD ? 1 : 0) + a.l1 + 1;  // CTAs a cluster, weights
  const int p = cluster_rank();
  const bool first = p == 0, out = p == n - 1;
  const bf16* w = FOLD && first ? a.we
                  : out         ? a.w_out
                                : a.w_rest + (size_t)(p - FOLD) * kW * kW;
  const bf16* bias = FOLD && first ? a.be
                     : out         ? a.b_out
                                   : a.b_rest + (size_t)(p - FOLD) * kW;
  // the weight, by cp.async (committed with tile 0's rows below)
  for (int q = tid; q < kW * kW / 8; q += kThreads) {
    const int r = q >> 4, col = (q & 15) * 8;
    cp_async16(s_w + r * kLd + col, w + r * kW + col, true);
  }
  // the dead rows' d_src (and the pe's dz32) zero, every CTA a share; the
  // cluster's tiles [t_beg, t_beg + cnt) of the live edges, balanced over
  // the clusters the launch takes for them alone (split_blocks): a cluster
  // past those holds no tile and writes no partial row, and all its CTAs
  // exit here, before their first cluster barrier, once their copies have
  // landed
  zero_dead_rows<kW * 2>(a.d_src, n_edges, a.n_rows);
  if constexpr (E == kPe) zero_dead_rows<kW * 4>(a.dz32, n_edges, a.n_rows);
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int c = blockIdx.x / n, nc = split_blocks(n_edges, a.cap);
  if (c >= nc) {
    cp_async_commit();  // the weight's copies, a group of their own here
    cp_async_wait<0>();
    return;
  }
  const int depth = first ? 2 * n : 2 * (n - p);  // this CTA's ring
  const int depth_next = 2 * (n - p - 1);         // CTA p + 1's
  const int lag = 2 * n - 2;  // steps from a tile's forward on CTA 0 to its
                              // backward there
  const int t_beg = (int)((long long)c * n_tiles / nc);
  const int cnt = (int)((long long)(c + 1) * n_tiles / nc) - t_beg;
  const int n_steps = cnt > 0 ? cnt + lag : 0;

  auto tile_at = [&](bf16* base, int slot) { return base + slot * kTE * kLd; };
  auto ring = [&](int t) { return tile_at(s_ring, t % depth); };
  // fold, first CTA: e0 of forward tile t, of backward tile t
  auto e0_fwd = [&](int t) { return tile_at(s_ring, t & 1); };
  auto e0_bwd = [&](int t) { return tile_at(s_ring, 2 + (t & 1)); };
  // fold, first CTA: the pxj[s] and pxi[r] rows of forward tile t
  auto pxj_rows = [&](int t) { return tile_at(s_ring, 4 + (t & 1)); };
  auto pxi_rows = [&](int t) { return tile_at(s_ring, 6 + (t & 1)); };
  // out: the g rows of tile t
  auto g_rows = [&](int t) {
    return reinterpret_cast<float*>(sm + L::g) + (t & 1) * kTE * kLdF;
  };
  auto rcv_of = [&](int t) { return s_idx + (t % kIdxRing) * 2 * kTE; };
  auto snd_of = [&](int t) { return rcv_of(t) + kTE; };
  auto valid_rows = [&](int t) {
    return min(kTE, n_edges - (t_beg + t) * kTE);
  };
  // tile t's rows of src into dst by cp.async, zeros past the edge count
  auto stage = [&](bf16* dst, int t) {
    const int base = (t_beg + t) * kTE, nv = valid_rows(t);
    for (int q = tid; q < kPieces; q += kThreads) {
      const int r = q >> 4, col = (q & 15) * 8;
      piece_async(dst + r * kLd + col,
                  r < nv ? a.src + (size_t)(base + r) * kW + col : nullptr,
                  a.src);
    }
  };
  // tile t's node rows of `table` (rows of kW bf16) at its receivers or
  // senders `at` into dst by cp.async, zeros past the edge count
  auto stage_nodes = [&](bf16* dst, const bf16* table, const int* at, int t) {
    const int nv = valid_rows(t);
    for (int q = tid; q < kPieces; q += kThreads) {
      const int r = q >> 4, col = (q & 15) * 8;
      piece_async(dst + r * kLd + col,
                  r < nv ? table + (size_t)at[r] * kW + col : nullptr, table);
    }
  };
  // out: tile t's g rows (f32) at its receivers into g_rows(t)
  auto stage_g = [&](int t) {
    const int nv = valid_rows(t);
    const int* rcv = rcv_of(t);
    float* dst = g_rows(t);
    for (int q = tid; q < kTE * kW / 4; q += kThreads) {
      const int r = q >> 5, col = (q & 31) * 4;
      cp_async16(dst + r * kLdF + col,
                 a.g + (r < nv ? (size_t)rcv[r] * kW + col : 0), r < nv);
    }
  };
  // the cp.async copies of tile t's rows that the first and the output
  // CTAs read in its forward (the pre-gathered first CTA's pxi rows apart)
  auto stage_forward = [&](int t) {
    if (first) stage(FOLD ? e0_fwd(t) : ring(t), t);
    if (FOLD && first) {
      stage_nodes(pxj_rows(t), a.pxj, snd_of(t), t);
      stage_nodes(pxi_rows(t), a.pxi, rcv_of(t), t);
    }
    if (out) stage_g(t);
  };
  // warp w < 2's edges of tile t: the first and their count
  auto warp_base = [&](int t) { return (t_beg + t) * kTE + 32 * warp; };
  auto warp_valid = [&](int t) { return min(32, n_edges - warp_base(t)); };
  // d_pxi[r] += d over each run of equal receivers in each half of the
  // tile (one atomicAdd a run and column), fold also d_pxj[s] += d (one an
  // element): d is bf16(dz) of tile t
  auto scatter = [&](const bf16* d, int t, int nv) {
    const int* rcv = rcv_of(t);
    const int* snd = snd_of(t);
    const int col = tid & (kW - 1);
    const int e_beg = (tid >> 7) * (kTE / 2);
    const int e_end = min(e_beg + kTE / 2, nv);
    if (e_beg >= e_end) return;
    int at = rcv[e_beg];
    float sum = 0.f;
    for (int e = e_beg; e < e_end; ++e) {
      const float v = __bfloat162float(d[e * kLd + col]);
      if (FOLD) atomicAdd(a.d_pxj + (size_t)snd[e] * kW + col, v);
      if (rcv[e] != at) {
        atomicAdd(a.d_pxi + (size_t)at * kW + col, sum);
        sum = 0.f;
        at = rcv[e];
      }
      sum += v;
    }
    atomicAdd(a.d_pxi + (size_t)at * kW + col, sum);
  };

  // the indices of tiles 0 and 1 (tile 0's searched afresh) and tile 0's
  // rows
  const bool indexer = (first || out) && warp < 2;
  if (n_steps > 0 && indexer)
    tile128::tile_indices<kTE, GATHERS>(rcv_of(0), snd_of(0), a.senders,
                                        a.rowptr, a.n_nodes, n_edges, t_beg,
                                        -1);
  __syncthreads();
  if (cnt > 1 && indexer)
    tile128::tile_indices<kTE, GATHERS>(rcv_of(1), snd_of(1), a.senders,
                                        a.rowptr, a.n_nodes, n_edges,
                                        t_beg + 1, rcv_of(0)[kTE - 1]);
  if (n_steps > 0) {
    stage_forward(0);
    if (first && E == kPregathered) stage_nodes(s_stage, a.pxi, rcv_of(0), 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  cluster_sync();  // every CTA runs before any writes into another

  float dw[2][8][4] = {};  // dW over the cluster's tiles
  float sums[4][2] = {};   // p >= 1: column sums of the unrounded da
  float ln_sums[3] = {};   // out: db_out, d_ln_s, d_ln_b, column tid & 127
  const float ls = out ? __ldg(a.ln_s + (tid & (kW - 1))) : 0.f;

  for (int s = 0; s < n_steps; ++s) {
    const int tf = s - p, tb = s - (lag - p);
    // this step's rows are in (staged in the step before); the next step's
    // are staged in this one, from the next tile's indices (found in the
    // step before); the pre-gathered first CTA stages its next pxi rows once
    // it has formed h_0
    cp_async_wait<0>();
    if (first || out) __syncthreads();
    if (tf >= 0 && tf + 1 < cnt) stage_forward(tf + 1);
    if (FOLD && first && tb + 1 >= 0 && tb + 1 < cnt)
      stage(e0_bwd(tb + 1), tb + 1);
    // the indices of the tile after the next, warps 0 and 1, from the
    // receiver of the next tile's last edge (a whole tile: only the graph's
    // last is short)
    const int t_idx = tf + 2;
    const bool next_idx = indexer && tf >= 0 && t_idx < cnt;
    const int hint = next_idx ? rcv_of(t_idx - 1)[kTE - 1] : 0;
    IndexLoad next;
    if (next_idx)
      next.issue<GATHERS>(a.rowptr, a.senders, a.n_nodes, warp_base(t_idx),
                          warp_valid(t_idx), hint);

    // ---- the forward of tile tf
    if (tf >= 0 && tf < cnt) {
      const int nv = valid_rows(tf);
      const int* rcv = rcv_of(tf);
      const int* snd = snd_of(tf);
      if (first && !FOLD) {
        // h_0 = bf16(relu((pe + pxj[s]) + pxi[r])) (pe), bf16(relu(h0 +
        // pxi[r])) (pregathered), in place over the staged rows, zero past
        // the edge count
        bf16* h = ring(tf);
        for (int q = tid; q < kPieces; q += kThreads) {
          const int r = q >> 4, col = (q & 15) * 8;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (r < nv) {
            const uint4 x0 = *reinterpret_cast<const uint4*>(h + r * kLd + col);
            const uint4 j =
                GATHERS ? __ldg(reinterpret_cast<const uint4*>(
                              a.pxj + (size_t)snd[r] * kW + col))
                        : x0;
            const uint4 i =
                GATHERS ? __ldg(reinterpret_cast<const uint4*>(
                              a.pxi + (size_t)rcv[r] * kW + col))
                        : *reinterpret_cast<const uint4*>(s_stage + r * kLd +
                                                          col);
            v = first_layer8<GATHERS>(x0, j, i);
          }
          *reinterpret_cast<uint4*>(h + r * kLd + col) = v;
        }
        __syncthreads();
      }
      if (first && E == kPregathered && tf + 1 < cnt)
        stage_nodes(s_stage, a.pxi, rcv_of(tf + 1), tf + 1);
      float acc[2][4][4];
      if (FOLD && first)
        fold_init_rows(acc, a.be, pxj_rows(tf), pxi_rows(tf), nv);
      else
        bias_init(acc, bias);
      mm_tile<kW, false>(acc, FOLD && first ? e0_fwd(tf) : ring(tf), s_w);
      if (!out) {
        const uint32_t dst =
            remote(tile_at(s_ring, tf % depth_next), p + 1);
        acc_pairs(acc, [&](int r, int col, float v0, float v1) {
          st_remote(dst + 2 * (r * kLd + col),
                    pack_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f)));
        });
      } else {
        acc_pairs(acc, [&](int r, int col, float v0, float v1) {
          *reinterpret_cast<float2*>(s_y + r * kLdF + col) =
              make_float2(v0, v1);
        });
        __syncthreads();  // y written
        // LayerNorm's row statistics, four threads an edge (thread q holds
        // columns q + 4 j): mean, rstd, and m1 = mean(dx), m2 = mean(dx
        // xhat) of dx = bf16(g[i]) ln_s; bf16(g) in place of g (zero past
        // the edge count)
        {
          constexpr int CP = kW / 4;
          const int e = tid >> 2, q = tid & 3;
          const bool valid = e < nv;
          const float* row = s_y + e * kLdF;
          float* grow = g_rows(tf) + e * kLdF;
          float v[CP];
          float mu = 0.f;
#pragma unroll
          for (int j = 0; j < CP; ++j) {
            v[j] = row[q + 4 * j];
            mu += v[j];
          }
          mu += __shfl_xor_sync(0xffffffffu, mu, 1);
          mu += __shfl_xor_sync(0xffffffffu, mu, 2);
          mu *= 1.f / kW;
          float var = 0.f;
#pragma unroll
          for (int j = 0; j < CP; ++j) {
            const float d = v[j] - mu;
            var = fmaf(d, d, var);
          }
          var += __shfl_xor_sync(0xffffffffu, var, 1);
          var += __shfl_xor_sync(0xffffffffu, var, 2);
          var *= 1.f / kW;
          const float rstd = rsqrtf(var + kLnEps);
          float m1 = 0.f, m2 = 0.f;
#pragma unroll
          for (int j = 0; j < CP; ++j) {
            const int col = q + 4 * j;
            const float gv = valid ? round_bf16(grow[col]) : 0.f;
            grow[col] = gv;
            const float dx = gv * __ldg(a.ln_s + col);
            m1 += dx;
            m2 = fmaf(dx, (v[j] - mu) * rstd, m2);
          }
          m1 += __shfl_xor_sync(0xffffffffu, m1, 1);
          m1 += __shfl_xor_sync(0xffffffffu, m1, 2);
          m2 += __shfl_xor_sync(0xffffffffu, m2, 1);
          m2 += __shfl_xor_sync(0xffffffffu, m2, 2);
          if (q == 0) {
            s_stat[4 * e] = mu;
            s_stat[4 * e + 1] = rstd;
            s_stat[4 * e + 2] = m1 * (1.f / kW);
            s_stat[4 * e + 3] = m2 * (1.f / kW);
          }
        }
        __syncthreads();
        // dy = rstd (dx - m1 - xhat m2), a thread a column over half the
        // tile's rows, eight rows a batch (their loads before their
        // stores): bf16(dy) into the first gradient tile (zero past the
        // edge count), and the sums of dy, bf16(g) xhat and bf16(g)
        {
          const int col = tid & (kW - 1);
          const int e_beg = (tid >> 7) * (kTE / 2);
          const float* gt = g_rows(tf);
          for (int e0 = e_beg; e0 < e_beg + kTE / 2; e0 += 8) {
            float yv[8], gv[8];
            float4 st[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              yv[i] = s_y[(e0 + i) * kLdF + col];
              gv[i] = gt[(e0 + i) * kLdF + col];
              st[i] = *reinterpret_cast<const float4*>(s_stat + 4 * (e0 + i));
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              float dy = 0.f;
              if (e0 + i < nv) {
                const float xhat = (yv[i] - st[i].x) * st[i].y;
                dy = st[i].y * (gv[i] * ls - st[i].z - xhat * st[i].w);
                ln_sums[0] += dy;
                ln_sums[1] += gv[i] * xhat;
                ln_sums[2] += gv[i];
              }
              s_in[(e0 + i) * kLd + col] = __float2bfloat16_rn(dy);
            }
          }
        }
        __syncthreads();  // bf16(dy) written
      }
    }

    cp_async_commit();

    // ---- the backward of tile tb
    if (tb >= 0 && tb < cnt) {
      const int nv = valid_rows(tb);
      const size_t base = (size_t)(t_beg + tb) * kTE;
      bf16* d = out ? s_in : tile_at(s_in, tb & 1);
      const bf16* x = FOLD && first ? e0_bwd(tb) : ring(tb);
      wgrad_tile(dw, x, d);
      float acc[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
      mm_tile<kW, true>(acc, d, s_w);
      if (FOLD && first) {
        // d_e0 = bf16(bf16(dz) . W_e^T)
        acc_pairs(acc, [&](int r, int col, float v0, float v1) {
          if (r < nv)
            *reinterpret_cast<uint32_t*>(a.d_src + (base + r) * kW + col) =
                pack_rn(v0, v1);
        });
        scatter(d, tb, nv);
      } else {
        // da = (d . W^T) where x > 0; its unrounded column sums (the bias
        // gradient of the layer before, p >= 1)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 m = unpack(*reinterpret_cast<const uint32_t*>(
                  x + acc_row(mi, 2 * h) * kLd + acc_col(ni, 0)));
              float& v0 = acc[mi][ni][2 * h];
              float& v1 = acc[mi][ni][2 * h + 1];
              v0 = m.x > 0.f ? v0 : 0.f;
              v1 = m.y > 0.f ? v1 : 0.f;
              sums[ni][0] += v0;
              sums[ni][1] += v1;
            }
        if (!first) {
          const uint32_t dst = remote(tile_at(s_in, tb & 1), p - 1);
          acc_pairs(acc, [&](int r, int col, float v0, float v1) {
            st_remote(dst + 2 * (r * kLd + col), pack_rn(v0, v1));
          });
        } else {
          // dz: the pe's dz32; bf16(dz) over d (every warp has read it),
          // then d_src and the scatter from it
          if (E == kPe)
            acc_pairs(acc, [&](int r, int col, float v0, float v1) {
              if (r < nv)
                *reinterpret_cast<float2*>(a.dz32 + (base + r) * kW + col) =
                    make_float2(v0, v1);
            });
          __syncthreads();
          acc_pairs(acc, [&](int r, int col, float v0, float v1) {
            *reinterpret_cast<uint32_t*>(d + r * kLd + col) = pack_rn(v0, v1);
          });
          __syncthreads();
          for (int q = tid; q < kPieces; q += kThreads) {
            const int r = q >> 4, col = (q & 15) * 8;
            if (r < nv)
              *reinterpret_cast<uint4*>(a.d_src + (base + r) * kW + col) =
                  *reinterpret_cast<const uint4*>(d + r * kLd + col);
          }
          scatter(d, tb, nv);
        }
      }
    }
    if (next_idx)
      next.finish<GATHERS>(rcv_of(t_idx) + 32 * warp,
                           snd_of(t_idx) + 32 * warp, a.rowptr, a.n_nodes,
                           warp_base(t_idx), warp_valid(t_idx), hint);
    cluster_sync();
  }

  // this CTA's partials, once, into the cluster's row: dW at packed weight
  // p, the bias sums in the bias row after the n weights
  float* row = a.partial + (size_t)c * a.total;
  {
    const int m0 = 32 * (warp & 3), n0 = 64 * (warp >> 2);
    float* pw = row + (size_t)p * kW * kW;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pw[(m0 + 16 * mi + lane_g() + 8 * (q >> 1)) * kW + n0 + 8 * ni +
             2 * lane_t() + (q & 1)] = dw[mi][ni][q];
  }
  float* pb = row + (size_t)n * kW * kW;
  if (p >= 1) {
    // the two halves of the rows (warps w, w ^ 1) added in order
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          sums[ni][k] += __shfl_xor_sync(0xffffffffu, sums[ni][k], o);
    if (lane_g() == 0)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          s_part[(warp & 1) * kW + acc_col(ni, k)] = sums[ni][k];
  }
  if (out)  // the halves of the rows, added in order below
#pragma unroll
    for (int k = 0; k < 3; ++k)
      s_part[2 * kW + (tid >> 7) * 3 * kW + k * kW + (tid & (kW - 1))] =
          ln_sums[k];
  __syncthreads();
  if (p >= 1 && tid < kW)
    pb[(size_t)(p - 1) * kW + tid] = s_part[tid] + s_part[kW + tid];
  if (out)
    for (int q = tid; q < 3 * kW; q += kThreads)
      pb[(size_t)(n - 1) * kW + q] =
          s_part[2 * kW + q] + s_part[2 * kW + 3 * kW + q];
}

// The active clusters of n CTAs the card holds at once, with the
// shared-memory opt-in, once per device and n (`cache`, zeros: unset).
template <Entry E>
cudaError_t max_clusters(int n, int* clusters) {
  static std::atomic<int> cache[kMaxDevices][kMaxCtas + 1];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int v = device < kMaxDevices
              ? cache[device][n].load(std::memory_order_relaxed)
              : 0;
  if (v == 0) {
    int optin = 0;
    if ((err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
        cudaSuccess)
      return err;
    if (Layout::bytes > optin) return cudaErrorInvalidValue;
    if ((err = cudaFuncSetAttribute(
             cluster_bwd_kernel<E>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, Layout::bytes)) !=
        cudaSuccess)
      return err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(n);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Layout::bytes;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if ((err = cudaOccupancyMaxActiveClusters(&v, cluster_bwd_kernel<E>,
                                              &cfg)) != cudaSuccess)
      return err;
    if (v < 1) return cudaErrorInvalidConfiguration;
    if (device < kMaxDevices)
      cache[device][n].store(v, std::memory_order_relaxed);
  }
  *clusters = v;
  return cudaSuccess;
}

// The packed gradient buffer, in floats: the n weights' gradients (dW_e
// (fold), dW_1 .. dW_L1, dW_out), then the bias row (db_e (fold), db_1 ..
// db_L1, db_out, d_ln_s, d_ln_b).
__host__ __device__ constexpr int packed_floats(int n) {
  return n * kW * kW + (n + 2) * kW;
}

// The backward as two launches: the cluster pipeline (one cluster of n
// CTAs per range of consecutive tiles of the live edges, as many clusters as
// the card holds at once, at most one a tile and n_sm / n in all: the cap,
// the grid sized for all n_rows rows so that it holds the live edges' split
// whatever their count), then the live clusters' partial rows added in
// cluster order, so that the weight and bias gradients are the same from
// run to run.
// the kernels the last call of launch() launched
std::atomic<int> last_launches{0};

template <Entry E>
int launch(Args a, float* wgrad, int n_sm, cudaStream_t stream) {
  const int n = (E == kFold ? 1 : 0) + a.l1 + 1;
  int launches = 0;
  a.total = packed_floats(n);
  if (a.n_nodes == 0) a.n_rows = 0;
  cudaError_t err = cudaSuccess;
  if (a.n_rows > 0) {
    int cap = 0;
    if ((err = max_clusters<E>(n, &cap)) != cudaSuccess) return (int)err;
    const int per_sms = n_sm / n > 1 ? n_sm / n : 1;
    a.cap = cap < per_sms ? cap : per_sms;
    const int nc = split_blocks(a.n_rows, a.cap);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(n * nc);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Layout::bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if ((err = cudaLaunchKernelEx(&cfg, cluster_bwd_kernel<E>, a)) !=
        cudaSuccess)
      return (int)err;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ++launches;
  }
  reduce_partials_kernel<<<(a.total + 255) / 256, 256, 0, stream>>>(
      a.partial, wgrad, a.rowptr, a.n_nodes, a.n_rows, a.cap, a.total);
  last_launches.store(++launches, std::memory_order_relaxed);
  return (int)cudaGetLastError();
}

}  // namespace bwd

}  // namespace

extern "C" {

// The forward.  Returns a cudaError_t; 0 is success.  Launches on `stream`
// and does not synchronise.  entry (a tile128::Entry): kFold, src is e0
// (n_edges, 128) and we, be are read; kPe, src is pe (n_edges, 128) and we,
// be are ignored; kPregathered, src is h0 (n_edges, 128) and we, be, pxj,
// senders are ignored.  src, pxj and pxi (n_nodes, 128) are 16-byte aligned
// bf16; we, be, w_rest, b_rest, w_out, b_out bf16; ln_s, ln_b f32; out
// (n_nodes, 128) f32 must arrive zeroed; part is f32 scratch of 2 *
// ceil(n_edges / 64) rows of 128.  The edges are the first
// rowptr[n_nodes] <= n_edges rows, read on the card: the rows after them (a
// padded graph's) are not read, and the backward writes zeros into their
// gradient rows.  Built for l1 in 0..3; others return
// cudaErrorInvalidValue.
int fused_edge_tail_agg_bf16_w128_fwd(
    const bf16* src, const bf16* we, const bf16* be, const bf16* pxj,
    const bf16* pxi, const int* senders, const int* rowptr,
    const bf16* w_rest, const bf16* b_rest, const bf16* w_out,
    const bf16* b_out, const float* ln_s, const float* ln_b, float* out,
    float* part, int n_nodes, int n_edges, int l1, int entry, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l1 < 0 || l1 > kMaxL1 || part == nullptr)
    return (int)cudaErrorInvalidValue;
  if (entry == kPregathered)
    return fwd::launch<kPregathered>(src, nullptr, nullptr, nullptr, pxi,
                                     nullptr, rowptr, w_rest, b_rest, w_out,
                                     b_out, ln_s, ln_b, out, part, n_nodes,
                                     n_edges, l1, s);
  if (pxj == nullptr || senders == nullptr) return (int)cudaErrorInvalidValue;
  if (entry == kFold && we != nullptr && be != nullptr)
    return fwd::launch<kFold>(src, we, be, pxj, pxi, senders, rowptr, w_rest,
                              b_rest, w_out, b_out, ln_s, ln_b, out, part,
                              n_nodes, n_edges, l1, s);
  if (entry == kPe)
    return fwd::launch<kPe>(src, we, be, pxj, pxi, senders, rowptr, w_rest,
                            b_rest, w_out, b_out, ln_s, ln_b, out, part,
                            n_nodes, n_edges, l1, s);
  return (int)cudaErrorInvalidValue;
}

// The backward, its operands as the forward's, and g (n_nodes, 128) f32.
// Writes d_src (n_edges, 128) bf16 (fold: d_e0; pe: d_pe = bf16(dz);
// pregathered: d_h0 = bf16(dz)) and, pe, dz32 (n_edges, 128) f32, dz
// unrounded (pregathered ignores dz32 and d_pxj); adds into d_pxi and,
// fold, d_pxj (n_nodes, 128) f32, which must arrive zeroed; wgrad (f32) holds,
// packed, dW_e (fold), dW_rest (l1, 128, 128), dW_out, then db_e (fold),
// db_rest (l1, 128), db_out, d_ln_s, d_ln_b.  partial is f32 scratch of
// max(1, n_sm / n) rows of those packed floats, n = (fold) + l1 + 1 the
// CTAs of a cluster.  scratch is not read and may be null (it stays in the
// argument list so that a timing script calls builds of other trees the
// same way).  n_sm is the card's SM count.  Two launches.  Built for l1 in
// 0..3.
int fused_edge_tail_agg_bf16_w128_bwd(
    const bf16* src, const bf16* we, const bf16* be, const bf16* pxj,
    const bf16* pxi, const int* senders, const int* rowptr,
    const bf16* w_rest, const bf16* b_rest, const bf16* w_out,
    const bf16* b_out, const float* ln_s, const float* g, bf16* d_src,
    float* dz32, float* d_pxj, float* d_pxi, float* wgrad, float* partial,
    bf16* scratch, int n_nodes, int n_edges, int l1, int entry, int n_sm,
    void* stream) {
  (void)scratch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l1 < 0 || l1 > kMaxL1 || n_sm < 1 || partial == nullptr)
    return (int)cudaErrorInvalidValue;
  bwd::Args a{};
  a.src = src;
  a.pxi = pxi;
  a.rowptr = rowptr;
  a.w_rest = w_rest;
  a.b_rest = b_rest;
  a.w_out = w_out;
  a.b_out = b_out;
  a.ln_s = ln_s;
  a.g = g;
  a.d_src = d_src;
  a.d_pxi = d_pxi;
  a.partial = partial;
  a.n_nodes = n_nodes;
  a.n_rows = n_edges;
  a.l1 = l1;
  if (entry == kPregathered)
    return bwd::launch<kPregathered>(a, wgrad, n_sm, s);
  if (pxj == nullptr || senders == nullptr) return (int)cudaErrorInvalidValue;
  a.pxj = pxj;
  a.senders = senders;
  if (entry == kFold && we != nullptr && be != nullptr && d_pxj != nullptr) {
    a.we = we;
    a.be = be;
    a.d_pxj = d_pxj;
    return bwd::launch<kFold>(a, wgrad, n_sm, s);
  }
  if (entry == kPe && dz32 != nullptr) {
    a.dz32 = dz32;
    return bwd::launch<kPe>(a, wgrad, n_sm, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block takes: the fold forward at L1 = 3 (which =
// 0), a CTA of the backward's cluster (1); -1 for any other.
int fused_edge_tail_agg_bf16_w128_smem(int which) {
  switch (which) {
    case 0: return fwd::Layout<kFold>::bytes(kMaxL1);
    case 1: return bwd::Layout::bytes;
    default: return -1;
  }
}

// Dynamic shared memory a forward block of `entry` takes at l1 tail
// layers; -1 for an entry or l1 not built.
int fused_edge_tail_agg_bf16_w128_fwd_smem(int entry, int l1) {
  if (l1 < 0 || l1 > kMaxL1) return -1;
  switch (entry) {
    case kFold: return fwd::Layout<kFold>::bytes(l1);
    case kPe: return fwd::Layout<kPe>::bytes(l1);
    case kPregathered: return fwd::Layout<kPregathered>::bytes(l1);
    default: return -1;
  }
}

// Kernels the last forward call launched, its own count: the walk and the
// sum of the partial rows (the walk alone for one tile; none without an
// edge).
int fused_edge_tail_agg_bf16_w128_fwd_launches(void) {
  return fwd::last_launches.load(std::memory_order_relaxed);
}

// The blocks a forward call of `entry` over n_edges launches on this
// device: min(tiles, SMs x the blocks an SM holds), or a negative
// cudaError_t.
int fused_edge_tail_agg_bf16_w128_fwd_blocks(int entry, int n_edges) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (entry) {
    case kFold: err = fwd::grid<kFold>(n_edges, &blocks); break;
    case kPe: err = fwd::grid<kPe>(n_edges, &blocks); break;
    case kPregathered: err = fwd::grid<kPregathered>(n_edges, &blocks); break;
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

// The kernels the last backward call launched (the cluster pipeline and the
// sum of its partial rows: 2; 1 when there was no edge).
int fused_edge_tail_agg_bf16_w128_bwd_launches(void) {
  return bwd::last_launches.load(std::memory_order_relaxed);
}

// The backward's cluster on this device for `entry` and l1: its CTAs (one
// a weight) and the clusters the card holds at once, into *ctas and
// *clusters.  Returns a cudaError_t.
int fused_edge_tail_agg_bf16_w128_bwd_clusters(int entry, int l1, int* ctas,
                                               int* clusters) {
  if (l1 < 0 || l1 > kMaxL1 || ctas == nullptr || clusters == nullptr)
    return (int)cudaErrorInvalidValue;
  *ctas = (entry == kFold ? 1 : 0) + l1 + 1;
  switch (entry) {
    case kFold: return (int)bwd::max_clusters<kFold>(*ctas, clusters);
    case kPe: return (int)bwd::max_clusters<kPe>(*ctas, clusters);
    case kPregathered:
      return (int)bwd::max_clusters<kPregathered>(*ctas, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
