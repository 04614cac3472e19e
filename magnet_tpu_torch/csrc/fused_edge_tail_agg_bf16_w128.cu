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
// Why not the width-64 bf16 design (csrc/fused_edge_tail_agg_bf16.cu),
// which keeps every weight resident twice: a padded bf16 128 x 128 weight
// is 34,816 bytes, five of them 174 KB once and 348 KB twice, against a
// block's 227 KB.  So the forward streams its weights and the backward is
// the f32 width-128 build's launch sequence (csrc/fused_edge_tail_agg_bwd.cu
// namespace w128), each on bf16 tensor-core products:
//   * every product is mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32, its
//     fragments read by ldmatrix from shared tiles whose bf16 rows are
//     padded to 136 elements (272 bytes: the eight rows of an ldmatrix
//     block fall on distinct banks).  One copy of a weight, as stored (in,
//     out), serves both products: h . W reads it by ldmatrix.trans, da .
//     W^T by plain ldmatrix (the transposing form works on 16-bit
//     elements, so no second copy); the weight gradients read both their
//     (edge, width) tiles down their columns by ldmatrix.trans;
//   * forward (#8, #6, #2): a persistent block of 256 threads walks consecutive
//     tiles of 64 CSR edges (tile128::block_tiles, tile_indices), warp w
//     forming rows 32 (w & 1) .. + 31 and columns 32 (w >> 1) .. + 31 of
//     each (64 x 128) product.  Each weight (W_e, W_1 .. W_L1, W_out) is
//     streamed through shared memory in chunks of 64 rows (17 KB) by a
//     cp.async double buffer, the next chunk (across layers and tiles)
//     loading while this one's product runs, one barrier a chunk; the next
//     tile's e0 / pe / h0 rows are staged in pieces over the chunk steps
//     once the staging tile is free.  The fold's first accumulators start
//     at b_e + (pxj[s] + pxi[i]), read through L2; the pe and pregathered
//     entries form h_0 elementwise from the staged rows and 16-byte loads
//     of the node rows.  y stays in an f32 tile for LayerNorm and the receiver sums,
//     which run over each run of equal receivers in CSR order (csr_tile):
//     no atomics, out has the same bits run to run.  104,448 bytes of
//     shared memory: two blocks an SM;
//   * backward (#9, #7, #3): (a) one pass per layer over every edge
//     (edge_pass_kernel, 64-edge tiles on a persistent grid, its weight
//     resident, the next tile's rows fetched by cp.async): the recompute
//     h_0 .. h_L1 (the pe and pregathered entries' h_0 by an elementwise
//     kernel), y and
//     LayerNorm's backward to dy, then da_L1 .. da_1 and dz through each
//     W^T masked by h > 0, and, fold, d_e0 = bf16(bf16(dz) . W_e^T).  The
//     recompute runs the forward's products in the forward's order, so its
//     h_k have the forward's bits.  Each h_k (bf16, exact) and each
//     bf16(da_k) is written once to a scratch plane of (E, 128) bf16,
//     2 L1 + 3 planes (fold) or 2 L1 + 2 (pe and pregathered, whose d_pe /
//     d_h0 is its bf16(dz));
//     the bias gradients, which sum the unrounded da_k, are summed in the
//     pass that forms da_k (and d_ln_s, d_ln_b in the LayerNorm pass), per
//     block in registers and written once a block; (b) wgrad_kernel, the
//     tall-skinny dW = sum_e A[e]^T D[e] of every weight over edge ranges,
//     A and D read from the planes in 64-edge slabs by a cp.async double
//     buffer, each block's (128 x 128) partial in 64 f32 accumulators a
//     thread; (c) the partials of (a) and (b) added in block order, so the
//     weight and bias gradients are the same from run to run.  The scatter
//     of bf16(dz) into d_pxi (one atomicAdd per run of equal receivers in
//     half a tile) and, fold, d_pxj (one per element) uses f32 atomics,
//     whose last bits vary before the caller's rounding to bf16.  Shared
//     memory: a pass 73,216 bytes (the LayerNorm pass 108,032), wgrad
//     69,632.
// What bounds it on an H100: at L1 = 3 the fold forward does Ce H + L1 H^2
// + H C = 81,920 multiply-adds an edge (pe and pregathered 65,536), the
// backward three times that; at MAgNet[GNN]'s eval graph (84,256 edges) 13.8 GFLOP, 0.014
// ms at the dense bf16 rate of 989 TFLOP/s, against 21.6 MB of e0 (0.0064
// ms at 3.35 TB/s): bound by operations.  The backward's scratch planes
// (9 x 256 bytes an edge written and read back at L1 = 3, fold) are
// traffic the bound does not count.  mma.sync and not wgmma: the products
// read their operands from padded tiles, transposed or not.
// Registers, bytes and spills of each kernel (ptxas -v, one build for
// sm_90a): see fused_edge_tail_agg_bf16_w128_smem and chip_smoke.py's
// gnn_bf16_kernel phase, which prints ptxas's lines; PERF.md keeps them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (magnet_tpu_torch/ops/cuda_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "tile_mm.cuh"

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

// acc = b_e + (pxj[sender] + pxi[receiver]), zero past n_valid: the fold's
// first accumulators (the node rows read through L2)
__device__ __forceinline__ void fold_init(float (&acc)[2][4][4],
                                          const bf16* __restrict__ be,
                                          const bf16* __restrict__ pxj,
                                          const bf16* __restrict__ pxi,
                                          const int* snd, const int* rcv,
                                          int n_valid) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = acc_row(mi, 2 * h);
      const bool valid = e < n_valid;
      const bf16* pj = pxj + (size_t)snd[e] * kW;
      const bf16* pi = pxi + (size_t)rcv[e] * kW;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = acc_col(ni, 0);
        const float2 b = ld_bf16x2(be + n);
        const float2 j = ld_bf16x2(pj + n);
        const float2 i = ld_bf16x2(pi + n);
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

// wgrad[p] = sum over blocks, in block order, of partial[b][p].
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ wgrad,
                                       int n_blocks, int total) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * total + p];
  wgrad[p] = s;
}

// ---- forward ---------------------------------------------------------------

namespace fwd {

constexpr int kKC = 64;             // weight rows a streamed chunk
constexpr int kChunks = kW / kKC;   // chunks a weight

// Offsets, in bytes, into dynamic shared memory: 104,448 bytes, so that two
// blocks share an SM.
struct Layout {
  static constexpr int act = 0;                      // bf16 (kTE, kLd)
  static constexpr int src = act + kTE * kLd * 2;    // staged e0 / pe rows
  static constexpr int w = src + kTE * kLd * 2;      // 2 x bf16 (kKC, kLd)
  static constexpr int y = w + 2 * kKC * kLd * 2;    // f32 (kTE, kLdF)
  static constexpr int rcv = y + kTE * kLdF * 4;     // 2 x (kTE) int
  static constexpr int snd = rcv + 2 * kTE * 4;      // 2 x (kTE) int
  static constexpr int bytes = snd + 2 * kTE * 4;
};

// LayerNorm (two-pass variance) of the tile's rows y, in place, each result
// rounded to bf16: four threads an edge, thread q of edge e holding columns
// q, q + 4, ... (free of bank conflicts at the row stride kLdF).
__device__ __forceinline__ void layer_norm_bf16(float* s_y,
                                                const float* __restrict__ ln_s,
                                                const float* __restrict__ ln_b) {
  static_assert(kTE * 4 == kThreads, "four threads an edge");
  constexpr int CP = kW / 4;
  const int e = threadIdx.x >> 2, q = threadIdx.x & 3;
  float* row = s_y + e * kLdF;
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
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const int c = q + 4 * j;
    row[c] = round_bf16((v[j] - mu) * rstd * __ldg(ln_s + c) + __ldg(ln_b + c));
  }
}

// E: kFold (src is e0; we and be are read), kPe (src is pe) or
// kPregathered (src is h0; pxj and senders are not read).
template <Entry E>
__global__ void __launch_bounds__(kThreads, 2)
edge_tail_kernel(const bf16* __restrict__ src, const bf16* __restrict__ we,
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
                 float* __restrict__ part, int n_nodes, int n_edges, int l1) {
  using L = Layout;
  constexpr bool kFoldE = E == kFold, kGathers = E != kPregathered;
  extern __shared__ __align__(16) unsigned char bf16w_fwd_smem[];
  unsigned char* sm = bf16w_fwd_smem;
  bf16* s_act = reinterpret_cast<bf16*>(sm + L::act);
  bf16* s_src = reinterpret_cast<bf16*>(sm + L::src);
  bf16* s_w = reinterpret_cast<bf16*>(sm + L::w);
  float* s_y = reinterpret_cast<float*>(sm + L::y);
  int* s_rcv = reinterpret_cast<int*>(sm + L::rcv);
  int* s_snd = reinterpret_cast<int*>(sm + L::snd);
  const int tid = threadIdx.x, warp = tid >> 5;

  int t_beg, t_end;
  tile128::block_tiles<kTE>(n_edges, &t_beg, &t_end);
  if (t_beg >= t_end) return;  // the whole block

  // The weight chain, two chunk steps a weight: W_e (fold), W_1 .. W_L1,
  // W_out.  n_steps is even, so chunk s of every tile lands in buffer s & 1.
  const int first = kFoldE ? 1 : 0;  // W_1's place in the chain
  const int n_mats = l1 + 1 + first;
  const int n_steps = n_mats * kChunks;
  auto weight = [&](int m) {
    return kFoldE && m == 0 ? we
           : m - first < l1 ? w_rest + (size_t)(m - first) * kW * kW
                            : w_out;
  };
  auto bias = [&](int m) {
    return kFoldE && m == 0 ? be
           : m - first < l1 ? b_rest + (size_t)(m - first) * kW
                            : b_out;
  };
  auto load_chunk = [&](int s) {
    const bf16* w = weight(s / kChunks) + (size_t)(s % kChunks) * kKC * kW;
    bf16* dst = s_w + (s & 1) * kKC * kLd;
    for (int p = tid; p < kKC * kW / 8; p += kThreads) {
      const int r = p >> 4, c = (p & 15) * 8;
      cp_async16(dst + r * kLd + c, w + r * kW + c, true);
    }
  };
  // pieces [p0, p1) of tile `tile`'s input rows into the staging tile
  auto stage = [&](int tile, int p0, int p1) {
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    for (int p = p0 + tid; p < p1; p += kThreads) {
      const int r = p >> 4, c = (p & 15) * 8;
      piece_async(s_src + r * kLd + c,
                  r < n_valid ? src + (size_t)(base + r) * kW + c : nullptr,
                  src);
    }
  };
  // the next tile's rows arrive in pieces over the steps whose staging tile
  // is free: from W_1's first chunk on (the fold's first product reads e0
  // there), or from the first step (the pe and pregathered entries form h_0
  // from it before)
  const int stage_from = first * kChunks;
  const int per_step =
      (kPieces + n_steps - stage_from - 1) / (n_steps - stage_from);

  if (warp < 2)
    tile128::tile_indices<kTE, kGathers>(s_rcv, s_snd, senders, rowptr,
                                         n_nodes, n_edges, t_beg, -1);
  stage(t_beg, 0, kPieces);
  load_chunk(0);
  cp_async_commit();
  __syncthreads();  // the first tile's indices

  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const int n_valid = min(kTE, n_edges - tile * kTE);
    const int* rcv = s_rcv + cur * kTE;
    const int* snd = s_snd + cur * kTE;
    const bool more = tile + 1 < t_end;
    float acc[2][4][4];
    if (kFoldE) {
      // z = b_e + (pxj[s] + pxi[i]) (+ e0 . W_e below), loaded while the
      // block waits for its rows
      fold_init(acc, be, pxj, pxi, snd, rcv, n_valid);
    } else {
      cp_async_wait<0>();
      __syncthreads();  // the rows are in; the last tile's sums are done
      // h_0 = bf16(relu((pe + pxj[s]) + pxi[i])) (pe), bf16(relu(h0 +
      // pxi[i])) (pregathered), zero past n_valid
      for (int p = tid; p < kPieces; p += kThreads) {
        const int r = p >> 4, c = (p & 15) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < n_valid) {
          const uint4 a = *reinterpret_cast<const uint4*>(s_src + r * kLd + c);
          const uint4 j =
              kGathers ? __ldg(reinterpret_cast<const uint4*>(
                             pxj + (size_t)snd[r] * kW + c))
                       : a;
          const uint4 i = __ldg(reinterpret_cast<const uint4*>(
              pxi + (size_t)rcv[r] * kW + c));
          v = first_layer8<kGathers>(a, j, i);
        }
        *reinterpret_cast<uint4*>(s_act + r * kLd + c) = v;
      }
    }

    for (int s = 0; s < n_steps; ++s) {
      const int m = s / kChunks, c = s % kChunks;
      if (c == 0 && !(kFoldE && m == 0)) bias_init(acc, bias(m));
      cp_async_wait<0>();
      // chunk s is in; every warp is done with chunk s - 1's buffer and
      // with the last tile's sums, and has written the last layer
      __syncthreads();
      if (s == 0 && more && warp < 2)
        tile128::tile_indices<kTE, kGathers>(
            s_rcv + nxt * kTE, s_snd + nxt * kTE, senders, rowptr, n_nodes,
            n_edges, tile + 1, rcv[n_valid - 1]);
      if (s + 1 < n_steps)
        load_chunk(s + 1);
      else if (more)
        load_chunk(0);
      if (more && s >= stage_from) {
        const int p0 = (s - stage_from) * per_step;
        stage(tile + 1, p0, min(kPieces, p0 + per_step));
      }
      cp_async_commit();
      const bf16* a = kFoldE && m == 0 ? s_src : s_act;
      mm_tile<kKC, false>(acc, a + c * kKC, s_w + (s & 1) * kKC * kLd);
      if (c == kChunks - 1) {
        if (m == n_mats - 1) {
          // y, into its own tile (free since this tile's first barrier)
          acc_pairs(acc, [&](int r, int col, float v0, float v1) {
            *reinterpret_cast<float2*>(s_y + r * kLdF + col) =
                make_float2(v0, v1);
          });
        } else {
          if (!(kFoldE && m == 0)) __syncthreads();  // every warp read act
          acc_pairs(acc, [&](int r, int col, float v0, float v1) {
            *reinterpret_cast<uint32_t*>(s_act + r * kLd + col) =
                pack_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          });
        }
      }
    }
    __syncthreads();  // y written
    layer_norm_bf16(s_y, ln_s, ln_b);
    __syncthreads();
    // the receiver sums over each run of equal receivers; partial rows for
    // the receivers that cross a tile boundary
    csr_tile::receiver_sums<kTE, kW>(
        [&](int e, int col) -> float& { return s_y[e * kLdF + col]; }, rcv,
        rowptr, n_edges, tile, n_valid, out, part);
  }
}

template <Entry E>
int launch(const bf16* src, const bf16* we, const bf16* be, const bf16* pxj,
           const bf16* pxi, const int* senders, const int* rowptr,
           const bf16* w_rest, const bf16* b_rest, const bf16* w_out,
           const bf16* b_out, const float* ln_s, const float* ln_b, float* out,
           float* part, int n_nodes, int n_edges, int l1,
           cudaStream_t stream) {
  static std::atomic<int> cache[kMaxDevices];
  int per_sm = 0, n_sm = 0;
  cudaError_t err = residency(edge_tail_kernel<E>, Layout::bytes, cache,
                              &per_sm, &n_sm);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes == 0 || n_edges <= 0) return (int)cudaSuccess;
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int blocks = n_tiles < per_sm * n_sm ? n_tiles : per_sm * n_sm;
  edge_tail_kernel<E><<<blocks, kThreads, Layout::bytes, stream>>>(
      src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
      ln_s, ln_b, out, part, n_nodes, n_edges, l1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n_tiles > 1)
    csr_tile::cross_tile_sum_kernel<kTE, kW>
        <<<n_tiles - 1, kW, 0, stream>>>(rowptr, part, out, n_nodes, n_edges);
  return (int)cudaGetLastError();
}

}  // namespace fwd

// ---- backward --------------------------------------------------------------

namespace bwd {

// The passes of kernel (a), each one product of one layer over every edge.
enum Pass : int {
  kFirst,      // h_0 = bf16(relu(e0 . W_e + b_e + (pxj[s] + pxi[r])))  (fold)
  kForward,    // h_k = bf16(relu(h_{k-1} . W_k + b_k))
  kOutput,     // y = h_L1 . W_out + b_out, then bf16(dy) (LayerNorm backward)
  kBack,       // da_{k-1} = (bf16(da_k) . W_k^T) where h_{k-1} > 0
  kBackPlain,  // d_e0 = bf16(bf16(dz) . W_e^T)                         (fold)
};

struct PassArgs {
  const bf16* x;      // (E, kW) the product's input rows
  const bf16* w;      // (kW, kW) the weight, as stored (in, out)
  const bf16* bias;   // (kW) kFirst, kForward, kOutput
  const bf16* mask;   // (E, kW) kBack: the output is kept where mask > 0
  bf16* out;          // (E, kW) the output, rounded to bf16
  float* out32;       // kBack, or null: the output unrounded (the pe's dz)
  float* sums;        // kOutput, kBack, or null: block b's column sums of the
                      // unrounded output at sums + b * stride (kOutput: then
                      // d_ln_s and d_ln_b, 2 kW more)
  int stride;
  const bf16* pxj;     // kFirst
  const bf16* pxi;     // kFirst
  const int* senders;  // kFirst
  const int* rowptr;   // kFirst, kOutput
  const float* g;      // kOutput: (N, kW) the output's cotangent
  const float* ln_s;   // kOutput
  int n_nodes, n_edges;
};

__host__ __device__ constexpr bool backward(Pass p) {
  return p == kBack || p == kBackPlain;
}

// Offsets, in bytes, into a pass's dynamic shared memory: the weight, two
// input tiles, the tile's indices and the column sums' halves; the
// LayerNorm pass also y and the rows' statistics.
template <Pass P>
struct PassLayout {
  static constexpr int w = 0;                        // bf16 (kW, kLd)
  static constexpr int x = w + kW * kLd * 2;         // 2 x bf16 (kTE, kLd)
  static constexpr int rcv = x + 2 * kTE * kLd * 2;  // (kTE) int
  static constexpr int snd = rcv + kTE * 4;          // (kTE) int
  static constexpr int part = snd + kTE * 4;         // 2 x 3 kW f32
  static constexpr int y = part + 2 * 3 * kW * 4;    // kOutput: f32 (kTE, kLdF)
  static constexpr int stat = y + (P == kOutput ? kTE * kLdF * 4 : 0);
  static constexpr int bytes = stat + (P == kOutput ? 4 * kTE * 4 : 0);
};

// One pass: a persistent block keeps the layer's weight in shared memory
// for the whole launch and walks 64-edge tiles (block b: tiles b, b +
// gridDim.x, ...), each tile's rows fetched with cp.async while the one
// before computes.  The products start from the bias (or the fold's node
// rows) as the forward's do and run in the forward's order, so the
// recomputed activations have the forward's bits.
template <Pass P>
__global__ void __launch_bounds__(kThreads, 2) edge_pass_kernel(PassArgs a) {
  using L = PassLayout<P>;
  extern __shared__ __align__(16) unsigned char bf16w_pass_smem[];
  unsigned char* sm = bf16w_pass_smem;
  bf16* s_w = reinterpret_cast<bf16*>(sm + L::w);
  bf16* s_x = reinterpret_cast<bf16*>(sm + L::x);
  int* s_rcv = reinterpret_cast<int*>(sm + L::rcv);
  int* s_snd = reinterpret_cast<int*>(sm + L::snd);
  float* s_part = reinterpret_cast<float*>(sm + L::part);
  float* s_y = reinterpret_cast<float*>(sm + L::y);
  float* s_stat = reinterpret_cast<float*>(sm + L::stat);
  const int tid = threadIdx.x, warp = tid >> 5;

  for (int p = tid; p < kW * kW / 8; p += kThreads) {
    const int r = p >> 4, c = (p & 15) * 8;
    cp_async16(s_w + r * kLd + c, a.w + r * kW + c, true);
  }
  cp_async_commit();
  const int n_tiles = (a.n_edges + kTE - 1) / kTE;
  auto prefetch = [&](int tile, int buf) {
    const int base = tile * kTE, n_valid = min(kTE, a.n_edges - base);
    bf16* dst = s_x + buf * kTE * kLd;
    for (int p = tid; p < kPieces; p += kThreads) {
      const int r = p >> 4, c = (p & 15) * 8;
      piece_async(dst + r * kLd + c,
                  r < n_valid ? a.x + (size_t)(base + r) * kW + c : nullptr,
                  a.x);
    }
    cp_async_commit();
  };
  // the unrounded output's column sums over the thread's rows of every
  // tile (kBack), or the LayerNorm pass's db_out, d_ln_s, d_ln_b over
  // column tid & 127 and half tid >> 7 of each tile's rows (kOutput)
  float sums[4][2] = {};
  float ln_sums[3] = {};
  float ls = 0.f;
  if (P == kOutput) ls = __ldg(a.ln_s + (tid & (kW - 1)));

  if ((int)blockIdx.x < n_tiles) prefetch(blockIdx.x, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int cur = it & 1;
    const int base = tile * kTE, n_valid = min(kTE, a.n_edges - base);
    const bf16* x = s_x + cur * kTE * kLd;
    if (tile + (int)gridDim.x < n_tiles)
      prefetch(tile + gridDim.x, cur ^ 1);
    else
      cp_async_commit();  // an empty group keeps the count
    if ((P == kFirst || P == kOutput) && warp < 2)
      tile128::tile_indices<kTE, P == kFirst>(s_rcv, s_snd, a.senders,
                                              a.rowptr, a.n_nodes, a.n_edges,
                                              tile, -1);
    cp_async_wait<1>();
    __syncthreads();

    float acc[2][4][4];
    if (P == kFirst)
      fold_init(acc, a.bias, a.pxj, a.pxi, s_snd, s_rcv, n_valid);
    else if (P == kForward || P == kOutput)
      bias_init(acc, a.bias);
    else
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;
    // kBack: the mask, loaded before the product so that its latency hides
    uint32_t mask[2][4][2];
    if (P == kBack)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = acc_row(mi, 2 * h);
            mask[mi][ni][h] =
                e < n_valid
                    ? __ldg(reinterpret_cast<const unsigned*>(
                          a.mask + (size_t)(base + e) * kW + acc_col(ni, 0)))
                    : 0u;
          }
    mm_tile<kW, backward(P)>(acc, x, s_w);

    if (P != kOutput) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // elements 2h, 2h + 1: one row
            const int e = acc_row(mi, 2 * h);
            float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
            if (P == kFirst || P == kForward) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            } else if (P == kBack) {
              const float2 m = unpack(mask[mi][ni][h]);
              v0 = m.x > 0.f ? v0 : 0.f;
              v1 = m.y > 0.f ? v1 : 0.f;
              sums[ni][0] += v0;
              sums[ni][1] += v1;
            }
            if (e >= n_valid) continue;
            const size_t o = (size_t)(base + e) * kW + acc_col(ni, 0);
            *reinterpret_cast<uint32_t*>(a.out + o) = pack_rn(v0, v1);
            if (P == kBack && a.out32 != nullptr)
              *reinterpret_cast<float2*>(a.out32 + o) = make_float2(v0, v1);
          }
    } else {
      acc_pairs(acc, [&](int r, int col, float v0, float v1) {
        *reinterpret_cast<float2*>(s_y + r * kLdF + col) = make_float2(v0, v1);
      });
      __syncthreads();  // y written
      // LayerNorm's row statistics, four threads an edge (thread q holds
      // columns q + 4 j): mean, rstd, and m1 = mean(dx), m2 = mean(dx xhat)
      // of dx = bf16(g[i]) ln_s
      {
        constexpr int CP = kW / 4;
        const int e = tid >> 2, q = tid & 3;
        const bool valid = e < n_valid;
        const float* row = s_y + e * kLdF;
        const float* gp = a.g + (size_t)s_rcv[e] * kW;
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
          const int c = q + 4 * j;
          const float gv = valid ? round_bf16(__ldg(gp + c)) : 0.f;
          const float dx = gv * __ldg(a.ln_s + c);
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
      // tile's rows: bf16(dy) out (coalesced along the row), and the sums
      // of dy, bf16(g) xhat and bf16(g)
      {
        const int c = tid & (kW - 1);
        const int e_end = min(n_valid, (tid >> 7) * (kTE / 2) + kTE / 2);
        for (int e = (tid >> 7) * (kTE / 2); e < e_end; ++e) {
          const float* st = s_stat + 4 * e;
          const float xhat = (s_y[e * kLdF + c] - st[0]) * st[1];
          const float gv = round_bf16(__ldg(a.g + (size_t)s_rcv[e] * kW + c));
          const float dy = st[1] * (gv * ls - st[2] - xhat * st[3]);
          a.out[(size_t)(base + e) * kW + c] = __float2bfloat16_rn(dy);
          ln_sums[0] += dy;
          ln_sums[1] += gv * xhat;
          ln_sums[2] += gv;
        }
      }
    }
    __syncthreads();  // before the next prefetch overwrites this tile
  }
  cp_async_wait<0>();

  // this block's sums, the two halves of the rows added in order
  if (P == kBack && a.sums != nullptr) {
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
    __syncthreads();
    if (tid < kW)
      a.sums[(size_t)blockIdx.x * a.stride + tid] = s_part[tid] + s_part[kW + tid];
  } else if (P == kOutput) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      s_part[(tid >> 7) * 3 * kW + k * kW + (tid & (kW - 1))] = ln_sums[k];
    __syncthreads();
    for (int p = tid; p < 3 * kW; p += kThreads)
      a.sums[(size_t)blockIdx.x * a.stride + p] = s_part[p] + s_part[3 * kW + p];
  }
}

// h_0 = bf16(relu((pe[e] + pxj[s]) + pxi[r])), the pe entry's first
// layer (GATHERS), or bf16(relu(h0[e] + pxi[r])), the pregathered entry's:
// one warp per edge, four columns a lane.
template <bool GATHERS>
__global__ void __launch_bounds__(kThreads) first_input_kernel(
    const bf16* __restrict__ src, const bf16* __restrict__ pxj,
    const bf16* __restrict__ pxi, const int* __restrict__ senders,
    const int* __restrict__ rowptr, bf16* __restrict__ h0, int n_nodes,
    int n_edges) {
  const int lane = threadIdx.x & 31;
  for (int e = (blockIdx.x * kThreads + threadIdx.x) >> 5; e < n_edges;
       e += (gridDim.x * kThreads) >> 5) {
    const int r = tile128::receiver_of(rowptr, n_nodes, e);
    const uint2 a =
        __ldg(reinterpret_cast<const uint2*>(src + (size_t)e * kW) + lane);
    const uint2 i =
        __ldg(reinterpret_cast<const uint2*>(pxi + (size_t)r * kW) + lane);
    uint2 v;
    if (GATHERS) {
      const uint2 j = __ldg(
          reinterpret_cast<const uint2*>(pxj + (size_t)senders[e] * kW) + lane);
      v = make_uint2(relu_sum3(a.x, j.x, i.x), relu_sum3(a.y, j.y, i.y));
    } else {
      v = make_uint2(relu_sum2(a.x, i.x), relu_sum2(a.y, i.y));
    }
    reinterpret_cast<uint2*>(h0 + (size_t)e * kW)[lane] = v;
  }
}

// d_pxi[r] += bf16(dz) over the receivers (one atomicAdd per run of equal
// receivers in each half of a 64-edge tile) and, fold, d_pxj[s] +=
// bf16(dz) with one atomicAdd per element.
template <bool FOLD>
__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const bf16* __restrict__ dz, const int* __restrict__ senders,
    const int* __restrict__ rowptr, float* __restrict__ d_pxj,
    float* __restrict__ d_pxi, int n_nodes, int n_edges) {
  __shared__ int s_snd[kTE], s_rcv[kTE];
  const int tid = threadIdx.x, n = tid & (kW - 1);
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    if (tid < 64)  // warps 0 and 1
      tile128::tile_indices<kTE, FOLD>(s_rcv, s_snd, senders, rowptr,
                                       n_nodes, n_edges, tile, -1);
    __syncthreads();
    const int e_beg = (tid >> 7) * (kTE / 2);
    const int e_end = min(e_beg + kTE / 2, n_valid);
    if (e_beg < e_end) {
      int at = s_rcv[e_beg];
      float s = 0.f;
      for (int e = e_beg; e < e_end; ++e) {
        const float v = __bfloat162float(dz[(size_t)(base + e) * kW + n]);
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

constexpr int kMaxPairs = 5;  // W_e, three tail weights, W_out
constexpr int kSlab = 64;     // edges a slab of kernel (b)

// Kernel (b): dW = sum_e A[e]^T D[e] for each weight (blockIdx.y) over one
// edge range (blockIdx.x); the block writes its (kW x kW) partial at
// partial + blockIdx.x * stride + off[pair].
struct WgradArgs {
  const bf16* a[kMaxPairs];  // (E, kW) the layer's input rows
  const bf16* d[kMaxPairs];  // (E, kW) bf16 of its output's gradient rows
  int off[kMaxPairs];
  float* partial;
  int stride, chunk, n_edges;
};

constexpr int wgrad_smem() { return 4 * kSlab * kLd * 2; }

// A (128 x 128) product over each 64-edge slab, both slabs read down their
// columns by ldmatrix.trans: warp w forms rows 32 (w & 3) .. + 31 and
// columns 64 (w >> 2) .. + 63 of dW in 64 f32 accumulators a thread over
// the block's whole edge range; slabs double-buffered with cp.async
// (69,632 bytes).
__global__ void __launch_bounds__(kThreads, 2) wgrad_kernel(WgradArgs args) {
  extern __shared__ __align__(16) unsigned char bf16w_wgrad_smem[];
  bf16* s_a = reinterpret_cast<bf16*>(bf16w_wgrad_smem);  // two slabs
  bf16* s_d = s_a + 2 * kSlab * kLd;                      // two slabs
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = blockIdx.y;
  const bf16* A = args.a[pair];
  const bf16* D = args.d[pair];
  const int e_beg = blockIdx.x * args.chunk;
  const int e_end = min(args.n_edges, e_beg + args.chunk);
  const int n_slabs = e_end > e_beg ? (e_end - e_beg + kSlab - 1) / kSlab : 0;
  auto prefetch = [&](int slab, int buf) {
    const int base = e_beg + slab * kSlab;
    for (int p = tid; p < 2 * kSlab * (kW / 8); p += kThreads) {
      const int which = p / (kSlab * (kW / 8)), q = p % (kSlab * (kW / 8));
      const int r = q >> 4, c = (q & 15) * 8;
      const bf16* src = which ? D : A;
      bf16* dst = (which ? s_d : s_a) + buf * kSlab * kLd + r * kLd + c;
      piece_async(dst, base + r < e_end ? src + (size_t)(base + r) * kW + c
                                        : nullptr, src);
    }
    cp_async_commit();
  };
  const int m0 = 32 * (warp & 3), n0 = 64 * (warp >> 2);
  // lane addresses of the ldmatrix.trans blocks: A(m, k) = a[k kLd + m],
  // B(k, n) = d[k kLd + n]
  const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * kLd + m0 +
                    (((lane >> 3) & 1) << 3);
  const int d_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLd + n0 +
                    ((lane >> 4) << 3);
  float acc[2][8][4] = {};
  if (n_slabs > 0) prefetch(0, 0);
  for (int slab = 0; slab < n_slabs; ++slab) {
    const int cur = slab & 1;
    if (slab + 1 < n_slabs)
      prefetch(slab + 1, cur ^ 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sa = s_a + cur * kSlab * kLd;
    const bf16* sd = s_d + cur * kSlab * kLd;
#pragma unroll
    for (int k0 = 0; k0 < kSlab; k0 += 16) {
      uint32_t fa[2][4], fb[4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_t(fa[mi], sa + a_off + k0 * kLd + 16 * mi);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldsm_t(fb[j], sd + d_off + k0 * kLd + 16 * j);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          mma(acc[mi][ni], fa[mi], fb[ni >> 1][2 * (ni & 1)],
              fb[ni >> 1][2 * (ni & 1) + 1]);
    }
    __syncthreads();  // before the next prefetch overwrites this slab
  }
  cp_async_wait<0>();
  float* pw = args.partial + (size_t)blockIdx.x * args.stride + args.off[pair];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        pw[(m0 + 16 * mi + lane_g() + 8 * (c >> 1)) * kW + n0 + 8 * ni +
           2 * lane_t() + (c & 1)] = acc[mi][ni][c];
}

// One pass over every edge on a persistent grid of `blocks` blocks.
template <Pass P>
cudaError_t run_pass(const PassArgs& a, int blocks, cudaStream_t stream) {
  static std::atomic<int> cache[kMaxDevices];
  int per_sm = 0, n_sm = 0;
  cudaError_t err = residency(edge_pass_kernel<P>, PassLayout<P>::bytes,
                              cache, &per_sm, &n_sm);
  if (err != cudaSuccess || blocks == 0) return err;
  edge_pass_kernel<P><<<blocks, kThreads, PassLayout<P>::bytes, stream>>>(a);
  return cudaGetLastError();
}

// The packed gradient buffer, in floats: the weights' gradients (dW_e
// (fold), dW_1 .. dW_L1, dW_out), then the bias row (db_e (fold), db_1 ..
// db_L1, db_out, d_ln_s, d_ln_b).
struct Packed {
  int n_w, n_b;  // weights, and rows of kW floats in the bias row
  Packed(bool fold, int l1) {
    n_w = (fold ? 1 : 0) + l1 + 1;
    n_b = n_w + 2;
  }
  int weights() const { return n_w * kW * kW; }
  int biases() const { return n_b * kW; }
};

// The backward as one launch sequence: kernel (a) as 2 L1 + 4 passes
// (pe: an elementwise first layer and 2 L1 + 2 passes) that recompute
// h_0..h_L1, run LayerNorm's backward and the data gradients down to dz,
// each h_k and each bf16(da_k) written to `scratch`, the bias gradients
// summed per block; the scatter of bf16(dz); kernel (b) for every weight
// gradient; the block-ordered sums of the partials.  Every pass runs on a
// grid of 2 n_sm blocks (or one a tile), so the bias partials have one
// row count.
template <Entry E>
int launch(const bf16* src, const bf16* we, const bf16* be, const bf16* pxj,
           const bf16* pxi, const int* senders, const int* rowptr,
           const bf16* w_rest, const bf16* b_rest, const bf16* w_out,
           const bf16* b_out, const float* ln_s, const float* g, bf16* d_src,
           float* dz32, float* d_pxj, float* d_pxi, float* wgrad,
           float* partial, bf16* scratch, int n_nodes, int n_edges, int l1,
           int n_sm, cudaStream_t stream) {
  constexpr bool FOLD = E == kFold;
  const Packed P(FOLD, l1);
  const size_t plane = (size_t)n_edges * kW;
  if (n_nodes == 0) n_edges = 0;
  // act[k] = h_k, k = 0..L1; grad[k] = bf16 of the gradient of W_of[k]'s
  // output (grad[0]: dz, the pe entry's d_src; grad[L1 + 1]: dy)
  bf16* act[kMaxL1 + 1];
  bf16* grad[kMaxL1 + 2];
  bf16* next = scratch;
  for (int k = 0; k <= l1; ++k, next += plane) act[k] = next;
  for (int k = 0; k <= l1 + 1; ++k) {
    if (k == 0 && !FOLD) {
      grad[0] = d_src;
      continue;
    }
    grad[k] = next;
    next += plane;
  }
  const bf16* w_of[kMaxL1 + 2];
  const bf16* b_of[kMaxL1 + 2];
  w_of[0] = we;
  b_of[0] = be;
  for (int k = 1; k <= l1; ++k) {
    w_of[k] = w_rest + (size_t)(k - 1) * kW * kW;
    b_of[k] = b_rest + (size_t)(k - 1) * kW;
  }
  w_of[l1 + 1] = w_out;
  b_of[l1 + 1] = b_out;
  // weight k's place among the packed weights, and its bias's in the row
  auto weight_at = [&](int k) { return (FOLD ? k : k - 1) * kW * kW; };
  auto bias_at = [&](int k) { return (FOLD ? k : k - 1) * kW; };

  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int blocks = n_tiles < 2 * n_sm ? n_tiles : 2 * n_sm;
  float* bias_part = partial + (size_t)n_sm * P.weights();
  PassArgs a{};
  a.pxj = pxj;
  a.pxi = pxi;
  a.senders = senders;
  a.rowptr = rowptr;
  a.g = g;
  a.ln_s = ln_s;
  a.stride = P.biases();
  a.n_nodes = n_nodes;
  a.n_edges = n_edges;
  cudaError_t err = cudaSuccess;
  if (n_edges > 0) {
    // recompute h_0
    if (FOLD) {
      a.x = src;
      a.w = we;
      a.bias = be;
      a.out = act[0];
      if ((err = run_pass<kFirst>(a, blocks, stream)) != cudaSuccess)
        return (int)err;
    } else {
      first_input_kernel<E == kPe><<<4 * n_sm, kThreads, 0, stream>>>(
          src, pxj, pxi, senders, rowptr, act[0], n_nodes, n_edges);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    // h_1..h_L1
    for (int k = 1; k <= l1; ++k) {
      a.x = act[k - 1];
      a.w = w_of[k];
      a.bias = b_of[k];
      a.out = act[k];
      if ((err = run_pass<kForward>(a, blocks, stream)) != cudaSuccess)
        return (int)err;
    }
    // y, then bf16(dy) and the blocks' db_out, d_ln_s, d_ln_b
    a.x = act[l1];
    a.w = w_out;
    a.bias = b_out;
    a.out = grad[l1 + 1];
    a.sums = bias_part + bias_at(l1 + 1);
    if ((err = run_pass<kOutput>(a, blocks, stream)) != cudaSuccess)
      return (int)err;
    // da_L1 .. da_0 = dz, each with its bias gradient (none for the pe's
    // or the pregathered entry's dz)
    for (int k = l1 + 1; k >= 1; --k) {
      a.x = grad[k];
      a.w = w_of[k];
      a.mask = act[k - 1];
      a.out = grad[k - 1];
      a.out32 = k == 1 && !FOLD ? dz32 : nullptr;
      a.sums = k == 1 && !FOLD ? nullptr : bias_part + bias_at(k - 1);
      if ((err = run_pass<kBack>(a, blocks, stream)) != cudaSuccess)
        return (int)err;
    }
    if (FOLD) {  // d_e0 = bf16(bf16(dz) . W_e^T)
      a.x = grad[0];
      a.w = we;
      a.out = d_src;
      a.out32 = nullptr;
      a.sums = nullptr;
      if ((err = run_pass<kBackPlain>(a, blocks, stream)) != cudaSuccess)
        return (int)err;
    }
    const int sblocks = n_tiles < 4 * n_sm ? n_tiles : 4 * n_sm;
    scatter_kernel<FOLD><<<sblocks, kThreads, 0, stream>>>(
        grad[0], senders, rowptr, d_pxj, d_pxi, n_nodes, n_edges);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  // kernel (b): one partial row per edge range, as many ranges as fill the
  // card once (at most n_sm rows)
  WgradArgs wa{};
  int pairs = 0;
  for (int k = FOLD ? 0 : 1; k <= l1 + 1; ++k, ++pairs) {
    wa.a[pairs] = k == 0 ? src : act[k - 1];
    wa.d[pairs] = grad[k];
    wa.off[pairs] = weight_at(k);
  }
  int splits = 0;
  if (n_edges > 0) {
    static std::atomic<int> cache[kMaxDevices];
    int per_sm = 0, sms = 0;
    if ((err = residency(wgrad_kernel, wgrad_smem(), cache, &per_sm, &sms)) !=
        cudaSuccess)
      return (int)err;
    int want = per_sm * sms / pairs;
    if (want > n_sm) want = n_sm;
    if (want < 1) want = 1;
    const int n_slabs = (n_edges + kSlab - 1) / kSlab;
    wa.chunk = (n_slabs + want - 1) / want * kSlab;
    splits = (n_edges + wa.chunk - 1) / wa.chunk;
    wa.partial = partial;
    wa.stride = P.weights();
    wa.n_edges = n_edges;
    wgrad_kernel<<<dim3(splits, pairs), kThreads, wgrad_smem(), stream>>>(wa);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  reduce_partials_kernel<<<(P.weights() + 255) / 256, 256, 0, stream>>>(
      partial, wgrad, splits, P.weights());
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(P.biases() + 255) / 256, 256, 0, stream>>>(
      bias_part, wgrad + P.weights(), n_edges > 0 ? blocks : 0, P.biases());
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
// ceil(n_edges / 64) rows of 128.  Built for l1 in 0..3; others return
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
// n_sm rows of the weights' floats, then 2 n_sm rows of the biases'
// floats; scratch is bf16 of (2 l1 + 3) (fold) or (2 l1 + 2) (pe,
// pregathered) planes of n_edges x 128.  n_sm is the card's SM count.  Built for l1 in 0..3.
int fused_edge_tail_agg_bf16_w128_bwd(
    const bf16* src, const bf16* we, const bf16* be, const bf16* pxj,
    const bf16* pxi, const int* senders, const int* rowptr,
    const bf16* w_rest, const bf16* b_rest, const bf16* w_out,
    const bf16* b_out, const float* ln_s, const float* g, bf16* d_src,
    float* dz32, float* d_pxj, float* d_pxi, float* wgrad, float* partial,
    bf16* scratch, int n_nodes, int n_edges, int l1, int entry, int n_sm,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l1 < 0 || l1 > kMaxL1 || n_sm < 1 || scratch == nullptr ||
      partial == nullptr)
    return (int)cudaErrorInvalidValue;
  if (entry == kPregathered)
    return bwd::launch<kPregathered>(src, nullptr, nullptr, nullptr, pxi,
                                     nullptr, rowptr, w_rest, b_rest, w_out,
                                     b_out, ln_s, g, d_src, nullptr, nullptr,
                                     d_pxi, wgrad, partial, scratch, n_nodes,
                                     n_edges, l1, n_sm, s);
  if (pxj == nullptr || senders == nullptr) return (int)cudaErrorInvalidValue;
  if (entry == kFold && we != nullptr && be != nullptr && d_pxj != nullptr)
    return bwd::launch<kFold>(src, we, be, pxj, pxi, senders, rowptr, w_rest,
                              b_rest, w_out, b_out, ln_s, g, d_src, dz32,
                              d_pxj, d_pxi, wgrad, partial, scratch, n_nodes,
                              n_edges, l1, n_sm, s);
  if (entry == kPe && dz32 != nullptr)
    return bwd::launch<kPe>(src, we, be, pxj, pxi, senders, rowptr, w_rest,
                            b_rest, w_out, b_out, ln_s, g, d_src, dz32,
                            d_pxj, d_pxi, wgrad, partial, scratch, n_nodes,
                            n_edges, l1, n_sm, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block takes: the forward (which = 0), a pass of
// the backward (1), its LayerNorm pass (2), its weight-gradient kernel (3);
// -1 for any other.
int fused_edge_tail_agg_bf16_w128_smem(int which) {
  switch (which) {
    case 0: return fwd::Layout::bytes;
    case 1: return bwd::PassLayout<bwd::kForward>::bytes;
    case 2: return bwd::PassLayout<bwd::kOutput>::bytes;
    case 3: return bwd::wgrad_smem();
    default: return -1;
  }
}

}  // extern "C"
