// Fused InteractionNetwork edge pipeline, bf16 operands, in three entries:
// fold at (Ce, H, C) = (32, 64, 32), pre-gathered and pe at (H, C) = (64,
// 32), forward and backward, L1 in 0..3.
//
// Replaces the TPU kernels of magnet_tpu/ops/pallas_kernels.py on bf16
// operands (the JAX models' graph_dtype=bf16, whose GraphNet stage rounds
// its inputs and weights to bf16; ln_s and ln_b stay f32):
//   * fold: _fused2r_fwd_pallas (#8) and _fused2r_bwd_pallas (#9, with
//     dpxj_in_kernel=True) as the fold-e public entry fused_edge_tail_agg2rf
//     calls them (operands e0, W_e with the edge scale folded in, b_e, pxj,
//     pxi, W_k, b_k, W_out, b_out);
//   * pregathered: _fused_fwd_pallas (#2) and _fused_bwd_pallas (#3), the
//     public entry fused_edge_tail_agg (operands h0, the first layer's input
//     gathered per edge by the caller, pxi, W_k, b_k, W_out, b_out);
//   * pe: _fused2_fwd_pallas (#6) and _fused2_bwd_pallas (#7) with its VJP
//     _fused2_bwd, the public entry fused_edge_tail_agg2 (operands pe, the
//     edge projection formed per edge by the caller, pxj gathered in the
//     kernel, pxi, W_k, b_k, W_out, b_out).
// The arithmetic is the TPU kernels', rounding where they round:
//
//   forward, for every edge j -> i of a receiver-grouped CSR graph
//     z    = f32(e0[e] . W_e) + b_e + pxj[j] + pxi[i]      (fold, f32)
//     z    = h0[e] + pxi[i]                                (pregathered, f32)
//     z    = (pe[e] + pxj[j]) + pxi[i]                     (pe, f32)
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
//     pregathered: d_h0 = bf16(dz) (E, H) bf16;
//     pe: d_pe = bf16(dz) (E, H) bf16 and dz (E, H) f32 unrounded, from
//         which the caller sums d_pxj over the sender CSR (the f32 segment
//         sum, then one rounding, as the JAX VJP reduces it);
//     d_pxi[i] += bf16(dz) (f32 sums);
//     d_ln_s = sum bf16(g) xhat, d_ln_b = sum bf16(g);
// every product on bf16 operands with f32 accumulation, every weight
// gradient summed in f32; the caller casts each gradient to its operand's
// dtype, as the JAX VJPs do.  The plain versions are
// magnet_tpu_torch/ops/fused_edge.py:fused_edge_tail_agg_bf16_plain /
// _bwd_plain (fold), fused_edge_tail_agg_pregathered_bf16_plain /
// _bwd_plain and fused_edge_tail_agg_pe_bf16_plain / _bwd_plain.
//
// Forward (fwd::): the f32 builds' walk (csrc/fused_edge_tail_agg.cu,
// namespace w64) with bf16 products; one template holds the three entries
// (an Entry value):
//   * persistent blocks of 256 threads walk consecutive tiles of TE = 64
//     CSR edges (tile128::block_tiles); warps 0 and 1 find the next tile's
//     receivers and senders from the last receiver of this one
//     (tile128::tile_indices); each run of equal receivers is summed in CSR
//     order, partial rows left for the receivers that cross a tile
//     (csr_tile): the same bits from run to run;
//   * every product is mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32, warp
//     w forming 16 rows and 8 NI columns of each (64 x N) result (Prod),
//     every weight resident as bf16, transposed, in padded rows (72 or 40
//     elements) so that a fragment is one 32-bit load; h_k bf16 tiles, y
//     and LayerNorm f32;
//   * pregathered and pe form h_0 elementwise from 16-byte loads of the
//     tile's h0 / pe rows and their node rows (pe: (pe + pxj[s]) + pxi[i],
//     the TPU kernel's order).
//   63,104 bytes of shared memory at L1 = 3, two blocks an SM.
// Backward (bwd::wgmma_bwd_kernel): Hopper's warpgroup products, two tiles
// in flight an SM:
//   * one block of 256 threads an SM, block b over tiles [b T / B, (b + 1)
//     T / B) of the grid's B = min(T, SMs) blocks; its two warpgroups each
//     walk half of them (the first the first half, rounded up), with their
//     own tiles in shared memory and named barriers of their own (bar.sync
//     1 + group, 128), so one group's epilogues run under the other's
//     products; a group without a tile reaches only the block's barriers at
//     the start and the end;
//   * every product is wgmma.mma_async m64n64k16 / m64n32k16 bf16 x bf16 ->
//     f32 (csrc/wgmma.cuh): the 64-edge tile is the M of the recompute and
//     the data gradients, the width H = 64 the M of the weight gradients
//     (dW_e formed as dW_e^T = bf16(dz)^T . e0); each weight lies once in
//     shared memory as stored (in, out), the MN-major B of h . W and the
//     K-major B of da . W^T; the weight gradients x^T . d read both (edge,
//     width) tiles as MN-major operands; 64-wide bf16 rows (128 bytes) take
//     the 128-byte swizzle, 32-wide ones the 64-byte swizzle;
//   * the forward layers after the first, y and every data gradient read
//     their A operand from registers (the accumulators of the product
//     before, rounded to bf16 in place: the pairs of an m64nN accumulator
//     are the A fragments of the next product), so no barrier comes between
//     the forward layers and a data-gradient product is issued before its
//     layer's barrier; each weight-gradient product runs on under the next
//     epilogue, retired by the next data gradient's wait before the barrier
//     that precedes any write of its tiles;
//   * epilogues in the accumulator layout: LayerNorm's statistics and its
//     backward by quad shuffles (no f32 y tile); each data gradient masked
//     by h > 0 (its bf16 bits), stored once as a bf16 tile; the bias
//     gradients from the unrounded f32 accumulators, summed over each warp's
//     rows by shuffle rounds into that warp's row of shared memory (fixed
//     order, no shared-memory atomics); the pe entry's f32 dz from the
//     accumulators to global memory;
//   * a tile's e0 / h0 / pe rows, its node rows (pxj[s], pxi[i]) and g[i]
//     are staged a tile ahead by cp.async into swizzled tiles, the next
//     tile's indices loaded at the start of a tile and searched after h_0
//     (IndexLoad), so no product waits on a load it issued;
//   * dW summed over a warpgroup's tiles in its products' accumulators
//     (tests/test_torch_bwd64_bf16.py emulates the truncation: far inside
//     the tolerances); at the end warpgroup 0's sums and then warpgroup 1's
//     go into the block's partial row, the eight warps' bias rows in warp
//     order, and a second launch adds the blocks' rows in block order: the
//     weight and bias gradients, d_src and dz have the same bits from run
//     to run; d_pxj (fold: 16-byte vector atomics of bf16(dz)) and d_pxi
//     (one atomic a run of equal receivers in each half of a tile) are f32
//     atomics, whose last bits vary before the caller's rounding to bf16.
//   221,440 / 215,040 / 198,656 bytes of shared memory at L1 = 3 (fold /
//   pe / pregathered), one block an SM; fused_edge_tail_agg_bf16_smem
//   reports each for each L1, fused_edge_tail_agg_bf16_bwd_launches a
//   call's launches (2).
// What bounds it on an H100: Ce H + L1 H^2 + H C = 16,384 multiply-adds an
// edge at L1 = 3 in the fold forward, three times that in the backward; at
// MAgNet[CNN] 1D's eval graph (186,624 edges) 6.1 GFLOP, 0.0062 ms at the
// dense bf16 rate of 989 TFLOP/s, against 11.9 MB of e0 (0.0036 ms at 3.35
// TB/s): bound by operations.  The pregathered forward does L1 H^2 + H C =
// 14,336 an edge and reads an (E, 64) bf16 h0: at MAgNet[CNN] 2D's
// training graph (299,894 edges) 8.6 GFLOP (0.0087 ms) against 38.4 MB of
// h0 (0.0115 ms): bound by bytes.  The pe forward does the same work and
// reads an (E, 64) bf16 pe: at 1D's eval graph 23.9 MB (0.0071 ms) against
// 5.35 GFLOP (0.0054 ms), bound by bytes.  The backward's bounds: #9 at
// 1D's training graph (67,680 edges) 6.65 GFLOP, 0.0067 ms (operations);
// #7 there ~512 B an edge (pe, d_pe, dz), 0.0112 ms (bytes); #3 at the 2D
// training graph of 32 samples (299,894 edges) 0.0268 ms (bytes).  The
// backward runs far from them: a tile is 14,800-18,600 cycles of a
// warpgroup, ~1,500 of them its products, the rest the epilogues' latency
// between dependent products (magnet_tpu_torch/probe_bwd64.py times each
// part; PERF.md keeps the numbers).
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

constexpr float kLnEps = 1e-5f;
constexpr int kTE = 64;         // edges per tile
constexpr int kCe = 32;         // the edge-latent width
constexpr int kH = 64;          // hidden width
constexpr int kC = 32;          // output width
constexpr int kLdH = kH + 8;    // bf16 rows of kH, padded
constexpr int kLdC = kC + 8;    // bf16 rows of kCe = kC, padded
constexpr int kLdCf = kC + 4;   // f32 rows of kC, padded
constexpr int kMaxDevices = 64;
constexpr int kMaxL1 = 3;

static_assert(kCe == kC, "the e0 tiles and the (., kC) tiles share a stride");

// ---- bf16 products on the tensor cores -----------------------------------
//
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, lane = 4 g + t:
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//                a3 (g + 8, 2t + 8..)
//   B (16 x 8):  b0 (2t..2t+1, g), b1 (2t + 8.., g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// each register holding two bf16 values, the lower index in its low half.

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two f32 values rounded to bf16 (to nearest, ties to even), lo first
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float2 unpack(uint32_t a) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
}
// bf16(relu(f32(a) + f32(b))) of two pairs of bf16 values
__device__ __forceinline__ uint32_t relu_sum(uint32_t a, uint32_t b) {
  const float2 x = unpack(a), y = unpack(b);
  return pack_rn(fmaxf(x.x + y.x, 0.f), fmaxf(x.y + y.y, 0.f));
}
// bf16(relu((f32(a) + f32(j)) + f32(b))) of three pairs of bf16 values
__device__ __forceinline__ uint32_t relu_sum3(uint32_t a, uint32_t j,
                                              uint32_t b) {
  const float2 x = unpack(a), z = unpack(j), y = unpack(b);
  return pack_rn(fmaxf((x.x + z.x) + y.x, 0.f), fmaxf((x.y + z.y) + y.y, 0.f));
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A operands: rows m0.., columns k0.. (16 x 16) of A(m, k).
struct ARows {  // A(m, k) = p[m ld + k], bf16
  const bf16* p;
  int ld;
  __device__ __forceinline__ void load(uint32_t (&r)[4], int m0,
                                       int k0) const {
    const bf16* q = p + (m0 + lane_g()) * ld + k0 + 2 * lane_t();
    r[0] = ld32(q);
    r[1] = ld32(q + 8 * ld);
    r[2] = ld32(q + 8);
    r[3] = ld32(q + 8 * ld + 8);
  }
};
// B operands: rows k0.. (16), columns n0.. (8) of B(k, n).
struct BNK {  // B(k, n) = p[n ld + k], bf16 (a weight transposed, or W^T)
  const bf16* p;
  int ld;
  __device__ __forceinline__ void load(uint32_t (&r)[2], int k0,
                                       int n0) const {
    const bf16* q = p + (n0 + lane_g()) * ld + k0 + 2 * lane_t();
    r[0] = ld32(q);
    r[1] = ld32(q + 8);
  }
};
// The part of an (R x N) product that a warp of a block of WARPS forms:
// rows m0 .. m0 + 15 with m0 = 16 (w % (R / 16)), and NI tiles of 8
// columns from n0 = 8 NI (w / (R / 16)); acc[ni] is the 16 x 8 tile at
// column n0 + 8 ni.
template <int R, int N, int WARPS>
struct Prod {
  static constexpr int NI = R * N / (WARPS * 128);
  static_assert(NI >= 1 && R % 16 == 0 && WARPS % (R / 16) == 0 &&
                    NI * 8 * (WARPS / (R / 16)) == N,
                "the warps cover the result");
  float acc[NI][4];
  int m0, n0;

  __device__ __forceinline__ Prod() {
    const int w = threadIdx.x >> 5;
    m0 = 16 * (w % (R / 16));
    n0 = 8 * NI * (w / (R / 16));
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[ni][c] = 0.f;
  }
  __device__ __forceinline__ int row(int c) const {
    return m0 + lane_g() + 8 * (c >> 1);
  }
  __device__ __forceinline__ int col(int ni, int c) const {
    return n0 + 8 * ni + 2 * lane_t() + (c & 1);
  }
  // acc = f(row, column)
  template <class F>
  __device__ __forceinline__ void init(F f) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[ni][c] = f(row(c), col(ni, c));
  }
  // acc += A . B, A (R x K), B (K x N)
  template <int K, class OA, class OB>
  __device__ __forceinline__ void run(const OA& a, const OB& b) {
    static_assert(K % 16 == 0, "K in steps of 16");
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t fa[4];
      a.load(fa, m0, k0);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        uint32_t fb[2];
        b.load(fb, k0, n0 + 8 * ni);
        mma(acc[ni], fa, fb);
      }
    }
  }
  // f(row, column, v0, v1) on the thread's pairs of neighbouring columns
  template <class F>
  __device__ __forceinline__ void pairs(F f) const {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(row(2 * h), col(ni, 0), acc[ni][2 * h], acc[ni][2 * h + 1]);
  }
  // a bf16 tile (rows of ld) <- bf16(relu(acc))
  __device__ __forceinline__ void store_relu(bf16* t, int ld) const {
    pairs([&](int r, int c, float v0, float v1) {
      *reinterpret_cast<uint32_t*>(t + r * ld + c) =
          pack_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    });
  }
  // an f32 tile (rows of ld) <- acc
  __device__ __forceinline__ void store(float* t, int ld) const {
    pairs([&](int r, int c, float v0, float v1) {
      *reinterpret_cast<float2*>(t + r * ld + c) = make_float2(v0, v1);
    });
  }
};

// dst <- n_mat (K x N) bf16 weights w, transposed (row n of a matrix holds
// its column n); rows of ld, matrices `stride` elements apart.
template <int K, int N>
__device__ __forceinline__ void load_weights(bf16* dst,
                                             const bf16* __restrict__ w,
                                             int n_mat, int ld, int stride,
                                             int threads) {
  for (int i = threadIdx.x; i < n_mat * K * N; i += threads) {
    const int m = i / (K * N), k = (i / N) % K, n = i % N;
    dst[m * stride + n * ld + k] = w[i];
  }
}

// n bf16 values to f32 in shared memory
__device__ __forceinline__ void load_f32(float* dst,
                                         const bf16* __restrict__ src, int n,
                                         int threads) {
  for (int i = threadIdx.x; i < n; i += threads)
    dst[i] = __bfloat162float(src[i]);
}

// Tile `tile`'s e0 rows (kCe bf16, 64 bytes each) into dst (rows of kLdC),
// zeros past the edge count, by cp.async; the caller commits.
__device__ __forceinline__ void stage_e0(bf16* dst,
                                         const bf16* __restrict__ e0,
                                         int n_edges, int tile, int threads) {
  constexpr int kPieces = kCe * 2 / 16;  // 16-byte pieces a row
  const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
  for (int p = threadIdx.x; p < kTE * kPieces; p += threads) {
    const int r = p / kPieces, c = (p % kPieces) * 8;
    const bool valid = r < n_valid;
    tf32x3::cp_async16(dst + r * kLdC + c,
                       valid ? e0 + (size_t)(base + r) * kCe + c : e0, valid);
  }
}

// z = b_e + pxj[sender] + pxi[receiver] at (e, n), zero past n_valid: the
// start of the first product's accumulators (bf16 rows of kH).
__device__ __forceinline__ float fold_z(const float* s_be,
                                        const bf16* __restrict__ pxj,
                                        const bf16* __restrict__ pxi,
                                        const int* snd, const int* rcv,
                                        int n_valid, int e, int n) {
  if (e >= n_valid) return 0.f;
  return s_be[n] + (__bfloat162float(pxj[(size_t)snd[e] * kH + n]) +
                    __bfloat162float(pxi[(size_t)rcv[e] * kH + n]));
}

// The pregathered entry's h_0 = bf16(relu(f32(h0[e]) + f32(pxi[rcv[e]]))),
// or (PE) the pe entry's bf16(relu((f32(pe[e]) + f32(pxj[snd[e]])) +
// f32(pxi[rcv[e]]))), of the tile's edges into dst (bf16 rows of kLdH),
// zeros past n_valid: 16-byte pieces of 8 columns, by a block of THREADS
// threads.  The rows of src, pxj and pxi start 16-byte aligned.
template <int THREADS, bool PE>
__device__ __forceinline__ void first_h0(bf16* dst,
                                         const bf16* __restrict__ src,
                                         const bf16* __restrict__ pxj,
                                         const bf16* __restrict__ pxi,
                                         const int* snd, const int* rcv,
                                         int n_valid, int base) {
  constexpr int kPieces = kH / 8;  // 16-byte pieces a row
  for (int p = threadIdx.x; p < kTE * kPieces; p += THREADS) {
    const int e = p / kPieces, c = (p % kPieces) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (e < n_valid) {
      const uint4 a = __ldg(
          reinterpret_cast<const uint4*>(src + (size_t)(base + e) * kH + c));
      const uint4 b = __ldg(
          reinterpret_cast<const uint4*>(pxi + (size_t)rcv[e] * kH + c));
      if constexpr (PE) {
        const uint4 j = __ldg(
            reinterpret_cast<const uint4*>(pxj + (size_t)snd[e] * kH + c));
        v = make_uint4(relu_sum3(a.x, j.x, b.x), relu_sum3(a.y, j.y, b.y),
                       relu_sum3(a.z, j.z, b.z), relu_sum3(a.w, j.w, b.w));
      } else {
        v = make_uint4(relu_sum(a.x, b.x), relu_sum(a.y, b.y),
                       relu_sum(a.z, b.z), relu_sum(a.w, b.w));
      }
    }
    *reinterpret_cast<uint4*>(dst + e * kLdH + c) = v;
  }
}

// The persistent grid's cap (SMs x resident blocks per SM) of `kernel` on
// the current device; the queries and the shared-memory opt-in run once per
// device (`cache`, zeros: unset).
template <class Kernel>
cudaError_t grid_cap(Kernel kernel, int threads, size_t smem,
                     std::atomic<int> (&cache)[kMaxDevices], int* cap) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && (*cap = cache[device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int optin = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
      cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *cap = n_sm * per_sm;
  if (cached) cache[device].store(*cap, std::memory_order_relaxed);
  return cudaSuccess;
}

// ---- forward ---------------------------------------------------------------

namespace fwd {

constexpr int kThreads = 256;  // 8 warps, two blocks an SM
constexpr int kWarps = kThreads / 32;

// Offsets, in bytes, into dynamic shared memory; the tail weights last, so
// that the others do not move with L1.
struct Layout {
  static constexpr int act = 0;                          // (kTE, kLdH) bf16
  static constexpr int src = act + kTE * kLdH * 2;       // (kTE, kLdC) bf16
  static constexpr int y = src + kTE * kLdC * 2;         // (kTE, kLdCf) f32
  static constexpr int wte = y + kTE * kLdCf * 4;        // W_e^T (kH, kLdC)
  static constexpr int wto = wte + kH * kLdC * 2;        // W_out^T (kC, kLdH)
  static constexpr int be = wto + kC * kLdH * 2;         // (kH) f32
  static constexpr int bo = be + kH * 4;                 // (kC) f32
  static constexpr int rcv = bo + kC * 4;                // 2 x (kTE) int
  static constexpr int snd = rcv + 2 * kTE * 4;          // 2 x (kTE) int
  static constexpr int br = snd + 2 * kTE * 4;           // (L1, kH) f32
  __host__ __device__ static size_t bytes(int l1) {
    return (size_t)br + (size_t)l1 * (kH * 4 + kH * kLdH * 2);
  }
  __host__ __device__ static size_t wtr(int l1) {
    return (size_t)br + (size_t)l1 * kH * 4;
  }
};

// LayerNorm (two-pass variance) of the tile's rows y (rows of kLdCf), in
// place, each result rounded to bf16: four threads an edge, thread q of
// edge e holding columns q, q + 4, ...
__device__ __forceinline__ void layer_norm_bf16(float* s_y,
                                                const float* __restrict__ ln_s,
                                                const float* __restrict__ ln_b) {
  static_assert(kTE * 4 == kThreads, "four threads an edge");
  constexpr int CP = kC / 4;
  const int e = threadIdx.x >> 2, q = threadIdx.x & 3;
  float* row = s_y + e * kLdCf;
  float v[CP];
  float mu = 0.f;
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    v[j] = row[q + 4 * j];
    mu += v[j];
  }
  mu += __shfl_xor_sync(0xffffffffu, mu, 1);
  mu += __shfl_xor_sync(0xffffffffu, mu, 2);
  mu *= 1.f / kC;
  float var = 0.f;
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const float d = v[j] - mu;
    var = fmaf(d, d, var);
  }
  var += __shfl_xor_sync(0xffffffffu, var, 1);
  var += __shfl_xor_sync(0xffffffffu, var, 2);
  var *= 1.f / kC;
  const float rstd = rsqrtf(var + kLnEps);
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const int c = q + 4 * j;
    row[c] = round_bf16((v[j] - mu) * rstd * __ldg(ln_s + c) + __ldg(ln_b + c));
  }
}

// E: the fold entry (src is e0), the pregathered entry (src is h0; we, be,
// pxj, senders are null) or the pe entry (src is pe; we, be are null).
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
  extern __shared__ __align__(16) unsigned char bf16_fwd_smem[];
  unsigned char* sm = bf16_fwd_smem;
  bf16* s_act = reinterpret_cast<bf16*>(sm + L::act);
  bf16* s_src = reinterpret_cast<bf16*>(sm + L::src);
  float* s_y = reinterpret_cast<float*>(sm + L::y);
  bf16* s_wte = reinterpret_cast<bf16*>(sm + L::wte);
  bf16* s_wto = reinterpret_cast<bf16*>(sm + L::wto);
  float* s_be = reinterpret_cast<float*>(sm + L::be);
  float* s_bo = reinterpret_cast<float*>(sm + L::bo);
  int* s_rcv = reinterpret_cast<int*>(sm + L::rcv);
  int* s_snd = reinterpret_cast<int*>(sm + L::snd);
  float* s_br = reinterpret_cast<float*>(sm + L::br);
  bf16* s_wtr = reinterpret_cast<bf16*>(sm + L::wtr(l1));
  const int tid = threadIdx.x, warp = tid >> 5;
  constexpr bool FOLD = E == kFold, GATHERS = E != kPregathered;

  if constexpr (FOLD) {
    load_weights<kCe, kH>(s_wte, we, 1, kLdC, 0, kThreads);
    load_f32(s_be, be, kH, kThreads);
  }
  load_weights<kH, kH>(s_wtr, w_rest, l1, kLdH, kH * kLdH, kThreads);
  load_weights<kH, kC>(s_wto, w_out, 1, kLdH, 0, kThreads);
  load_f32(s_br, b_rest, l1 * kH, kThreads);
  load_f32(s_bo, b_out, kC, kThreads);

  int t_beg, t_end;
  tile128::block_tiles<kTE>(n_edges, &t_beg, &t_end);
  if (t_beg < t_end) {
    if (warp < 2)
      tile128::tile_indices<kTE, GATHERS>(s_rcv, s_snd, senders, rowptr,
                                          n_nodes, n_edges, t_beg, -1);
    if constexpr (FOLD) {
      stage_e0(s_src, src, n_edges, t_beg, kThreads);
      tf32x3::cp_async_commit();
    }
  }
  __syncthreads();  // the weights and the first tile's indices

  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const int n_valid = min(kTE, n_edges - tile * kTE);
    const int* rcv = s_rcv + cur * kTE;
    const int* snd = s_snd + cur * kTE;
    const bool more = tile + 1 < t_end;

    if constexpr (!FOLD) {
      // h_0 = bf16(relu(h0 + pxi[i])) or bf16(relu((pe + pxj[s]) + pxi[i]))
      first_h0<kThreads, E == kPe>(s_act, src, pxj, pxi, snd, rcv, n_valid,
                                   tile * kTE);
      __syncthreads();  // h_0 written; the last tile's sums are done
      if (more && warp < 2)
        tile128::tile_indices<kTE, GATHERS>(
            s_rcv + nxt * kTE, s_snd + nxt * kTE, senders, rowptr, n_nodes,
            n_edges, tile + 1, rcv[n_valid - 1]);
    } else {
      // h_0 = bf16(relu(z + e0 . W_e)); z loaded while the rows arrive
      {
        Prod<kTE, kH, kWarps> p;
        p.init([&](int e, int n) {
          return fold_z(s_be, pxj, pxi, snd, rcv, n_valid, e, n);
        });
        tf32x3::cp_async_wait<0>();
        __syncthreads();  // the rows are in; the last tile's sums are done
        p.run<kCe>(ARows{s_src, kLdC}, BNK{s_wte, kLdC});
        p.store_relu(s_act, kLdH);
      }
      if (more && warp < 2)
        tile128::tile_indices<kTE, true>(s_rcv + nxt * kTE,
                                         s_snd + nxt * kTE, senders, rowptr,
                                         n_nodes, n_edges, tile + 1,
                                         rcv[n_valid - 1]);
      __syncthreads();  // h_0 written, the staging rows free
      if (more) {
        stage_e0(s_src, src, n_edges, tile + 1, kThreads);
        tf32x3::cp_async_commit();
      }
    }

    // h_k = bf16(relu(h_{k-1} . W_k + b_k))
    for (int k = 0; k < l1; ++k) {
      Prod<kTE, kH, kWarps> p;
      const float* b = s_br + k * kH;
      p.init([&](int, int n) { return b[n]; });
      p.run<kH>(ARows{s_act, kLdH}, BNK{s_wtr + k * kH * kLdH, kLdH});
      __syncthreads();  // every warp has read h_{k-1}
      p.store_relu(s_act, kLdH);
      __syncthreads();
    }
    // y = h_L1 . W_out + b_out, then LayerNorm, rounded to bf16
    {
      Prod<kTE, kC, kWarps> p;
      p.init([&](int, int c) { return s_bo[c]; });
      p.run<kH>(ARows{s_act, kLdH}, BNK{s_wto, kLdH});
      p.store(s_y, kLdCf);
    }
    __syncthreads();
    layer_norm_bf16(s_y, ln_s, ln_b);
    __syncthreads();
    csr_tile::receiver_sums<kTE, kC>(
        [&](int e, int c) -> float& { return s_y[e * kLdCf + c]; }, rcv,
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
  const size_t smem = Layout::bytes(kMaxL1);  // one opt-in for every l1
  int cap = 0;
  cudaError_t err =
      grid_cap(edge_tail_kernel<E>, kThreads, smem, cache, &cap);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes == 0 || n_edges <= 0) return (int)cudaSuccess;
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int blocks = n_tiles < cap ? n_tiles : cap;
  edge_tail_kernel<E><<<blocks, kThreads, Layout::bytes(l1), stream>>>(
      src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
      ln_s, ln_b, out, part, n_nodes, n_edges, l1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n_tiles > 1)
    csr_tile::cross_tile_sum_kernel<kTE, kC>
        <<<n_tiles - 1, kC, 0, stream>>>(rowptr, part, out, n_nodes, n_edges);
  return (int)cudaGetLastError();
}

}  // namespace fwd

// ---- backward --------------------------------------------------------------

namespace bwd {

constexpr int kGroups = 2;                // warpgroups a block, each its tiles
constexpr int kThreads = 128 * kGroups;   // one block an SM
constexpr int kTileH = kTE * kH * 2;      // a bf16 (kTE, kH) tile, 128-byte rows
constexpr int kTileC = kTE * kC * 2;      // a bf16 (kTE, kC) tile, 64-byte rows
constexpr int kTileG = kTE * kC * 4;      // an f32 (kTE, kC) tile, 128-byte rows

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Offsets, in bytes, into dynamic shared memory (from its first 1,024-byte
// boundary), and, in floats, into the packed weight-gradient buffer.  The
// block's weights come first, then one part a warpgroup, then the f32
// vectors; every tile lies on a 1,024-byte boundary (the swizzles' repeat).
template <int L1, Entry E>
struct Layout {
  static constexpr int F = E == kFold ? 1 : 0;     // the fold's parts
  static constexpr int J = E != kPregathered ? 1 : 0;  // pxj rows staged
  static constexpr int we = 0;                     // W_e (kCe, kH)
  static constexpr int wr = we + F * kCe * kH * 2;  // L1 x W_k (kH, kH)
  static constexpr int wo = wr + L1 * kH * kH * 2;  // W_out (kH, kC)
  static constexpr int group = wo + kH * kC * 2;   // warpgroup 0's part
  // a warpgroup's part, from its start
  static constexpr int act = 0;                    // h_0 .. h_L1 (kTE, kH)
  static constexpr int da = act + (L1 + 1) * kTileH;  // 2 x bf16(da) (kTE, kH)
  static constexpr int dy = da + 2 * kTileH;       // bf16(dy) (kTE, kC)
  static constexpr int src = dy + kTileC;  // 2 x e0 (kTE, kCe), or h0 / pe
  static constexpr int pxj = src + (F ? 2 * kTileC : kTileH);  // pxj[s] rows
  static constexpr int pxi = pxj + J * kTileH;     // pxi[i] rows
  static constexpr int g = pxi + kTileH;           // g[i] rows, f32 (kTE, kC)
  static constexpr int idx = g + kTileG;           // 2 x rcv, 2 x snd (kTE)
  static constexpr int sums = idx + 4 * kTE * 4;   // 4 warps x kSums f32
  // a warp's row of bias-gradient sums: db_e, db_1 .. db_L1, db_out,
  // d_ln_s, d_ln_b
  static constexpr int s_be = 0;
  static constexpr int s_br = s_be + F * kH;
  static constexpr int s_bo = s_br + L1 * kH;
  static constexpr int s_ls = s_bo + kC;
  static constexpr int s_lb = s_ls + kC;
  static constexpr int kSums = s_lb + kC;
  static constexpr int group_bytes = round_up(sums + 4 * kSums * 4, 1024);
  static constexpr int vec = group + kGroups * group_bytes;  // f32 b_e,
  static constexpr int v_be = vec;                 // b_1 .. b_L1, b_out, ln_s
  static constexpr int v_br = v_be + F * kH * 4;
  static constexpr int v_bo = v_br + L1 * kH * 4;
  static constexpr int v_ls = v_bo + kC * 4;
  static constexpr int bytes = v_ls + kC * 4 + 1024;  // + the base's alignment

  static constexpr int g_we = 0;
  static constexpr int g_be = g_we + F * kCe * kH;
  static constexpr int g_wr = g_be + F * kH;
  static constexpr int g_br = g_wr + L1 * kH * kH;
  static constexpr int g_wo = g_br + L1 * kH;
  static constexpr int g_bo = g_wo + kH * kC;
  static constexpr int g_ls = g_bo + kC;
  static constexpr int g_lb = g_ls + kC;
  static constexpr int g_total = g_lb + kC;

  static_assert(bytes <= 232448, "one block an SM");
  static_assert((32 * (L1 > 0 ? L1 : 1) + 32) * 128 * 4 <= idx,
                "warpgroup 0's weight gradients fit in its tiles");
};

// The warpgroup's named barrier (1 + its index; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + grp) : "memory");
}

__device__ __forceinline__ float2 ld_pair(const unsigned char* tile,
                                          uint32_t off) {
  return unpack(*reinterpret_cast<const uint32_t*>(tile + off));
}

// A warp's column sums over its 16 rows of an m64n64 accumulator: s[2 j +
// p] holds the thread's two rows' sum at column 8 j + 2 t + p; the eight
// lanes of a t share out the columns in three halving shuffle rounds, so
// that lane 4 g + t returns the sums of columns 8 g + 2 t and + 1.
__device__ __forceinline__ float2 warp_column_sums64(const float (&s)[16]) {
  const int lane = threadIdx.x & 31;
  float a[8], b[4], c[2];
  bool hi = lane & 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = (hi ? s[i + 8] : s[i]) +
           __shfl_xor_sync(0xffffffffu, hi ? s[i] : s[i + 8], 16);
  hi = lane & 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = (hi ? a[i + 4] : a[i]) +
           __shfl_xor_sync(0xffffffffu, hi ? a[i] : a[i + 4], 8);
  hi = lane & 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (hi ? b[i + 2] : b[i]) +
           __shfl_xor_sync(0xffffffffu, hi ? b[i] : b[i + 2], 4);
  return make_float2(c[0], c[1]);
}
// As warp_column_sums64 for an m64n32 accumulator (s[8]): lane 4 g + t
// returns the sum of column 8 (g / 2) + 2 t + g % 2.
__device__ __forceinline__ float warp_column_sums32(const float (&s)[8]) {
  const int lane = threadIdx.x & 31;
  float a[4], b[2];
  bool hi = lane & 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (hi ? s[i + 4] : s[i]) +
           __shfl_xor_sync(0xffffffffu, hi ? s[i] : s[i + 4], 16);
  hi = lane & 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (hi ? a[i + 2] : a[i]) +
           __shfl_xor_sync(0xffffffffu, hi ? a[i] : a[i + 2], 8);
  hi = lane & 4;
  return (hi ? b[1] : b[0]) +
         __shfl_xor_sync(0xffffffffu, hi ? b[0] : b[1], 4);
}
// row[column] += this warp's column sums (each lane its own columns)
__device__ __forceinline__ void add_column_sums64(float* row,
                                                  const float (&s)[16]) {
  const int lane = threadIdx.x & 31;
  const float2 v = warp_column_sums64(s);
  const int col = 8 * (lane >> 2) + 2 * (lane & 3);
  row[col] += v.x;
  row[col + 1] += v.y;
}
__device__ __forceinline__ void add_column_sums32(float* row,
                                                  const float (&s)[8]) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  row[8 * (g >> 1) + 2 * (lane & 3) + (g & 1)] += warp_column_sums32(s);
}

// The accumulator's rows of this thread: r0 and r0 + 8 (wgmma.cuh).
__device__ __forceinline__ int acc_row0() {
  return 16 * ((threadIdx.x & 127) >> 5) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int acc_col0() { return 2 * (threadIdx.x & 3); }

// A data gradient's epilogue: the m64n64 accumulator d (da = d . W^T of
// the layer above) masked where h (the layer's input tile, bf16) is not
// positive, in place; bf16(d) into the tile `out` and into a, the A
// fragments of the product that reads it next; the masked column sums
// added to the warp's row `sums` (null: not kept).
__device__ __forceinline__ void mask_store(float (&d)[32],
                                           const unsigned char* h,
                                           unsigned char* out, float* sums,
                                           uint32_t (&a)[4][4]) {
  const int r0 = acc_row0(), c0 = acc_col0();
  float s[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[2 * j] = s[2 * j + 1] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = 4 * j + 2 * hh;
      const uint32_t off = wg::at<128>(r0 + 8 * hh, 8 * j + c0);
      const uint32_t m = *reinterpret_cast<const uint32_t*>(h + off);
      d[i] = (m & 0xffffu) != 0 ? d[i] : 0.f;  // h > 0: h is bf16(relu(.))
      d[i + 1] = (m >> 16) != 0 ? d[i + 1] : 0.f;
      const uint32_t v = pack_rn(d[i], d[i + 1]);
      *reinterpret_cast<uint32_t*>(out + off) = v;
      a[i >> 3][(i >> 1) & 3] = v;
      s[2 * j] += d[i];
      s[2 * j + 1] += d[i + 1];
    }
  }
  if (sums != nullptr) add_column_sums64(sums, s);
}

// bf16(relu(d)) of an m64n64 accumulator into the tile `out` and into a,
// the A fragments of the product that reads it next (wgmma.cuh).
__device__ __forceinline__ void store_relu(const float (&d)[32],
                                           unsigned char* out,
                                           uint32_t (&a)[4][4]) {
  const int r0 = acc_row0(), c0 = acc_col0();
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const uint32_t v = pack_rn(fmaxf(d[i], 0.f), fmaxf(d[i + 1], 0.f));
    *reinterpret_cast<uint32_t*>(
        out + wg::at<128>(r0 + 8 * ((i >> 1) & 1), 8 * (i >> 2) + c0)) = v;
    a[i >> 3][(i >> 1) & 3] = v;
  }
}

// d = v[column] (f32 in shared memory) on every element of an accumulator.
template <int R>
__device__ __forceinline__ void init_columns(float (&d)[R], const float* v) {
  const int c0 = acc_col0();
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = v[8 * (i >> 2) + c0 + (i & 1)];
}

// `n_valid` rows row(r) (global, 16-byte aligned, RB bytes each) into a
// tile of RB-byte rows in the 128- or 64-byte swizzle, zeros past n_valid,
// by the warpgroup's threads through cp.async; the caller commits.
template <int RB, class Row>
__device__ __forceinline__ void stage_rows(unsigned char* tile, int n_valid,
                                           const void* any, Row row) {
  constexpr int kChunks = RB / 16;
  for (int p = threadIdx.x & 127; p < kTE * kChunks; p += 128) {
    const int r = p / kChunks, c = p % kChunks;
    const bool valid = r < n_valid;
    const unsigned char* s =
        valid ? reinterpret_cast<const unsigned char*>(row(r)) + 16 * c
              : reinterpret_cast<const unsigned char*>(any);
    tf32x3::cp_async16(tile + wg::swz<RB>(r * RB + 16 * c), s, valid);
  }
}

// `rows` rows of RB bytes of a weight (global, 16-byte aligned) into its
// tile in the RB-byte swizzle, by the block's threads through cp.async; the
// caller commits.
template <int RB>
__device__ __forceinline__ void copy_weight(unsigned char* dst,
                                            const bf16* __restrict__ w,
                                            int rows) {
  constexpr int kChunks = RB / 16;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(w);
  for (int p = threadIdx.x; p < rows * kChunks; p += kThreads)
    tf32x3::cp_async16(dst + wg::swz<RB>(16 * p), src + 16 * p, true);
}

// A warp's share of the next tile's indices (its 32 edges from base),
// split around the tile's first product so that the loads' latency hides
// under it: issue() loads the 32 row starts after `hint`, the receiver of
// an edge before base (>= 0), and the senders; finish() forms the receivers
// as tile128::warp_receiver does from that hint (the count of row starts at
// or before each edge by a five-step search over the sorted starts in place
// of its 32 comparisons) and stores both.  The width-128 source's
// IndexLoad.
struct IndexLoad {
  int start, snd;

  template <bool GATHERS>
  __device__ __forceinline__ void issue(const int* __restrict__ rowptr,
                                        const int* __restrict__ senders,
                                        int n_nodes, int base, int n_valid,
                                        int hint) {
    const int lane = threadIdx.x & 31;
    const int j = hint + 1 + lane;
    start = j <= n_nodes ? __ldg(rowptr + j) : 0x7fffffff;
    snd = GATHERS && lane < n_valid ? __ldg(senders + base + lane) : 0;
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

// The bias-gradient row of layer `k`'s input gradient da_k (k >= 1: b_k;
// k = 0: the fold's b_e), or -1 where none is kept (da_0 off the fold).
template <int L1, Entry E>
__host__ __device__ constexpr int sums_of(int k) {
  using L = Layout<L1, E>;
  return k >= 1 ? L::s_br + (k - 1) * kH : (E == kFold ? L::s_be : -1);
}

// The thread's running weight-gradient sums, dW_k (in x out), dW_out (kH x
// kC) and the fold's dW_e^T (kH x kCe), into its slots: slot j of thread t
// at slots[j 128 + t] (free of bank conflicts), j = 32 k + i for dW_k's
// d[i], 32 NL + i for dW_out's, 32 NL + 16 + i for dW_e^T's.
template <int NL>
__device__ __forceinline__ void store_slots(float* slots,
                                            const float (&run_w)[NL][32],
                                            const float (&run_wo)[16],
                                            const float (&run_we)[16]) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int k = 0; k < NL; ++k) slots[(32 * k + i) * 128 + t] = run_w[k][i];
    if (i < 16) {
      slots[(32 * NL + i) * 128 + t] = run_wo[i];
      slots[(32 * NL + 16 + i) * 128 + t] = run_we[i];
    }
  }
}

// The block's weight gradients into its partial row p (the packed layout):
// warpgroup 0's slots s0 plus warpgroup 1's s1 (store_slots), in that order;
// thread t of warpgroup grp writes the accumulator pairs (i, i + 1) of its
// place with (i / 2) % 2 == grp, a pair of neighbouring columns a store.
template <int L1, bool FOLD>
__device__ __forceinline__ void write_partial(float* p, const float* s0,
                                              const float* s1, int grp) {
  using L = Layout<L1, FOLD ? kFold : kPe>;
  constexpr int NL = L1 > 0 ? L1 : 1;
  const int t = threadIdx.x & 127;
  auto sum = [&](int slot) { return s0[slot * 128 + t] + s1[slot * 128 + t]; };
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    if (((i >> 1) & 1) != grp) continue;
    const int m = wg::acc_row(i), n = wg::acc_col(i);  // n even
#pragma unroll
    for (int k = 0; k < L1; ++k)
      *reinterpret_cast<float2*>(p + L::g_wr + k * kH * kH + m * kH + n) =
          make_float2(sum(32 * k + i), sum(32 * k + i + 1));
    if (i < 16) {
      *reinterpret_cast<float2*>(p + L::g_wo + m * kC + n) =
          make_float2(sum(32 * NL + i), sum(32 * NL + i + 1));
      if constexpr (FOLD) {
        p[L::g_we + n * kH + m] = sum(32 * NL + 16 + i);
        p[L::g_we + (n + 1) * kH + m] = sum(32 * NL + 16 + i + 1);
      }
    }
  }
}

// E: the fold entry (src is e0, d_src d_e0), the pregathered entry (src is
// h0, d_src d_h0 (E, kH); we, be, pxj, senders, d_pxj are null) or the pe
// entry (src is pe, d_src d_pe (E, kH) and dz_out dz (E, kH) f32; we, be,
// d_pxj are null).  dz_out is null but for pe.
template <int L1, Entry E>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_bwd_kernel(const bf16* __restrict__ src, const bf16* __restrict__ we,
                 const bf16* __restrict__ be, const bf16* __restrict__ pxj,
                 const bf16* __restrict__ pxi, const int* __restrict__ senders,
                 const int* __restrict__ rowptr,
                 const bf16* __restrict__ w_rest,
                 const bf16* __restrict__ b_rest,
                 const bf16* __restrict__ w_out,
                 const bf16* __restrict__ b_out,
                 const float* __restrict__ ln_s, const float* __restrict__ g,
                 bf16* __restrict__ d_src, float* __restrict__ dz_out,
                 float* __restrict__ d_pxj, float* __restrict__ d_pxi,
                 float* __restrict__ partial, int n_nodes, int n_edges) {
  using L = Layout<L1, E>;
  constexpr bool FOLD = E == kFold, GATHERS = E != kPregathered;
  constexpr int NL = L1 > 0 ? L1 : 1;
  extern __shared__ __align__(16) unsigned char bf16_bwd_smem[];
  unsigned char* sm = bf16_bwd_smem + ((1024 - (wg::smem_addr(bf16_bwd_smem)
                                                & 1023)) & 1023);
  const int tid = threadIdx.x, grp = tid >> 7, t = tid & 127, w = t >> 5;
  unsigned char* s_we = sm + L::we;
  unsigned char* s_wr = sm + L::wr;
  unsigned char* s_wo = sm + L::wo;
  const float* v_be = reinterpret_cast<const float*>(sm + L::v_be);
  const float* v_br = reinterpret_cast<const float*>(sm + L::v_br);
  const float* v_bo = reinterpret_cast<const float*>(sm + L::v_bo);
  const float* v_ls = reinterpret_cast<const float*>(sm + L::v_ls);
  unsigned char* gp = sm + L::group + grp * L::group_bytes;
  auto act = [&](int k) { return gp + L::act + k * kTileH; };
  auto da = [&](int a) { return gp + L::da + a * kTileH; };
  unsigned char* s_dy = gp + L::dy;
  auto e0_tile = [&](int buf) { return gp + L::src + buf * kTileC; };
  unsigned char* s_src = gp + L::src;
  unsigned char* s_pxj = gp + L::pxj;
  unsigned char* s_pxi = gp + L::pxi;
  unsigned char* s_g = gp + L::g;
  int* s_rcv = reinterpret_cast<int*>(gp + L::idx);
  int* s_snd = s_rcv + 2 * kTE;
  float* sums = reinterpret_cast<float*>(gp + L::sums) + w * L::kSums;

  // the weights by cp.async, each once in its swizzle as stored (in, out);
  // the f32 vectors; the warps' sums rows zeroed
  if constexpr (FOLD) {
    copy_weight<128>(s_we, we, kCe);
    for (int i = tid; i < kH; i += kThreads)
      reinterpret_cast<float*>(sm + L::v_be)[i] = __bfloat162float(be[i]);
  }
  copy_weight<128>(s_wr, w_rest, L1 * kH);  // L1 tiles of kH rows
  copy_weight<64>(s_wo, w_out, kH);
  tf32x3::cp_async_commit();
  for (int i = tid; i < L1 * kH; i += kThreads)
    reinterpret_cast<float*>(sm + L::v_br)[i] = __bfloat162float(b_rest[i]);
  for (int i = tid; i < kC; i += kThreads) {
    reinterpret_cast<float*>(sm + L::v_bo)[i] = __bfloat162float(b_out[i]);
    reinterpret_cast<float*>(sm + L::v_ls)[i] = __ldg(ln_s + i);
  }
  for (int i = t; i < 4 * L::kSums; i += 128)
    reinterpret_cast<float*>(gp + L::sums)[i] = 0.f;

  // the block's tiles [b0, b1), balanced over the grid; warpgroup 0 walks
  // the first half (rounded up), warpgroup 1 the rest
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int b0 = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  const int b1 = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
  const int mid = b0 + (b1 - b0 + 1) / 2;
  const int t_beg = grp == 0 ? b0 : mid, t_end = grp == 0 ? mid : b1;

  // the warpgroup's weight gradients, summed over its tiles in the
  // products' accumulators: dW_k (in x out), dW_out (kH x kC), dW_e^T (kH
  // x kCe)
  float run_w[NL][32], run_wo[16], run_we[16];
#pragma unroll
  for (int k = 0; k < NL; ++k)
#pragma unroll
    for (int i = 0; i < 32; ++i) run_w[k][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) run_wo[i] = run_we[i] = 0.f;

  // this tile's rows (e0 / h0 / pe, and the node rows), staged by cp.async
  auto stage_tile = [&](int tile, int buf, const int* rcv, const int* snd) {
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    if constexpr (FOLD)
      stage_rows<64>(e0_tile(buf), n_valid, src,
                     [&](int r) { return src + (size_t)(base + r) * kCe; });
    else
      stage_rows<128>(s_src, n_valid, src,
                      [&](int r) { return src + (size_t)(base + r) * kH; });
    if constexpr (GATHERS)
      stage_rows<128>(s_pxj, n_valid, pxj,
                      [&](int r) { return pxj + (size_t)snd[r] * kH; });
    stage_rows<128>(s_pxi, n_valid, pxi,
                    [&](int r) { return pxi + (size_t)rcv[r] * kH; });
  };
  auto stage_g = [&](int tile, const int* rcv) {
    const int n_valid = min(kTE, n_edges - tile * kTE);
    stage_rows<128>(s_g, n_valid, g,
                    [&](int r) { return g + (size_t)rcv[r] * kC; });
  };

  // while the weights arrive: the first tile's indices (a full search) and
  // rows; a warpgroup without a tile commits two empty groups, so that
  // every thread's wait below covers the weights alone
  if (t_beg < t_end) {
    if (w < 2)
      tile128::tile_indices<kTE, GATHERS>(s_rcv, s_snd, senders, rowptr,
                                          n_nodes, n_edges, t_beg, -1);
    group_sync(grp);  // the first tile's indices
    stage_tile(t_beg, 0, s_rcv, s_snd);
  }
  tf32x3::cp_async_commit();
  if (t_beg < t_end) stage_g(t_beg, s_rcv);
  tf32x3::cp_async_commit();
  tf32x3::cp_async_wait<2>();
  wg::fence_async_smem();
  __syncthreads();  // the weights

  const int r0 = acc_row0(), c0 = acc_col0();
  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    const int* rcv = s_rcv + cur * kTE;
    const int* snd = s_snd + cur * kTE;
    const bool more = tile + 1 < t_end;
    float acc[32];
    // bf16 A fragments of the products that read A from registers: the
    // layer below's output (K = kH), bf16(dy) (K = kC); each stays alive
    // until the wait that covers its product (fence_operand)
    uint32_t a[kH / 16][4], a_dy[kC / 16][4];

    tf32x3::cp_async_wait<1>();  // this tile's rows (its g may still fly)
    wg::fence_async_smem();
    group_sync(grp);
    // warps 0 and 1: the next tile's indices, loads issued now, the search
    // finished after h_0
    const int next_base = (tile + 1) * kTE + 32 * w;
    const int next_valid = min(32, n_edges - next_base);
    IndexLoad next;
    if (more && w < 2)
      next.issue<GATHERS>(rowptr, senders, n_nodes, next_base, next_valid,
                          rcv[n_valid - 1]);

    // h_0: fold bf16(relu(e0 . W_e + (b_e + (pxj[s] + pxi[i])))), the
    // accumulators started at z from the staged node rows; pe / pregathered
    // elementwise from the staged rows
    if constexpr (FOLD) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = r0 + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + c0;
        const uint32_t off = wg::at<128>(r, c);
        const float2 j = ld_pair(s_pxj, off), p = ld_pair(s_pxi, off);
        acc[i] = r < n_valid ? v_be[c] + (j.x + p.x) : 0.f;
        acc[i + 1] = r < n_valid ? v_be[c + 1] + (j.y + p.y) : 0.f;
      }
      wg::fence_operand(acc);
      wg::fence();
      wg::product<kCe / 16, 0, 1, 64, 128>(acc, e0_tile(cur), s_we, true);
      wg::commit();
    } else {
      for (int p = t; p < kTE * 8; p += 128) {
        const uint32_t off = wg::swz<128>(16 * p);  // row p / 8, chunk p % 8
        const uint4 a = *reinterpret_cast<const uint4*>(s_src + off);
        const uint4 b = *reinterpret_cast<const uint4*>(s_pxi + off);
        uint4 v;
        if constexpr (E == kPe) {
          const uint4 j = *reinterpret_cast<const uint4*>(s_pxj + off);
          v = make_uint4(relu_sum3(a.x, j.x, b.x), relu_sum3(a.y, j.y, b.y),
                         relu_sum3(a.z, j.z, b.z), relu_sum3(a.w, j.w, b.w));
        } else {
          v = make_uint4(relu_sum(a.x, b.x), relu_sum(a.y, b.y),
                         relu_sum(a.z, b.z), relu_sum(a.w, b.w));
        }
        *reinterpret_cast<uint4*>(act(0) + off) = v;
      }
    }
    if (more && w < 2)
      next.finish<GATHERS>(s_rcv + nxt * kTE + 32 * w,
                           s_snd + nxt * kTE + 32 * w, rowptr, n_nodes,
                           next_base, next_valid, rcv[n_valid - 1]);
    __syncwarp();  // the lanes meet before the warpgroup's wait
    if constexpr (FOLD) {
      wg::wait<0>();
      wg::fence_operand(acc);
      store_relu(acc, act(0), a);
    }
    tf32x3::cp_async_wait<0>();  // this tile's g rows
    wg::fence_async_smem();
    group_sync(grp);  // h_0 and the next indices written, the rows read
    if (more)  // into the buffers this tile has read
      stage_tile(tile + 1, nxt, s_rcv + nxt * kTE, s_snd + nxt * kTE);
    tf32x3::cp_async_commit();

    // h_k = bf16(relu(h_{k-1} . W_k + b_k)), k = 1 .. L1: h_0 from its
    // tile, each later layer from the registers the layer below left, so
    // no barrier comes between them (the tiles are read from the output
    // layer on, past its barrier)
#pragma unroll
    for (int k = 1; k <= L1; ++k) {
      init_columns(acc, v_br + (k - 1) * kH);
      wg::fence_operand(acc);
      wg::fence();
      if (k == 1)
        wg::product<kH / 16, 0, 1, 128, 128>(acc, act(0), s_wr, true);
      else
        wg::product_rs<kH / 16, 1, 128>(acc, a, s_wr + (k - 1) * kTileH,
                                        true);
      wg::commit();
      wg::wait<0>();
      wg::fence_operand(acc);
      wg::fence_operand(a);
      store_relu(acc, act(k), a);
    }

    // y = h_L1 . W_out + b_out; LayerNorm's backward in its accumulators:
    // dy = rstd (dx - mean dx - xhat mean(dx xhat)), dx = bf16(g[i]) ln_s,
    // each row's statistics over the four threads of its quad (two-pass
    // variance); bf16(dy) into its tile; the column sums of dy, bf16(g)
    // xhat and bf16(g) into the warp's row
    {
      float y[16];
      init_columns(y, v_bo);
      wg::fence_operand(y);
      wg::fence();
      if constexpr (L1 == 0)
        wg::product<kH / 16, 0, 1, 128, 64>(y, act(0), s_wo, true);
      else
        wg::product_rs<kH / 16, 1, 64>(y, a, s_wo, true);
      wg::commit();
      wg::wait<0>();
      wg::fence_operand(y);
      wg::fence_operand(a);
      float col_dy[8], col_gx[8], col_g[8];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        float v[8], gv[8];
        float mu = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[2 * j] = y[4 * j + 2 * hh];
          v[2 * j + 1] = y[4 * j + 2 * hh + 1];
          const float2 gg = *reinterpret_cast<const float2*>(
              s_g + wg::swz<128>(r * 128 + (8 * j + c0) * 4));
          gv[2 * j] = round_bf16(gg.x);
          gv[2 * j + 1] = round_bf16(gg.y);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) mu += v[q];
        mu += __shfl_xor_sync(0xffffffffu, mu, 1);
        mu += __shfl_xor_sync(0xffffffffu, mu, 2);
        mu *= 1.f / kC;
        float var = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float dv = v[q] - mu;
          var = fmaf(dv, dv, var);
        }
        var += __shfl_xor_sync(0xffffffffu, var, 1);
        var += __shfl_xor_sync(0xffffffffu, var, 2);
        var *= 1.f / kC;
        const float rstd = rsqrtf(var + kLnEps);
        float m1 = 0.f, m2 = 0.f, dx[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          v[q] = (v[q] - mu) * rstd;  // xhat
          dx[q] = gv[q] * v_ls[8 * (q >> 1) + c0 + (q & 1)];
          m1 += dx[q];
          m2 = fmaf(dx[q], v[q], m2);
        }
        m1 += __shfl_xor_sync(0xffffffffu, m1, 1);
        m1 += __shfl_xor_sync(0xffffffffu, m1, 2);
        m2 += __shfl_xor_sync(0xffffffffu, m2, 1);
        m2 += __shfl_xor_sync(0xffffffffu, m2, 2);
        m1 *= 1.f / kC;
        m2 *= 1.f / kC;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float d = rstd * (dx[q] - m1 - v[q] * m2);
          if (hh == 0) {
            col_dy[q] = d;
            col_gx[q] = gv[q] * v[q];
            col_g[q] = gv[q];
          } else {
            col_dy[q] += d;
            col_gx[q] += gv[q] * v[q];
            col_g[q] += gv[q];
          }
          dx[q] = d;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t v = pack_rn(dx[2 * j], dx[2 * j + 1]);
          *reinterpret_cast<uint32_t*>(s_dy + wg::at<64>(r, 8 * j + c0)) = v;
          a_dy[j >> 1][2 * (j & 1) + hh] = v;  // pair 4 j + 2 hh
        }
      }
      add_column_sums32(sums + L::s_bo, col_dy);
      add_column_sums32(sums + L::s_ls, col_gx);
      add_column_sums32(sums + L::s_lb, col_g);
      // the output layer: da_L1 = bf16(dy) . W_out^T from registers, issued
      // before the barrier
      wg::fence();
      wg::product_rs<kC / 16, 0, 64>(acc, a_dy, s_wo, false);
      wg::commit();
    }
    wg::fence_async_smem();
    group_sync(grp);  // bf16(dy) and h_1 .. h_L1 written, the g rows read
    if (more) stage_g(tile + 1, s_rcv + nxt * kTE);
    tf32x3::cp_async_commit();

    // dW_out += h_L1^T . bf16(dy), a group of its own that runs on under
    // the epilogue (every weight-gradient product does: the next data
    // gradient's wait retires it, before that layer's barrier); da_L1
    // masked where h_L1 > 0, into da(0)
    wg::product<kTE / 16, 1, 1, 128, 64>(run_wo, act(L1), s_dy, true);
    wg::commit();
    wg::wait<1>();
    wg::fence_operand(acc);
    wg::fence_operand(a_dy);
    {
      constexpr int row = sums_of<L1, E>(L1);
      mask_store(acc, act(L1), da(0), row < 0 ? nullptr : sums + row, a);
    }

    // the tail layers, last to first: dW_k += h_{k-1}^T . bf16(da_k), and
    // da_{k-1} = (bf16(da_k) . W_k^T) where h_{k-1} > 0
#pragma unroll
    for (int k = L1; k >= 1; --k) {
      const int b = (L1 - k) & 1;  // da_k is in da(b)
      // da_{k-1} = bf16(da_k) . W_k^T from registers; the wait retires the
      // layer above's dW (every warp's, by the barrier) before da(b ^ 1),
      // which it read, is written again
      wg::fence();
      wg::product_rs<kH / 16, 0, 128>(acc, a, s_wr + (k - 1) * kTileH,
                                      false);
      wg::commit();
      wg::wait<1>();
      wg::fence_async_smem();
      group_sync(grp);  // da(b) written; the dW above retired
      wg::product<kTE / 16, 1, 1, 128, 128>(run_w[k - 1], act(k - 1), da(b),
                                            true);
      wg::commit();
      wg::wait<1>();
      wg::fence_operand(acc);
      wg::fence_operand(a);
      const int row = sums_of<L1, E>(k - 1);
      mask_store(acc, act(k - 1), da(b ^ 1), row < 0 ? nullptr : sums + row,
                 a);
    }

    // dz = da_0: acc (f32, masked) and bf16(dz) in da(L1 & 1)
    const unsigned char* dz = da(L1 & 1);
    auto dz_at = [&](int e, int n) {
      return __bfloat162float(
          *reinterpret_cast<const bf16*>(dz + wg::at<128>(e, n)));
    };
    float de[16];
    if constexpr (FOLD) {
      // d_e0 = bf16(bf16(dz) . W_e^T) from registers, and dW_e^T +=
      // bf16(dz)^T . e0, while the atomics below run
      wg::fence();
      wg::product_rs<kH / 16, 0, 128>(de, a, s_we, false);
      wg::commit();
      wg::fence_async_smem();
      group_sync(grp);  // bf16(dz) written
      wg::product<kTE / 16, 1, 1, 128, 64>(run_we, dz, e0_tile(cur), true);
      wg::commit();
      // d_pxj[s] += bf16(dz), four columns an atomic add
      for (int k = t; k < n_valid * (kH / 4); k += 128) {
        const int e = k >> 4, n = 4 * (k & 15);
        const uint2 v =
            *reinterpret_cast<const uint2*>(dz + wg::at<128>(e, n));
        const float2 a = unpack(v.x), b = unpack(v.y);
        atomicAdd(reinterpret_cast<float4*>(d_pxj + (size_t)snd[e] * kH + n),
                  make_float4(a.x, a.y, b.x, b.y));
      }
    } else {
      group_sync(grp);  // bf16(dz) written
      // d_h0 / d_pe = bf16(dz), 16-byte rows pieces; pe: dz itself
      for (int p = t; p < n_valid * 8; p += 128)
        *reinterpret_cast<uint4*>(d_src + (size_t)(base + (p >> 3)) * kH +
                                  8 * (p & 7)) =
            *reinterpret_cast<const uint4*>(dz + wg::swz<128>(16 * p));
      if constexpr (E == kPe) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = r0 + 8 * ((i >> 1) & 1);
          if (r < n_valid)
            *reinterpret_cast<float2*>(dz_out + (size_t)(base + r) * kH +
                                       8 * (i >> 2) + c0) =
                make_float2(acc[i], acc[i + 1]);
        }
      }
    }
    {  // d_pxi[i] += bf16(dz), a sum a run of equal receivers in each
       // half, eight edges' loads at a time
      const int n = t & (kH - 1);
      const int e_beg = (t >> 6) * (kTE / 2);
      const int e_end = min(e_beg + kTE / 2, n_valid);
      if (e_beg < e_end) {
        int at = rcv[e_beg];
        float s = 0.f;
        for (int e0 = e_beg; e0 < e_end; e0 += 8) {
          int rr[8];
          float vv[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const bool valid = e0 + q < e_end;
            rr[q] = valid ? rcv[e0 + q] : at;
            vv[q] = valid ? dz_at(e0 + q, n) : 0.f;
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (rr[q] != at) {
              atomicAdd(d_pxi + (size_t)at * kH + n, s);
              s = 0.f;
              at = rr[q];
            }
            s += vv[q];
          }
        }
        atomicAdd(d_pxi + (size_t)at * kH + n, s);
      }
    }
    if constexpr (FOLD) {
      __syncwarp();
      wg::wait<1>();
      wg::fence_operand(de);
      wg::fence_operand(a);
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = r0 + 8 * ((i >> 1) & 1);
        if (r < n_valid)
          *reinterpret_cast<uint32_t*>(d_src + (size_t)(base + r) * kCe +
                                       8 * (i >> 2) + c0) =
              pack_rn(de[i], de[i + 1]);
      }
    }
    __syncwarp();
    wg::wait<0>();  // the weight-gradient products: their tiles are reused
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) wg::fence_operand(run_w[k]);
  wg::fence_operand(run_wo);
  wg::fence_operand(run_we);
  tf32x3::cp_async_wait<0>();
  __syncthreads();  // both warpgroups are done; their tiles are free

  // the block's partial row: each warpgroup's weight gradients through its
  // own tiles (store_slots), then both write the sums, warpgroup 0's plus
  // warpgroup 1's, half the places each; the bias sums of the eight warps'
  // rows added in warp order
  float* p = partial + (size_t)blockIdx.x * L::g_total;
  store_slots(reinterpret_cast<float*>(gp), run_w, run_wo, run_we);
  __syncthreads();
  write_partial<L1, FOLD>(p, reinterpret_cast<const float*>(sm + L::group),
                          reinterpret_cast<const float*>(sm + L::group +
                                                         L::group_bytes),
                          grp);
  const float* rows = reinterpret_cast<const float*>(sm + L::group + L::sums);
  for (int c = tid; c < L::kSums; c += kThreads) {
    float s = 0.f;
    for (int q = 0; q < kGroups * 4; ++q)
      s += rows[(q >> 2) * (L::group_bytes / 4) + (q & 3) * L::kSums + c];
    const int at = c < L::s_br   ? L::g_be + c
                   : c < L::s_bo ? L::g_br + c - L::s_br
                   : c < L::s_ls ? L::g_bo + c - L::s_bo
                   : c < L::s_lb ? L::g_ls + c - L::s_ls
                                 : L::g_lb + c - L::s_lb;
    p[at] = s;
  }
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

// kernels the last call launched (its own count, for the checks)
std::atomic<int> last_launches{0};

// The kernel on a grid of at most scratch_blocks blocks (one an SM), block
// b over tiles [b T / B, (b + 1) T / B), then the fixed-order sum of the
// blocks' partials: two launches.
template <int L1, Entry E>
int launch(const bf16* src, const bf16* we, const bf16* be, const bf16* pxj,
           const bf16* pxi, const int* senders, const int* rowptr,
           const bf16* w_rest, const bf16* b_rest, const bf16* w_out,
           const bf16* b_out, const float* ln_s, const float* g, bf16* d_src,
           float* dz_out, float* d_pxj, float* d_pxi, float* wgrad,
           float* partial, int n_nodes, int n_edges, int scratch_blocks,
           cudaStream_t stream) {
  using L = Layout<L1, E>;
  static std::atomic<int> cache[kMaxDevices];
  int cap = 0, launches = 0;
  const cudaError_t err = grid_cap(wgmma_bwd_kernel<L1, E>, kThreads,
                                   (size_t)L::bytes, cache, &cap);
  if (err != cudaSuccess) return (int)err;
  if (cap > scratch_blocks) cap = scratch_blocks;
  const int n_tiles = n_nodes > 0 ? (n_edges + kTE - 1) / kTE : 0;
  if (n_tiles > 0 && cap < 1) return (int)cudaErrorInvalidValue;
  const int blocks = n_tiles < cap ? n_tiles : cap;
  if (blocks > 0) {
    wgmma_bwd_kernel<L1, E><<<blocks, kThreads, L::bytes, stream>>>(
        src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
        ln_s, g, d_src, dz_out, d_pxj, d_pxi, partial, n_nodes, n_edges);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return (int)launched;
    ++launches;
  }
  reduce_partials_kernel<<<(L::g_total + 255) / 256, 256, 0, stream>>>(
      partial, wgrad, blocks, L::g_total);
  last_launches.store(++launches, std::memory_order_relaxed);
  return (int)cudaGetLastError();
}

// launch<L1, E> at a run-time l1 in 0..kMaxL1
template <Entry E>
int launch_l1(int l1, const bf16* src, const bf16* we, const bf16* be,
              const bf16* pxj, const bf16* pxi, const int* senders,
              const int* rowptr, const bf16* w_rest, const bf16* b_rest,
              const bf16* w_out, const bf16* b_out, const float* ln_s,
              const float* g, bf16* d_src, float* dz_out, float* d_pxj,
              float* d_pxi, float* wgrad, float* partial, int n_nodes,
              int n_edges, int scratch_blocks, cudaStream_t stream) {
#define MAGNET_BF16_BWD_CASE(L1V)                                            \
  case L1V:                                                                  \
    return launch<L1V, E>(src, we, be, pxj, pxi, senders, rowptr, w_rest,    \
                          b_rest, w_out, b_out, ln_s, g, d_src, dz_out,      \
                          d_pxj, d_pxi, wgrad, partial, n_nodes, n_edges,    \
                          scratch_blocks, stream)
  switch (l1) {
    MAGNET_BF16_BWD_CASE(0);
    MAGNET_BF16_BWD_CASE(1);
    MAGNET_BF16_BWD_CASE(2);
    MAGNET_BF16_BWD_CASE(3);
  }
#undef MAGNET_BF16_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory of launch<l1, E>'s kernel
template <Entry E>
int smem_bytes(int l1) {
  switch (l1) {
    case 0: return Layout<0, E>::bytes;
    case 1: return Layout<1, E>::bytes;
    case 2: return Layout<2, E>::bytes;
    default: return Layout<3, E>::bytes;
  }
}

}  // namespace bwd

bool built(int ce, int h, int c, int l1) {
  return ce == kCe && h == kH && c == kC && l1 >= 0 && l1 <= kMaxL1;
}

}  // namespace

extern "C" {

// The fold forward.  Returns a cudaError_t; 0 is success.  Launches on
// `stream` and does not synchronise.  e0 (n_edges, ce), pxj and pxi
// (n_nodes, h) are 16-byte aligned bf16; we, be, w_rest, b_rest, w_out,
// b_out bf16; ln_s, ln_b f32; out (n_nodes, c) f32 must arrive zeroed;
// part is f32 scratch of 2 * ceil(n_edges / 64) rows of c.  Built for (ce,
// h, c) = (32, 64, 32) and l1 in 0..3; others return
// cudaErrorInvalidValue.
int fused_edge_tail_agg_bf16_fwd(const bf16* e0, const bf16* we,
                                 const bf16* be, const bf16* pxj,
                                 const bf16* pxi, const int* senders,
                                 const int* rowptr, const bf16* w_rest,
                                 const bf16* b_rest, const bf16* w_out,
                                 const bf16* b_out, const float* ln_s,
                                 const float* ln_b, float* out, float* part,
                                 int n_nodes, int n_edges, int ce, int h,
                                 int c, int l1, void* stream) {
  if (!built(ce, h, c, l1) || part == nullptr)
    return (int)cudaErrorInvalidValue;
  return fwd::launch<kFold>(e0, we, be, pxj, pxi, senders, rowptr, w_rest,
                            b_rest, w_out, b_out, ln_s, ln_b, out, part,
                            n_nodes, n_edges, l1,
                            static_cast<cudaStream_t>(stream));
}

// The fold backward, its operands as the forward's, and g (n_nodes, c)
// f32.  Writes d_e0 (n_edges, ce) bf16; adds into d_pxj and d_pxi
// (n_nodes, h) f32, which must arrive zeroed; wgrad (f32) holds, packed,
// dW_e (ce, h), db_e (h), dW_rest (l1, h, h), db_rest (l1, h), dW_out (h,
// c), db_out (c), d_ln_s (c), d_ln_b (c); partial is f32 scratch for
// scratch_blocks x that many floats.
int fused_edge_tail_agg_bf16_bwd(
    const bf16* e0, const bf16* we, const bf16* be, const bf16* pxj,
    const bf16* pxi, const int* senders, const int* rowptr,
    const bf16* w_rest, const bf16* b_rest, const bf16* w_out,
    const bf16* b_out, const float* ln_s, const float* g, bf16* d_e0,
    float* d_pxj, float* d_pxi, float* wgrad, float* partial, int n_nodes,
    int n_edges, int ce, int h, int c, int l1, int scratch_blocks,
    void* stream) {
  if (!built(ce, h, c, l1)) return (int)cudaErrorInvalidValue;
  return bwd::launch_l1<kFold>(l1, e0, we, be, pxj, pxi, senders, rowptr,
                               w_rest, b_rest, w_out, b_out, ln_s, g, d_e0,
                               nullptr, d_pxj, d_pxi, wgrad, partial, n_nodes,
                               n_edges, scratch_blocks,
                               static_cast<cudaStream_t>(stream));
}

// The pregathered forward: h0 (n_edges, h) and pxi (n_nodes, h) 16-byte
// aligned bf16, the rest as the fold forward's.  Built for (h, c) = (64,
// 32) and l1 in 0..3.
int fused_edge_tail_agg_bf16_pregathered_fwd(
    const bf16* h0, const bf16* pxi, const int* rowptr, const bf16* w_rest,
    const bf16* b_rest, const bf16* w_out, const bf16* b_out,
    const float* ln_s, const float* ln_b, float* out, float* part,
    int n_nodes, int n_edges, int h, int c, int l1, void* stream) {
  if (!built(kCe, h, c, l1) || part == nullptr)
    return (int)cudaErrorInvalidValue;
  return fwd::launch<kPregathered>(h0, nullptr, nullptr, nullptr, pxi, nullptr,
                           rowptr, w_rest, b_rest, w_out, b_out, ln_s, ln_b,
                           out, part, n_nodes, n_edges, l1,
                           static_cast<cudaStream_t>(stream));
}

// The pregathered backward, its operands as its forward's, and g (n_nodes,
// c) f32.  Writes d_h0 (n_edges, h) bf16; adds into d_pxi (n_nodes, h)
// f32, which must arrive zeroed; wgrad (f32) holds, packed, dW_rest (l1,
// h, h), db_rest (l1, h), dW_out (h, c), db_out (c), d_ln_s (c), d_ln_b
// (c); partial is f32 scratch for scratch_blocks x that many floats.
int fused_edge_tail_agg_bf16_pregathered_bwd(
    const bf16* h0, const bf16* pxi, const int* rowptr, const bf16* w_rest,
    const bf16* b_rest, const bf16* w_out, const bf16* b_out,
    const float* ln_s, const float* g, bf16* d_h0, float* d_pxi,
    float* wgrad, float* partial, int n_nodes, int n_edges, int h, int c,
    int l1, int scratch_blocks, void* stream) {
  if (!built(kCe, h, c, l1)) return (int)cudaErrorInvalidValue;
  return bwd::launch_l1<kPregathered>(
      l1, h0, nullptr, nullptr, nullptr, pxi, nullptr, rowptr, w_rest, b_rest,
      w_out, b_out, ln_s, g, d_h0, nullptr, nullptr, d_pxi, wgrad, partial,
      n_nodes, n_edges, scratch_blocks, static_cast<cudaStream_t>(stream));
}

// The pe forward: pe (n_edges, h), pxj and pxi (n_nodes, h) 16-byte aligned
// bf16, senders the sender of each edge, the rest as the fold forward's.
// Built for (h, c) = (64, 32) and l1 in 0..3.
int fused_edge_tail_agg_bf16_pe_fwd(
    const bf16* pe, const bf16* pxj, const bf16* pxi, const int* senders,
    const int* rowptr, const bf16* w_rest, const bf16* b_rest,
    const bf16* w_out, const bf16* b_out, const float* ln_s,
    const float* ln_b, float* out, float* part, int n_nodes, int n_edges,
    int h, int c, int l1, void* stream) {
  if (!built(kCe, h, c, l1) || part == nullptr)
    return (int)cudaErrorInvalidValue;
  return fwd::launch<kPe>(pe, nullptr, nullptr, pxj, pxi, senders, rowptr,
                          w_rest, b_rest, w_out, b_out, ln_s, ln_b, out, part,
                          n_nodes, n_edges, l1,
                          static_cast<cudaStream_t>(stream));
}

// The pe backward, its operands as its forward's, and g (n_nodes, c) f32.
// Writes d_pe (n_edges, h) bf16 and dz (n_edges, h) f32, the unrounded
// first pre-activation's gradient, from which the caller sums d_pxj over
// the sender CSR; adds into d_pxi (n_nodes, h) f32, which must arrive
// zeroed; wgrad (f32) holds, packed, dW_rest (l1, h, h), db_rest (l1, h),
// dW_out (h, c), db_out (c), d_ln_s (c), d_ln_b (c); partial is f32
// scratch for scratch_blocks x that many floats.
int fused_edge_tail_agg_bf16_pe_bwd(
    const bf16* pe, const bf16* pxj, const bf16* pxi, const int* senders,
    const int* rowptr, const bf16* w_rest, const bf16* b_rest,
    const bf16* w_out, const bf16* b_out, const float* ln_s, const float* g,
    bf16* d_pe, float* dz, float* d_pxi, float* wgrad, float* partial,
    int n_nodes, int n_edges, int h, int c, int l1, int scratch_blocks,
    void* stream) {
  if (!built(kCe, h, c, l1)) return (int)cudaErrorInvalidValue;
  return bwd::launch_l1<kPe>(l1, pe, nullptr, nullptr, pxj, pxi, senders,
                             rowptr, w_rest, b_rest, w_out, b_out, ln_s, g,
                             d_pe, dz, nullptr, d_pxi, wgrad, partial,
                             n_nodes, n_edges, scratch_blocks,
                             static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a block takes at l1 tail layers: the fold forward
// (which = 0), the fold backward (1), the pregathered forward (2) and
// backward (3), the pe forward (4) and backward (5); -1 for an l1 not
// built.
int fused_edge_tail_agg_bf16_smem(int which, int l1) {
  if (l1 < 0 || l1 > kMaxL1 || which < 0 || which > 5) return -1;
  if (which % 2 == 0) return (int)fwd::Layout::bytes(l1);
  return which == 1   ? bwd::smem_bytes<kFold>(l1)
         : which == 3 ? bwd::smem_bytes<kPregathered>(l1)
                      : bwd::smem_bytes<kPe>(l1);
}

// Kernels the last backward call launched, its own count: the walk and the
// sum of the blocks' partial rows (the sum alone when there is no edge).
int fused_edge_tail_agg_bf16_bwd_launches(void) {
  return bwd::last_launches.load(std::memory_order_relaxed);
}

}  // extern "C"
