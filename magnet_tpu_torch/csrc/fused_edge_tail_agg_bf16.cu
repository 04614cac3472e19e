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
// Forward (fwd::wgmma_fwd_kernel): Hopper's warpgroup products, one
// template for the three entries (an Entry value):
//   * blocks of 256 threads, two an SM (three for the pre-gathered entry),
//     block b over tiles [b T / B, (b + 1) T / B) of TE = 64 CSR edges of
//     the grid's B = min(T, the blocks the card holds) blocks; its two
//     warpgroups each walk half of them (the first the first half, rounded
//     up) with their own tiles and named barriers (bar.sync 1 + group,
//     128); a group without a tile reaches only the block's barrier after
//     the weights;
//   * every weight lies once in shared memory as stored (in, out), loaded
//     by cp.async before the walk: W_e and W_1 .. W_L1 in the 128-byte
//     swizzle (the MN-major B of h . W), W_out in the 64-byte one;
//   * every product is wgmma.mma_async m64n64k16 / m64n32k16 bf16 x bf16
//     -> f32 (csrc/wgmma.cuh): the fold's first, e0 . W_e, from the staged
//     e0 tile (K-major A) onto accumulators started at b_e + (pxj[s] +
//     pxi[i]); pe and pre-gathered form h_0 = bf16(relu((pe + pxj[s]) +
//     pxi[i])) / bf16(relu(h0 + pxi[i])) elementwise from the staged rows
//     straight into the A fragments of the first tail product; each later
//     product reads A from registers (the accumulators of the one before,
//     bias added first, relu and rounded to bf16 in place), so no barrier
//     comes between the layers;
//   * y + b_out and LayerNorm (two-pass, f32) in the accumulators, each
//     row's statistics over the four threads of its quad; bf16(y) into the
//     warpgroup's tile; the receiver sums are one more product, D = S . Y
//     (wgmma.cuh: S the 0/1 matrix of the tile's runs of equal receivers,
//     from a ballot; Y the bf16(y) tile), as the TPU kernel sums by a
//     one-hot product; each run's row of D goes to out, or for a receiver
//     that crosses a tile to its partial row, added in tile order by
//     cross_tile_sum_kernel: no atomics, out has the same bits run to run;
//   * a tile's e0 / pe / h0 rows and its node rows are staged by cp.async
//     into the tiles the tile before has read, issued while its first tail
//     product runs; the next tile's indices are loaded at the start of a
//     tile and searched there (IndexLoad), the row starts that tell whether
//     its first and last runs cross it before y (csr_tile::edge_ends), each
//     load where written (tile128::ldg_ahead).
//   87,424 / 91,264 / 74,880 bytes of shared memory at L1 = 3 (fold / pe /
//   pregathered); fused_edge_tail_agg_bf16_smem reports each for each L1,
//   fused_edge_tail_agg_bf16_fwd_launches a call's launches (2, or 1 for
//   one tile) and fused_edge_tail_agg_bf16_fwd_blocks its grid.
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
constexpr int kMaxDevices = 64;
constexpr int kMaxL1 = 3;

// two f32 values rounded to bf16 (to nearest, ties to even), lo first
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// ---- warpgroup tiles: shared by the forward and the backward ---------------

constexpr int kGroups = 2;                // warpgroups a block, each its tiles
constexpr int kThreads = 128 * kGroups;   // 8 warps a block
constexpr int kTileH = kTE * kH * 2;      // a bf16 (kTE, kH) tile, 128-byte rows
constexpr int kTileC = kTE * kC * 2;      // a bf16 (kTE, kC) tile, 64-byte rows
constexpr int kTileG = kTE * kC * 4;      // an f32 (kTE, kC) tile, 128-byte rows

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The warpgroup's named barrier (1 + its index; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + grp) : "memory");
}

__device__ __forceinline__ float2 ld_pair(const unsigned char* tile,
                                          uint32_t off) {
  return unpack(*reinterpret_cast<const uint32_t*>(tile + off));
}

// The accumulator's rows of this thread: r0 and r0 + 8 (wgmma.cuh).
__device__ __forceinline__ int acc_row0() {
  return 16 * ((threadIdx.x & 127) >> 5) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int acc_col0() { return 2 * (threadIdx.x & 3); }

// d = v[column] (f32 in shared memory, 8-byte aligned) on every element of
// an accumulator, a pair of columns a load.
template <int R>
__device__ __forceinline__ void init_columns(float (&d)[R], const float* v) {
  const int c0 = acc_col0();
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(v + 8 * j + c0);
    d[4 * j] = d[4 * j + 2] = b.x;
    d[4 * j + 1] = d[4 * j + 3] = b.y;
  }
}

// bf16(relu(d)) of an accumulator into a, the A fragments of the product
// that reads it next (wgmma.cuh: the pair d[i], d[i + 1] is a[i / 8][(i /
// 2) % 4]).
template <int R>
__device__ __forceinline__ void relu_pack(const float (&d)[R],
                                          uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int i = 0; i < R; i += 2)
    a[i >> 3][(i >> 1) & 3] = pack_rn(fmaxf(d[i], 0.f), fmaxf(d[i + 1], 0.f));
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

// ---- forward ---------------------------------------------------------------

namespace fwd {

// Offsets, in bytes, into dynamic shared memory (from its first 1,024-byte
// boundary): one part a warpgroup, then the weights (W_1 .. W_L1 last, so
// that nothing else moves with L1), then the f32 vectors; every tile on a
// 1,024-byte boundary (the swizzles' repeat).
template <Entry E>
struct Layout {
  static constexpr int F = E == kFold ? 1 : 0;         // e0 and W_e
  static constexpr int J = E != kPregathered ? 1 : 0;  // pxj rows staged
  // a warpgroup's part, from its start
  static constexpr int src = 0;             // e0 (kTE, kCe), or h0 / pe
  static constexpr int pxj = src + (F ? kTileC : kTileH);  // pxj[s] rows
  static constexpr int pxi = pxj + J * kTileH;      // pxi[i] rows
  static constexpr int y = pxi + kTileH;            // bf16(y) (kTE, kC)
  static constexpr int idx = y + kTileC;            // 2 x rcv, 2 x snd
  static constexpr int group_bytes = round_up(idx + 4 * kTE * 4, 1024);
  static constexpr int we = kGroups * group_bytes;  // W_e (kCe, kH)
  static constexpr int wo = we + F * kCe * kH * 2;  // W_out (kH, kC)
  static constexpr int wr = wo + kH * kC * 2;       // W_k (kH, kH) ...
  // the f32 vectors b_e, b_out, ln_s, ln_b, b_1 .. b_L1, after the weights
  __host__ __device__ static constexpr int v_be(int l1) {
    return wr + l1 * kH * kH * 2;
  }
  __host__ __device__ static constexpr int v_bo(int l1) {
    return v_be(l1) + F * kH * 4;
  }
  __host__ __device__ static constexpr int v_ls(int l1) {
    return v_bo(l1) + kC * 4;
  }
  __host__ __device__ static constexpr int v_lb(int l1) {
    return v_ls(l1) + kC * 4;
  }
  __host__ __device__ static constexpr int v_br(int l1) {
    return v_lb(l1) + kC * 4;
  }
  // + the base's alignment
  __host__ __device__ static constexpr int bytes(int l1) {
    return v_br(l1) + l1 * kH * 4 + 1024;
  }
};
static_assert(2 * Layout<kPe>::bytes(kMaxL1) <= 232448 &&
                  2 * Layout<kFold>::bytes(kMaxL1) <= 232448,
              "two blocks an SM");

// E: the fold entry (src is e0), the pregathered entry (src is h0; we, be,
// pxj, senders are null) or the pe entry (src is pe; we, be are null).
template <Entry E>
__global__ void __launch_bounds__(kThreads, 2)
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
                 float* __restrict__ part, int n_nodes, int n_edges, int l1) {
  using L = Layout<E>;
  constexpr bool FOLD = E == kFold, GATHERS = E != kPregathered;
  extern __shared__ __align__(16) unsigned char bf16_fwd_smem[];
  unsigned char* sm = bf16_fwd_smem + ((1024 - (wg::smem_addr(bf16_fwd_smem)
                                                & 1023)) & 1023);
  const int tid = threadIdx.x, grp = tid >> 7, t = tid & 127, w = t >> 5;
  unsigned char* s_we = sm + L::we;
  unsigned char* s_wr = sm + L::wr;
  unsigned char* s_wo = sm + L::wo;
  float* v_be = reinterpret_cast<float*>(sm + L::v_be(l1));
  float* v_bo = reinterpret_cast<float*>(sm + L::v_bo(l1));
  float* v_ls = reinterpret_cast<float*>(sm + L::v_ls(l1));
  float* v_lb = reinterpret_cast<float*>(sm + L::v_lb(l1));
  float* v_br = reinterpret_cast<float*>(sm + L::v_br(l1));
  unsigned char* gp = sm + grp * L::group_bytes;
  unsigned char* s_src = gp + L::src;
  unsigned char* s_pxj = gp + L::pxj;
  unsigned char* s_pxi = gp + L::pxi;
  unsigned char* s_y = gp + L::y;
  int* s_rcv = reinterpret_cast<int*>(gp + L::idx);
  int* s_snd = s_rcv + 2 * kTE;

  // the weights by cp.async, each once in its swizzle as stored (in, out);
  // the f32 vectors
  if constexpr (FOLD) {
    copy_weight<128>(s_we, we, kCe);
    for (int i = tid; i < kH; i += kThreads) v_be[i] = __bfloat162float(be[i]);
  }
  copy_weight<128>(s_wr, w_rest, l1 * kH);  // l1 tiles of kH rows
  copy_weight<64>(s_wo, w_out, kH);
  tf32x3::cp_async_commit();
  for (int i = tid; i < l1 * kH; i += kThreads)
    v_br[i] = __bfloat162float(b_rest[i]);
  for (int i = tid; i < kC; i += kThreads) {
    v_bo[i] = __bfloat162float(b_out[i]);
    v_ls[i] = __ldg(ln_s + i);
    v_lb[i] = __ldg(ln_b + i);
  }

  // the block's tiles [b0, b1), balanced over the grid; warpgroup 0 walks
  // the first half (rounded up), warpgroup 1 the rest
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int b0 = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  const int b1 = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
  const int mid = b0 + (b1 - b0 + 1) / 2;
  const int t_beg = grp == 0 ? b0 : mid, t_end = grp == 0 ? mid : b1;

  // a tile's rows (e0 / h0 / pe, and the node rows), staged by cp.async
  auto stage_tile = [&](int tile, const int* rcv, const int* snd) {
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    if constexpr (FOLD)
      stage_rows<64>(s_src, n_valid, src,
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
  tf32x3::cp_async_commit();
  tf32x3::cp_async_wait<1>();
  wg::fence_async_smem();
  __syncthreads();  // the weights and the vectors

  const int r0 = acc_row0(), c0 = acc_col0();
  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    const int* rcv = s_rcv + cur * kTE;
    const bool more = tile + 1 < t_end;
    float acc[32];
    // bf16 A fragments of the chain's products (K = kH), each layer's
    // output rounded in place; alive until the wait that covers the
    // product that reads them (fence_operand)
    uint32_t a[kH / 16][4];

    tf32x3::cp_async_wait<0>();  // this tile's rows
    wg::fence_async_smem();
    group_sync(grp);  // the rows are in; the last tile's sums are done
    // warps 0 and 1: the next tile's indices, loads issued now, the search
    // finished under the first tail product
    const int next_base = (tile + 1) * kTE + 32 * w;
    const int next_valid = min(32, n_edges - next_base);
    IndexLoad next;
    if (more && w < 2)
      next.issue<GATHERS, true>(rowptr, senders, n_nodes, next_base,
                                next_valid, rcv[n_valid - 1]);
    // the next tile's indices stored, then its rows staged into the tiles
    // this one has read: issued while a product runs
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
      tf32x3::cp_async_commit();
    };

    // h_0: fold bf16(relu(e0 . W_e + (b_e + (pxj[s] + pxi[i])))), the
    // accumulators started at z from the staged node rows (zero past
    // n_valid); pe bf16(relu((pe + pxj[s]) + pxi[i])) and pregathered
    // bf16(relu(h0 + pxi[i])) elementwise from the staged rows straight
    // into the A fragments
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
      wg::product<kCe / 16, 0, 1, 64, 128>(acc, s_src, s_we, true);
      wg::commit();
    } else {
#pragma unroll
      for (int j = 0; j < kH / 16; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t off =
              wg::at<128>(r0 + 8 * (q & 1), 16 * j + 8 * (q >> 1) + c0);
          const uint32_t x = *reinterpret_cast<const uint32_t*>(s_src + off);
          const uint32_t i = *reinterpret_cast<const uint32_t*>(s_pxi + off);
          if constexpr (E == kPe)
            a[j][q] = relu_sum3(
                x, *reinterpret_cast<const uint32_t*>(s_pxj + off), i);
          else
            a[j][q] = relu_sum(x, i);
        }
    }
    if constexpr (FOLD) {
      wg::wait<0>();
      wg::fence_operand(acc);
      relu_pack(acc, a);
    }

    // h_k = bf16(relu(h_{k-1} . W_k + b_k)), k = 1 .. L1, each from the
    // registers the layer below left: no barrier between them but the one
    // of advance() under the first
    for (int k = 1; k <= l1; ++k) {
      init_columns(acc, v_br + (k - 1) * kH);
      wg::fence_operand(acc);
      wg::fence();
      wg::product_rs<kH / 16, 1, 128>(acc, a, s_wr + (k - 1) * kH * kH * 2,
                                      true);
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
    // (the row starts that decide it loaded now, used after LayerNorm)
    const int2 ends = csr_tile::edge_ends(rowptr, rcv, n_valid);
    float y[16];
    init_columns(y, v_bo);
    wg::fence_operand(y);
    wg::fence();
    wg::product_rs<kH / 16, 1, 64>(y, a, s_wo, true);
    wg::commit();
    // the tile's runs of equal receivers while y's product runs
    const uint64_t starts = wg::run_starts(rcv, n_valid);
    wg::wait<0>();
    wg::fence_operand(y);
    wg::fence_operand(a);
    if (l1 == 0) advance();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v[8];
      float mu = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = y[4 * j + 2 * hh];
        v[2 * j + 1] = y[4 * j + 2 * hh + 1];
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) mu += v[q];
      mu += __shfl_xor_sync(0xffffffffu, mu, 1);
      mu += __shfl_xor_sync(0xffffffffu, mu, 2);
      mu *= 1.f / kC;
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float d = v[q] - mu;
        var = fmaf(d, d, var);
      }
      var += __shfl_xor_sync(0xffffffffu, var, 1);
      var += __shfl_xor_sync(0xffffffffu, var, 2);
      var *= 1.f / kC;
      const float rstd = rsqrtf(var + kLnEps);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * j + c0;
        *reinterpret_cast<uint32_t*>(s_y + wg::at<64>(r0 + 8 * hh, c)) =
            pack_rn((v[2 * j] - mu) * rstd * v_ls[c] + v_lb[c],
                    (v[2 * j + 1] - mu) * rstd * v_ls[c + 1] + v_lb[c + 1]);
      }
    }
    uint32_t s_a[kTE / 16][4];
    wg::run_matrix(s_a, starts, n_valid);
    wg::fence_async_smem();
    group_sync(grp);  // bf16(y) written
    wg::fence();
    wg::product_rs<kTE / 16, 1, 64>(y, s_a, s_y, false);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(y);
    wg::fence_operand(s_a);
    wg::store_runs<kC, kTE>(y, starts, rcv, ends.x, ends.y, n_edges, tile,
                            n_valid, out, part);
  }
}

// kernels the last call launched (its own count, for the checks)
std::atomic<int> last_launches{0};

// The grid's blocks a call of n_edges takes on this device, min(tiles, the
// blocks the card holds at once), or a negative cudaError_t; the
// shared-memory opt-in with the first call.
template <Entry E>
int grid_blocks(int n_edges) {
  static std::atomic<int> cache[kMaxDevices];
  int cap = 0;
  // one opt-in and one cap for every l1
  const cudaError_t err = grid_cap(wgmma_fwd_kernel<E>, kThreads,
                                   (size_t)Layout<E>::bytes(kMaxL1), cache,
                                   &cap);
  if (err != cudaSuccess) return -(int)err;
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  return n_tiles < cap ? n_tiles : cap;
}

// The kernel, block b over tiles [b T / B, (b + 1) T / B), then the sum of
// the partial rows of the receivers that cross a tile: two launches (one
// for a single tile).
template <Entry E>
int launch(const bf16* src, const bf16* we, const bf16* be, const bf16* pxj,
           const bf16* pxi, const int* senders, const int* rowptr,
           const bf16* w_rest, const bf16* b_rest, const bf16* w_out,
           const bf16* b_out, const float* ln_s, const float* ln_b, float* out,
           float* part, int n_nodes, int n_edges, int l1,
           cudaStream_t stream) {
  int launches = 0;
  const int blocks = grid_blocks<E>(n_edges > 0 ? n_edges : 0);
  if (blocks < 0) return -blocks;
  if (n_nodes > 0 && n_edges > 0) {
    const int n_tiles = (n_edges + kTE - 1) / kTE;
    wgmma_fwd_kernel<E><<<blocks, kThreads, Layout<E>::bytes(l1), stream>>>(
        src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
        ln_s, ln_b, out, part, n_nodes, n_edges, l1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++launches;
    if (n_tiles > 1) {
      csr_tile::cross_tile_sum_kernel<kTE, kC><<<n_tiles - 1, kC, 0, stream>>>(
          rowptr, part, out, n_nodes, n_edges);
      ++launches;
    }
  }
  last_launches.store(launches, std::memory_order_relaxed);
  return (int)cudaGetLastError();
}

}  // namespace fwd

// ---- backward --------------------------------------------------------------

namespace bwd {

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
  if (which % 2 == 0)
    return which == 0   ? fwd::Layout<kFold>::bytes(l1)
           : which == 2 ? fwd::Layout<kPregathered>::bytes(l1)
                        : fwd::Layout<kPe>::bytes(l1);
  return which == 1   ? bwd::smem_bytes<kFold>(l1)
         : which == 3 ? bwd::smem_bytes<kPregathered>(l1)
                      : bwd::smem_bytes<kPe>(l1);
}

// Kernels the last backward call launched, its own count: the walk and the
// sum of the blocks' partial rows (the sum alone when there is no edge).
int fused_edge_tail_agg_bf16_bwd_launches(void) {
  return bwd::last_launches.load(std::memory_order_relaxed);
}

// Kernels the last forward call launched, its own count: the walk and the
// sum of the partial rows (the walk alone for one tile; none without an
// edge).
int fused_edge_tail_agg_bf16_fwd_launches(void) {
  return fwd::last_launches.load(std::memory_order_relaxed);
}

// The blocks a forward call of `entry` (a tile128::Entry) over n_edges
// launches on this device: min(tiles, SMs x the blocks an SM holds), or a
// negative cudaError_t.
int fused_edge_tail_agg_bf16_fwd_blocks(int entry, int n_edges) {
  switch (entry) {
    case kFold: return fwd::grid_blocks<kFold>(n_edges);
    case kPe: return fwd::grid_blocks<kPe>(n_edges);
    case kPregathered: return fwd::grid_blocks<kPregathered>(n_edges);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
