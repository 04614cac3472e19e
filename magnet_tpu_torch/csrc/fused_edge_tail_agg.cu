// Fused InteractionNetwork edge pipeline, forward, f32, three entries.
//
// fold (Entry kFold) replaces the TPU kernel
// magnet_tpu/ops/pallas_kernels.py:_fused2r_fwd_pallas as called with
// we/be (fold-e, public entry fused_edge_tail_agg2rf; the oracle is
// _fused2re_ref_impl + _fused2_ref_impl + _tail_ref); pregathered
// (kPregathered) replaces _fused_fwd_pallas (public entry
// fused_edge_tail_agg; the oracle is _fused_ref_impl), whose first-layer
// input h0 = pxj[j] + W_e . e + b_e the caller has formed per edge; pe
// (kPe) replaces _fused2_fwd_pallas (public entry fused_edge_tail_agg2;
// the oracle is _fused2_ref_impl), which gathers the sender row itself and
// adds the caller's pe = s (e . W_e) + b_e.  The pe entry also computes
// what the JAX package's no-fold ragged lanes compute
// (fused_edge_tail_agg2r / 2h).  Math:
//
//   for every edge j -> i of a receiver-grouped CSR graph
//     z   = e0[e] . W_e + b_e + pxj[j] + pxi[i]     (fold)
//     z   = h0[e] + pxi[i]                          (pregathered)
//     z   = pe[e] + pxj[j] + pxi[i]                 (pe)
//     h   = relu(z);  h = relu(h . W_k + b_k)   for k < L1
//     y   = h . W_out + b_out
//     y   = LayerNorm(y)      (two-pass f32 variance, eps 1e-5, affine)
//   out[i] = sum of y over the edges of i          (N, C) f32
//
// The mean over the degree is taken by the caller.  A receiver of degree 0
// gets a zero row; every edge range is clamped to the E rows given.
//
// Compiled builds, keyed by what each entry reads: fold (Ce, H, C) =
// (32, 64, 32) (MAgNet[CNN]) and (128, 128, 128) (MAgNet[GNN]);
// pregathered (H, C) = (64, 32) and (128, 128); pe (H, C) = (128, 128).
//
// Design of the fold entry at width 64.  Hopper gathers natively, so none
// of the TPU's one-hot gather matmuls, sender-tile windows or live-chunk
// lists carry over:
//   * all weights sit in dynamic shared memory, loaded once per block; the
//     grid is persistent (a few blocks per SM) so the load is paid ~400
//     times per launch, not once per receiver;
//   * one warp owns one receiver at a time; lane k runs edge rowptr[i] + k
//     (a loop of 32-edge rounds covers any degree);
//   * a lane keeps its edge's activations in registers (H floats in, H
//     out) and reads each weight row as float4 broadcasts from shared
//     memory, so the (E, H) activations never reach device memory;
//   * the receiver sum is a warp butterfly over the lanes, with no
//     atomics, since CSR keeps a receiver's edges together.
// What bounds it on an H100: at the slice's shapes (E ~ 186.6k edges,
// Ce = 32, H = 64, L1 = 3, C = 32) one launch does E * 16,384
// multiply-adds ~ 6.1 GFLOP on the f32 CUDA cores, against ~25 MB of
// input (mostly e0), so it is bound by operations, not bytes.  Each
// float4 weight load feeds four FMAs of a lane, so the shared-memory pipe
// and the FMA pipe are both near their limit.
//
// Design of the pregathered entry at width 64 (namespace w64).  The fold
// design above idled ~72% of its lanes here: MAgNet[CNN] 2D's training
// graph (a 32 x 32 grid and 32 queries a sample) has a mean in-degree of
// 8.9, and a lane held ~200 live floats.  The pregathered entry skips the
// (Ce x H) product (14,336 multiply-adds per edge remain) and reads an
// (E, H) h0: at E = 299,894 that is 8.6 GFLOP against ~90 MB.  Issued as
// three TF32 products per f32 product on the tensor cores (tf32x3,
// csrc/tile_mm.cuh) it is bound by operations, 0.052 ms at 495 TFLOP/s,
// against 0.027 ms of bytes.  So:
//   * a persistent block of 256 threads (8 warps) walks consecutive tiles of
//     TE = 64 CSR edges, whatever the degrees; warps 0 and 1 find the next
//     tile's receivers from the last receiver of this one;
//   * every weight (three 64 x 64, one 64 x 32: 56 KB, transposed and
//     XOR-swizzled) stays in shared memory for the whole launch; the tile's
//     h0 and pxi rows arrive by cp.async into staging buffers that are free
//     again once the first layer's input is formed, so the next tile's rows
//     load while this one's layers run;
//   * each layer is a tf32x3 product of the 64-row tile (mm_rows64: a warp
//     owns 32 rows and 16 or 8 columns; fragments by ldmatrix, split by
//     split_fast), written back over the tile's activations; LayerNorm
//     takes four threads an edge;
//   * 108,160 bytes of shared memory at L1 = 3 and at most 128 registers a
//     thread: two blocks share an SM;
//   * the receiver sums as at width 128, below (csr_tile): deterministic,
//     partial rows for receivers that cross a tile, no atomics.
// What still holds it (measured, H100): as the MPNN forward's (csrc/
// fused_mpnn_edge_agg.cu), the instructions around each mma and the
// latency that 16 warps an SM leave exposed, with four barriers a layer.
// The first layer's input is one step of its own (first_input), so that
// the fold entry's e0 . W_e + b_e + pxj[s] + pxi[i] can later take its
// place as one more product.
//
// Design at width 128 (all three entries).  The width-64 fold design does
// not scale: the f32 tail weights alone are 258-322 KB (the block's limit
// is 227 KB) and a lane would hold 256 live activations.  So the products
// are tiled:
//   * a block of 256 threads (16 x 16) owns a tile of 64 consecutive CSR
//     edges; each edge finds its receiver by a binary search in rowptr;
//   * the tile's activations live in one (64 x 129)-float shared buffer
//     (row and column reads free of bank conflicts); each layer's weight
//     (128 x 128) is streamed through one 66 KB shared buffer, and every
//     thread computes a 4 x 8 register tile of the product, which goes
//     back into the activation buffer after a barrier; ~99 KB a block,
//     two blocks per SM;
//   * the receiver sum runs over each run of equal receivers in CSR order
//     (csr_tile, csrc/tile_mm.cuh): a receiver wholly inside the tile is
//     written directly; a receiver that crosses a tile boundary leaves one
//     partial row per tile, and a second small kernel adds those in tile
//     order.  No atomics: the result is the same from run to run.
// Bound at MAgNet[GNN]'s eval batch (84.3k LR u HR edges, L1 = 3): fold
// 81,920 multiply-adds per edge = 13.8 GFLOP, 0.206 ms at the 67 TFLOP/s
// f32 rate; pe 65,536 per edge, 0.165 ms against 43 MB of pe (0.013 ms):
// both bound by operations.  Each step of a product makes 12 shared-memory
// loads for 32 FMAs, so the shared-memory pipe is the limit of this first
// version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (magnet_tpu_torch/ops/cuda_build.py does this).

#include <cuda_runtime.h>

#include <atomic>

#include "tile_mm.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ void copy_to_smem(float* dst, const float* src,
                                             int n) {
  for (int k = threadIdx.x; k < n; k += kThreads) dst[k] = src[k];
}

// acc[0:M] += a * w[0:M] for one weight row w in shared memory.
template <int M>
__device__ __forceinline__ void axpy_row(float (&acc)[M], float a,
                                         const float* __restrict__ w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < M / 4; ++q) {
    const float4 v = w4[q];
    acc[4 * q + 0] = fmaf(a, v.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(a, v.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(a, v.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(a, v.w, acc[4 * q + 3]);
  }
}

// Offsets, in floats, of the fold entry's weights in dynamic shared
// memory.
template <int CE, int H, int C>
struct Smem {
  static constexpr int we = 0;                     // (CE, H)
  static constexpr int wo = we + CE * H;           // (H, C)
  static constexpr int be = wo + H * C;            // (H,)
  static constexpr int bo = be + H;                // (C,)
  static constexpr int ls = bo + C;                // (C,)
  static constexpr int lb = ls + C;                // (C,)
  static constexpr int wr = lb + C;                // (L1, H, H), then (L1, H)
  static size_t bytes(int l1) {
    return sizeof(float) * (size_t)(wr + l1 * (H * H + H));
  }
};

template <int CE, int H, int C>
__global__ void __launch_bounds__(kThreads)
fused_edge_tail_agg_kernel(const float* __restrict__ src,
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
                           const float* __restrict__ ln_b,
                           float* __restrict__ out, int n_nodes, int n_edges,
                           int l1) {
  static_assert(CE % 4 == 0 && H % 4 == 0 && C % 4 == 0,
                "widths must be multiples of 4 (float4 rows)");
  using S = Smem<CE, H, C>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_we = smem + S::we;
  float* s_wo = smem + S::wo;
  float* s_be = smem + S::be;
  float* s_bo = smem + S::bo;
  float* s_ls = smem + S::ls;
  float* s_lb = smem + S::lb;
  float* s_wr = smem + S::wr;
  float* s_br = s_wr + l1 * H * H;
  copy_to_smem(s_we, we, CE * H);
  copy_to_smem(s_be, be, H);
  copy_to_smem(s_wo, w_out, H * C);
  copy_to_smem(s_bo, b_out, C);
  copy_to_smem(s_ls, ln_s, C);
  copy_to_smem(s_lb, ln_b, C);
  copy_to_smem(s_wr, w_rest, l1 * H * H);
  copy_to_smem(s_br, b_rest, l1 * H);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  for (int i = blockIdx.x * kWarps + (threadIdx.x >> 5); i < n_nodes;
       i += n_warps) {
    // rowptr is trusted to be a CSR; the clamp keeps every read inside the
    // E rows that src (and senders) have, whatever rowptr says
    const int beg = rowptr[i];
    const int end = min(rowptr[i + 1], n_edges);
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;

    for (int base = beg; base < end; base += 32) {
      const int e = base + lane;
      float y[C];
      if (e < end) {
        float h[H];
        const float4* pi = reinterpret_cast<const float4*>(pxi + (size_t)i * H);
        // z = b_e + pxj[sender] + pxi[receiver] + e0[e] . W_e
        const float4* pj =
            reinterpret_cast<const float4*>(pxj + (size_t)senders[e] * H);
        const float4* b4 = reinterpret_cast<const float4*>(s_be);
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const float4 a = __ldg(pj + q), b = __ldg(pi + q), c = b4[q];
          h[4 * q + 0] = a.x + b.x + c.x;
          h[4 * q + 1] = a.y + b.y + c.y;
          h[4 * q + 2] = a.z + b.z + c.z;
          h[4 * q + 3] = a.w + b.w + c.w;
        }
        const float4* pe =
            reinterpret_cast<const float4*>(src + (size_t)e * CE);
#pragma unroll
        for (int k4 = 0; k4 < CE / 4; ++k4) {
          const float4 v = __ldg(pe + k4);
          axpy_row<H>(h, v.x, s_we + (4 * k4 + 0) * H);
          axpy_row<H>(h, v.y, s_we + (4 * k4 + 1) * H);
          axpy_row<H>(h, v.z, s_we + (4 * k4 + 2) * H);
          axpy_row<H>(h, v.w, s_we + (4 * k4 + 3) * H);
        }
#pragma unroll
        for (int k = 0; k < H; ++k) h[k] = fmaxf(h[k], 0.f);

        // hidden tail layers
        for (int layer = 0; layer < l1; ++layer) {
          const float* w = s_wr + layer * H * H;
          const float* b = s_br + layer * H;
          float a[H];
#pragma unroll
          for (int k = 0; k < H; ++k) a[k] = b[k];
#pragma unroll
          for (int k = 0; k < H; ++k) axpy_row<H>(a, h[k], w + k * H);
#pragma unroll
          for (int k = 0; k < H; ++k) h[k] = fmaxf(a[k], 0.f);
        }

        // output layer + LayerNorm (two-pass variance)
#pragma unroll
        for (int c = 0; c < C; ++c) y[c] = s_bo[c];
#pragma unroll
        for (int k = 0; k < H; ++k) axpy_row<C>(y, h[k], s_wo + k * C);
        float mu = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) mu += y[c];
        mu *= 1.f / C;
        float var = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float d = y[c] - mu;
          var = fmaf(d, d, var);
        }
        var *= 1.f / C;
        const float rstd = rsqrtf(var + kLnEps);
#pragma unroll
        for (int c = 0; c < C; ++c)
          y[c] = (y[c] - mu) * rstd * s_ls[c] + s_lb[c];
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) y[c] = 0.f;
      }
      // receiver sum over the 32 lanes of this round
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v = y[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[c] += v;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if ((c & 31) == lane) out[(size_t)i * C + c] = acc[c];
  }
}

constexpr int kMaxDevices = 64;
constexpr int kMaxCachedL1 = 16;

using GridCache = std::atomic<int>[kMaxDevices][kMaxCachedL1 + 1];

// The persistent grid's size (SMs x resident blocks per SM) of `kernel`
// (blocks of `threads`) for `l1` tail layers on the current device.  The
// device queries, the occupancy query and the shared-memory opt-in run
// once per (device, l1) and kernel, whose `cache` (zeros: unset) keeps the
// result; later launches only read it.  The opt-in is always the device's
// maximum, so a later call for a smaller l1 never lowers it below what a
// larger one needs.
template <class Kernel>
cudaError_t grid_cap(Kernel kernel, int threads, GridCache& cache, int l1,
                     size_t smem, int* cap) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices && l1 <= kMaxCachedL1;
  if (cached && (*cap = cache[device][l1].load(std::memory_order_relaxed)) > 0)
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
  if (cached) cache[device][l1].store(*cap, std::memory_order_relaxed);
  return cudaSuccess;
}

template <int CE, int H, int C>
int launch(const float* src, const float* we, const float* be,
           const float* pxj, const float* pxi, const int* senders,
           const int* rowptr, const float* w_rest, const float* b_rest,
           const float* w_out, const float* b_out, const float* ln_s,
           const float* ln_b, float* out, int n_nodes, int n_edges, int l1,
           cudaStream_t stream) {
  static GridCache cache;
  const size_t smem = Smem<CE, H, C>::bytes(l1);
  int cap = 0;
  const cudaError_t err = grid_cap(fused_edge_tail_agg_kernel<CE, H, C>,
                                   kThreads, cache, l1, smem, &cap);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes == 0) return (int)cudaSuccess;
  int blocks = (n_nodes + kWarps - 1) / kWarps;
  if (blocks > cap) blocks = cap;
  fused_edge_tail_agg_kernel<CE, H, C>
      <<<blocks, kThreads, smem, stream>>>(src, we, be, pxj, pxi, senders,
                                           rowptr, w_rest, b_rest, w_out,
                                           b_out, ln_s, ln_b, out, n_nodes,
                                           n_edges, l1);
  return (int)cudaGetLastError();
}

namespace w128 {

using tile128::Entry;
using tile128::kCols;
using tile128::kFold;
using tile128::kLd;
using tile128::kPe;
using tile128::kPregathered;
using tile128::kThreads;
using tile128::kW;
constexpr int kTE = 64;                        // edges per tile
constexpr int kRows = kTE / 16;                // register tile rows
constexpr int kAct = 0;                        // (kTE, kLd) activations
constexpr int kWt = kAct + kTE * kLd;          // (kW, kLd) one weight
constexpr int kSnd = kWt + kW * kLd;           // (kTE) int
constexpr int kRcv = kSnd + kTE;               // (kTE) int
constexpr int kSmemFloats = kRcv + kTE;

// One dense layer over the tile, in place: act <- f(act . W + bias) with
// W (kW, kW) from device memory; relu when RELU.  Every thread enters with
// the tile's activations written, and leaves with the new ones written.
template <bool RELU>
__device__ __forceinline__ void layer(float* s_act, float* s_w,
                                      const float* __restrict__ w,
                                      const float* __restrict__ bias, int tx,
                                      int ty) {
  tile128::load_weight(s_w, w);
  __syncthreads();
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = __ldg(bias + tx + 16 * j);
  tile128::mm_aw(s_act, s_w, acc, tx, ty);
  __syncthreads();  // every read of s_act and s_w is done
  tile128::store<RELU>(s_act, acc, tx, ty);
}

template <Entry E>
__global__ void __launch_bounds__(kThreads, 2)
edge_tail_kernel(const float* __restrict__ src, const float* __restrict__ we,
                 const float* __restrict__ be, const float* __restrict__ pxj,
                 const float* __restrict__ pxi,
                 const int* __restrict__ senders,
                 const int* __restrict__ rowptr,
                 const float* __restrict__ w_rest,
                 const float* __restrict__ b_rest,
                 const float* __restrict__ w_out,
                 const float* __restrict__ b_out,
                 const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, float* __restrict__ out,
                 float* __restrict__ part, int n_nodes, int n_edges, int l1) {
  static_assert(kTE * 4 == kThreads, "LayerNorm: four threads per edge");
  extern __shared__ float smem[];
  float* s_act = smem + kAct;
  float* s_w = smem + kWt;
  int* s_snd = reinterpret_cast<int*>(smem + kSnd);
  int* s_rcv = reinterpret_cast<int*>(smem + kRcv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int base = blockIdx.x * kTE;
  const int n_valid = min(kTE, n_edges - base);

  tile128::load_indices<kTE, E>(s_snd, s_rcv, senders, rowptr, n_nodes,
                                base, n_valid);
  // the first layer's input; rows past the end are zero
  if (E == kFold) {
    // z = e0 . W_e + b_e + pxj[sender] + pxi[receiver]
    tile128::load_rows<kTE>(s_act, src, base, n_valid);
    tile128::load_weight(s_w, we);
    __syncthreads();
    float acc[kRows][kCols];
    tile128::fold_init(acc, be, pxj, pxi, s_snd, s_rcv, n_valid, tx, ty);
    tile128::mm_aw(s_act, s_w, acc, tx, ty);
    __syncthreads();
    tile128::store<true>(s_act, acc, tx, ty);
  } else {
    __syncthreads();  // s_snd, s_rcv
    tile128::first_input<kTE, E>(s_act, src, pxj, pxi, s_snd, s_rcv, base,
                                 n_valid);
  }
  for (int k = 0; k < l1; ++k)
    layer<true>(s_act, s_w, w_rest + (size_t)k * kW * kW, b_rest + k * kW, tx,
                ty);
  layer<false>(s_act, s_w, w_out, b_out, tx, ty);
  __syncthreads();

  // LayerNorm (two-pass variance), four threads per edge, in place
  {
    constexpr int CP = kW / 4;
    const int e = tid >> 2, c0 = (tid & 3) * CP;
    float* yr = s_act + e * kLd + c0;
    float v[CP];
    float mu = 0.f;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      v[c] = yr[c];
      mu += v[c];
    }
    mu += __shfl_xor_sync(0xffffffffu, mu, 1);
    mu += __shfl_xor_sync(0xffffffffu, mu, 2);
    mu *= 1.f / kW;
    float var = 0.f;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      const float d = v[c] - mu;
      var = fmaf(d, d, var);
    }
    var += __shfl_xor_sync(0xffffffffu, var, 1);
    var += __shfl_xor_sync(0xffffffffu, var, 2);
    var *= 1.f / kW;
    const float rstd = rsqrtf(var + kLnEps);
#pragma unroll
    for (int c = 0; c < CP; ++c)
      yr[c] = (v[c] - mu) * rstd * __ldg(ln_s + c0 + c) + __ldg(ln_b + c0 + c);
  }
  __syncthreads();

  // the receiver sums over each run of equal receivers; partial rows for
  // the receivers that cross a tile boundary
  csr_tile::receiver_sums<kTE, kW>(
      [&](int e, int c) -> float& { return s_act[e * kLd + c]; }, s_rcv,
      rowptr, n_edges, blockIdx.x, n_valid, out, part);
}

template <Entry E>
int launch(const float* src, const float* we, const float* be,
           const float* pxj, const float* pxi, const int* senders,
           const int* rowptr, const float* w_rest, const float* b_rest,
           const float* w_out, const float* b_out, const float* ln_s,
           const float* ln_b, float* out, float* part, int n_nodes,
           int n_edges, int l1, cudaStream_t stream) {
  // the shared-memory opt-in, once per device
  static std::atomic<int> opted[kMaxDevices];
  constexpr size_t smem = sizeof(float) * kSmemFloats;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices ||
      !opted[device].load(std::memory_order_relaxed)) {
    if ((err = cudaFuncSetAttribute(
             edge_tail_kernel<E>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return (int)err;
    if (device < kMaxDevices) opted[device].store(1, std::memory_order_relaxed);
  }
  if (n_nodes == 0 || n_edges <= 0) return (int)cudaSuccess;
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  edge_tail_kernel<E><<<n_tiles, kThreads, smem, stream>>>(
      src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
      ln_s, ln_b, out, part, n_nodes, n_edges, l1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n_tiles > 1)
    csr_tile::cross_tile_sum_kernel<kTE, kW>
        <<<n_tiles - 1, kW, 0, stream>>>(rowptr, part, out, n_nodes,
                                         n_edges);
  return (int)cudaGetLastError();
}

}  // namespace w128

namespace w64 {

using tile128::Entry;
using tile128::kPregathered;
constexpr int kH = 64;          // hidden width
constexpr int kC = 32;          // output width
constexpr int kTE = 64;         // edges per tile
constexpr int kThreads = 256;   // 8 warps

// Offsets, in floats, into dynamic shared memory: the tiles, then the
// weights, all XOR-swizzled (tf32x3::swz_at); 108,160 bytes at L1 = 3.
struct Layout {
  static constexpr int tile = kTE * kH;      // a (kTE, kH) tile
  static constexpr int src = 0;              // the tile's h0 rows
  static constexpr int pxi = src + tile;     // the tile's pxi rows
  static constexpr int act = pxi + tile;     // activations, then y (kTE, kC)
  static constexpr int rcv = act + tile;     // 2 x (kTE) int, two tiles
  static constexpr int wo = rcv + 2 * kTE;   // (kC, kH): W_out transposed
  static constexpr int bo = wo + kH * kC;    // (kC)
  static constexpr int ls = bo + kC;         // (kC)
  static constexpr int lb = ls + kC;         // (kC)
  static constexpr int wr = lb + kC;         // L1 x (kH, kH) transposed,
                                             // then (L1, kH)
  static size_t bytes(int l1) {
    return sizeof(float) * (size_t)(wr + l1 * (kH * kH + kH));
  }
};

// dst <- the transposes of n_mat (kH x N) weights w, each an (N x kH)
// XOR-swizzled tile (row n holds column n of its weight), so that
// ldmatrix reads their fragments as it reads the activations'.
template <int N>
__device__ __forceinline__ void load_transposed(float* dst,
                                                const float* __restrict__ w,
                                                int n_mat) {
  for (int k = threadIdx.x; k < n_mat * kH * N; k += kThreads) {
    const int m = k / (kH * N), kk = (k / N) % kH, n = k % N;
    dst[m * kH * N + tf32x3::swz_at<kH>(n, kk)] = __ldg(w + k);
  }
}

// The first layer's input over the tile, act = relu(h0[e] + pxi[i]), from
// the staging rows (zero past n_valid, and so zero in act).
template <Entry E>
__device__ __forceinline__ void first_input(float* s_act, const float* s_src,
                                            const float* s_pxi) {
  static_assert(E == kPregathered, "the width-64 tiled body: pregathered");
  for (int k = threadIdx.x; k < kTE * kH / 4; k += kThreads) {
    const int o = tf32x3::swz_at<kH>(k >> 4, (k & 15) * 4);
    const float4 a = *reinterpret_cast<const float4*>(s_src + o);
    const float4 b = *reinterpret_cast<const float4*>(s_pxi + o);
    *reinterpret_cast<float4*>(s_act + o) =
        make_float4(fmaxf(a.x + b.x, 0.f), fmaxf(a.y + b.y, 0.f),
                    fmaxf(a.z + b.z, 0.f), fmaxf(a.w + b.w, 0.f));
  }
}

// One dense layer over the tile: act (kTE, K) <- f(act . W + bias) as a
// (kTE, N) tile, relu when RELU; W (K, N) in shared memory, transposed.
// Every thread enters with the tile's activations written, and leaves with
// the new ones written.
template <int N, int K, bool RELU>
__device__ __forceinline__ void layer(float* s_act, const float* s_w,
                                      const float* s_bias) {
  using namespace tf32x3;
  constexpr int NI = N / 32;
  const int w = threadIdx.x >> 5, m0 = 32 * (w & 1), n0 = (N / 4) * (w >> 1);
  float acc[2][NI][4];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float bias = s_bias[acc_col(n0 + 8 * ni, c)];
      acc[0][ni][c] = bias;
      acc[1][ni][c] = bias;
    }
  mm_rows64<N, K>(acc, LdsmRows<K>{s_act}, LdsmCols<K>{s_w});
  __syncthreads();  // every warp has read the tile
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = acc[mi][ni][c];
        s_act[swz_at<N>(acc_row(m0 + 16 * mi, c), acc_col(n0 + 8 * ni, c))] =
            RELU ? fmaxf(v, 0.f) : v;
      }
  __syncthreads();
}

template <Entry E>
__global__ void __launch_bounds__(kThreads, 2)
edge_tail_kernel(const float* __restrict__ src, const float* __restrict__ pxi,
                 const int* __restrict__ rowptr,
                 const float* __restrict__ w_rest,
                 const float* __restrict__ b_rest,
                 const float* __restrict__ w_out,
                 const float* __restrict__ b_out,
                 const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, float* __restrict__ out,
                 float* __restrict__ part, int n_nodes, int n_edges, int l1) {
  static_assert(kTE * 4 == kThreads, "LayerNorm: four threads per edge");
  using L = Layout;
  using namespace tf32x3;
  extern __shared__ __align__(16) float w64_smem[];
  float* s_src = w64_smem + L::src;
  float* s_pxi = w64_smem + L::pxi;
  float* s_act = w64_smem + L::act;
  int* s_rcv = reinterpret_cast<int*>(w64_smem + L::rcv);
  float* s_wo = w64_smem + L::wo;
  float* s_bo = w64_smem + L::bo;
  float* s_ls = w64_smem + L::ls;
  float* s_lb = w64_smem + L::lb;
  float* s_wr = w64_smem + L::wr;
  float* s_br = s_wr + l1 * kH * kH;
  const int tid = threadIdx.x, warp = tid >> 5;
  load_transposed<kH>(s_wr, w_rest, l1);
  load_transposed<kC>(s_wo, w_out, 1);
  for (int k = tid; k < l1 * kH; k += kThreads) s_br[k] = __ldg(b_rest + k);
  if (tid < kC) {
    s_bo[tid] = __ldg(b_out + tid);
    s_ls[tid] = __ldg(ln_s + tid);
    s_lb[tid] = __ldg(ln_b + tid);
  }

  // the block's tiles are consecutive, so each tile's receivers are found
  // from the last receiver of the one before (warps 0 and 1, 32 edges each)
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int per_block = (n_tiles + gridDim.x - 1) / gridDim.x;
  const int t_beg = blockIdx.x * per_block;
  const int t_end = min(n_tiles, t_beg + per_block);
  auto indices = [&](int tile, int buf, int hint) {
    const int base = tile * kTE + 32 * warp;
    const int n_valid = min(32, n_edges - base);
    const int rv =
        tile128::warp_receiver(rowptr, n_nodes, base, n_valid, hint);
    const int lane = tid & 31;
    s_rcv[buf * kTE + 32 * warp + lane] = lane < n_valid ? rv : 0;
  };
  // the h0 and pxi rows of tile `tile`, whose receivers are in buffer
  // `buf`: one committed group
  auto gather = [&](int tile, int buf) {
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    const int* rcv = s_rcv + buf * kTE;
    rows_async<kTE, kH>(s_src, 0, src, [&](int e) {
      return e < n_valid ? src + (size_t)(base + e) * kH : nullptr;
    });
    rows_async<kTE, kH>(s_pxi, 0, pxi, [&](int e) {
      return e < n_valid ? pxi + (size_t)rcv[e] * kH : nullptr;
    });
    cp_async_commit();
  };

  if (t_beg < t_end) {
    if (warp < 2) indices(t_beg, 0, -1);
    __syncthreads();
    gather(t_beg, 0);
  }
  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const int n_valid = min(kTE, n_edges - tile * kTE);
    const int* rcv = s_rcv + cur * kTE;
    const bool more = tile + 1 < t_end;
    cp_async_wait<0>();
    __syncthreads();  // the rows are in; the last tile's sums are done

    first_input<E>(s_act, s_src, s_pxi);
    if (more && warp < 2) indices(tile + 1, nxt, rcv[n_valid - 1]);
    __syncthreads();  // act written, the staging buffers free
    if (more) gather(tile + 1, nxt);

    for (int k = 0; k < l1; ++k)
      layer<kH, kH, true>(s_act, s_wr + k * kH * kH, s_br + k * kH);
    layer<kC, kH, false>(s_act, s_wo, s_bo);

    // LayerNorm (two-pass variance), four threads per edge, in place
    {
      constexpr int CP = kC / 4;
      const int e = tid >> 2, c0 = (tid & 3) * CP;
      float v[CP];
      float mu = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        v[c] = s_act[swz_at<kC>(e, c0 + c)];
        mu += v[c];
      }
      mu += __shfl_xor_sync(0xffffffffu, mu, 1);
      mu += __shfl_xor_sync(0xffffffffu, mu, 2);
      mu *= 1.f / kC;
      float var = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const float d = v[c] - mu;
        var = fmaf(d, d, var);
      }
      var += __shfl_xor_sync(0xffffffffu, var, 1);
      var += __shfl_xor_sync(0xffffffffu, var, 2);
      var *= 1.f / kC;
      const float rstd = rsqrtf(var + kLnEps);
#pragma unroll
      for (int c = 0; c < CP; ++c)
        s_act[swz_at<kC>(e, c0 + c)] =
            (v[c] - mu) * rstd * s_ls[c0 + c] + s_lb[c0 + c];
    }
    __syncthreads();

    csr_tile::receiver_sums<kTE, kC>(
        [&](int e, int c) -> float& { return s_act[swz_at<kC>(e, c)]; },
        rcv, rowptr, n_edges, tile, n_valid, out, part);
  }
}

template <Entry E>
int launch(const float* src, const float* pxi, const int* rowptr,
           const float* w_rest, const float* b_rest, const float* w_out,
           const float* b_out, const float* ln_s, const float* ln_b,
           float* out, float* part, int n_nodes, int n_edges, int l1,
           cudaStream_t stream) {
  static GridCache cache;
  const size_t smem = Layout::bytes(l1);
  int cap = 0;
  cudaError_t err =
      grid_cap(edge_tail_kernel<E>, kThreads, cache, l1, smem, &cap);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes == 0 || n_edges <= 0) return (int)cudaSuccess;
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int blocks = n_tiles < cap ? n_tiles : cap;
  edge_tail_kernel<E><<<blocks, kThreads, smem, stream>>>(
      src, pxi, rowptr, w_rest, b_rest, w_out, b_out, ln_s, ln_b, out, part,
      n_nodes, n_edges, l1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n_tiles > 1)
    csr_tile::cross_tile_sum_kernel<kTE, kC>
        <<<n_tiles - 1, kC, 0, stream>>>(rowptr, part, out, n_nodes,
                                         n_edges);
  return (int)cudaGetLastError();
}

}  // namespace w64

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success.  Launches on `stream` and does not
// synchronise.  entry (an Entry): kFold, src is e0 (n_edges, ce) and we,
// be, pxj and senders are read; kPregathered, src is h0 (n_edges, h) and
// those four are ignored (they may be null); kPe, src is pe (n_edges, h),
// pxj and senders are read, we and be ignored.  out (n_nodes, c) must
// arrive zeroed; part is scratch of 2 * ceil(n_edges / 64) rows of c
// floats for the tiled builds, all but the width-64 fold entry (which
// ignores it).  The compiled builds are those of the header; other widths
// return cudaErrorInvalidValue.
int fused_edge_tail_agg_f32(const float* src, const float* we, const float* be,
                            const float* pxj, const float* pxi,
                            const int* senders, const int* rowptr,
                            const float* w_rest, const float* b_rest,
                            const float* w_out, const float* b_out,
                            const float* ln_s, const float* ln_b, float* out,
                            float* part, int n_nodes, int n_edges, int ce,
                            int h, int c, int l1, int entry, void* stream) {
  using tile128::kFold;
  using tile128::kPe;
  using tile128::kPregathered;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = h == 64 && c == 32, wide = h == 128 && c == 128;
  const bool gathers = pxj != nullptr && senders != nullptr;
  if (entry == kFold && gathers && we != nullptr && be != nullptr) {
    if (ce == 32 && narrow)
      return launch<32, 64, 32>(src, we, be, pxj, pxi, senders, rowptr,
                                w_rest, b_rest, w_out, b_out, ln_s, ln_b,
                                out, n_nodes, n_edges, l1, s);
    if (ce == 128 && wide && part != nullptr)
      return w128::launch<kFold>(src, we, be, pxj, pxi, senders, rowptr,
                                 w_rest, b_rest, w_out, b_out, ln_s, ln_b,
                                 out, part, n_nodes, n_edges, l1, s);
  } else if (entry == kPregathered) {
    if (narrow && part != nullptr)
      return w64::launch<kPregathered>(src, pxi, rowptr, w_rest, b_rest,
                                       w_out, b_out, ln_s, ln_b, out, part,
                                       n_nodes, n_edges, l1, s);
    if (wide && part != nullptr)
      return w128::launch<kPregathered>(src, we, be, pxj, pxi, senders,
                                        rowptr, w_rest, b_rest, w_out, b_out,
                                        ln_s, ln_b, out, part, n_nodes,
                                        n_edges, l1, s);
  } else if (entry == kPe && gathers && wide && part != nullptr) {
    return w128::launch<kPe>(src, we, be, pxj, pxi, senders, rowptr, w_rest,
                             b_rest, w_out, b_out, ln_s, ln_b, out, part,
                             n_nodes, n_edges, l1, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
