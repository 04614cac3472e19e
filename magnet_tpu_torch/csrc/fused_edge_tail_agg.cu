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
// pregathered (H, C) = (64, 32) and (128, 128); pe (H, C) = (64, 32)
// (MAgNet[CNN]) and (128, 128) (MAgNet[GNN]).
//
// Every build walks the graph the same way.  Hopper gathers natively, so
// none of the TPU's one-hot gather matmuls, sender-tile windows or
// live-chunk lists carry over:
//   * a persistent block of 256 threads (8 warps) walks consecutive tiles of
//     TE = 64 CSR edges, whatever the degrees; warps 0 and 1 find the next
//     tile's receivers (and senders) from the last receiver of this one
//     (tile128::warp_receiver);
//   * every product runs on the tensor cores in error-compensated TF32
//     (tf32x3 in csrc/tile_mm.cuh: mma.sync m16n8k8, operands split into
//     hi / lo by split_fast, three TF32 products in f32 accumulators, about
//     2^-21 of |a b| per product; the two small products accumulate apart,
//     mma3_apart, since the tensor cores truncate what they add to a large
//     accumulator): warp w owns rows 32 (w & 1) .. + 31 and
//     a quarter of the columns of the tile's (64 x N) product (mm_rows64);
//     activations stay in a swizzled (64 x H) shared tile and never reach
//     device memory;
//   * LayerNorm takes four threads an edge;
//   * the receiver sums run over each run of equal receivers in CSR order
//     (csr_tile): a receiver wholly inside the tile is written directly; one
//     that crosses a tile boundary leaves one partial row per tile, and a
//     second small kernel adds those in tile order.  No atomics: out has the
//     same bits from run to run.
//
// Width 64 (namespace w64; fold (32, 64, 32), pregathered and pe (64,
// 32)).
// Every weight (three 64 x 64, one 64 x 32, and the fold's 32 x 64 W_e;
// transposed and XOR-swizzled, so that ldmatrix reads their fragments)
// stays in shared memory for the whole launch.  The tile's input rows arrive
// by cp.async into staging buffers that are free again once the first
// layer is formed, so the next tile's rows load while this one's layers
// run: the pregathered entry stages h0 and pxi rows and forms relu(h0 +
// pxi[i]); the pe entry stages pe and pxi rows the same way and its
// sender ids beside the receivers, and forms relu((pe + pxj[s]) + pxi[i])
// with the sender rows read through L2 as the staged rows are read (a
// third (64, 64) staging tile for them would leave one block an SM); the
// fold entry stages its e0 rows (64 x 32) and forms the first
// layer as one more product, e0 . W_e, whose accumulators start at b_e +
// pxj[s] + pxi[i] read through L2 (the node tables are small and stay
// there).  92,032 bytes of shared memory (fold), 107,904 (pregathered) and
// 108,416 (pe) at L1 = 3, at most 128 registers a thread: two blocks share
// an SM.
// Bound at the main paths' shapes (L1 = 3): the fold does Ce H + L1 H^2 +
// H C = 16,384 multiply-adds an edge, issued as three TF32 products: at
// MAgNet[CNN] 1D's eval graph (186,624 edges) 0.037 ms at 495 TFLOP/s
// (0.091 on the f32 CUDA cores), at its training graph (67,680) 0.013, at
// MAgNet[CNN] 2D's eval graph (647,664) 0.129, against ~24 MB of e0 a
// launch at 1D eval (0.007 ms): bound by operations.  The pregathered
// entry does 14,336 an edge (0.052 ms at 2D training's 299,894 edges,
// against 0.027 ms of h0), and so does the pe entry (0.032 ms at 1D's eval
// graph, against 47.8 MB of pe, 0.014 ms; 0.113 ms at 2D's eval graph).
//
// Width 128 (namespace w128; all three entries, Ce = H = C = 128).  The
// five 128 x 128 weights (320 KB) do not fit a block, so each is streamed
// through shared memory in K-chunks of 32 rows (16 KB), as stored (in,
// out) and swizzled, through a cp.async double buffer: the next chunk
// (across layers and tiles) loads while this one's product runs, with one
// barrier a chunk.  The B fragments are read by scalar loads, since
// ldmatrix cannot transpose 32-bit elements.  The tile's input rows (e0,
// pe or h0) are staged for the next tile in pieces spread over the chunk
// steps once the staging tile is free (from the second layer on for the
// fold, whose first product reads e0 there; from the first for the
// others, whose first input relu(src + pxi[i] (+ pxj[s])) is formed from
// it); the fold's accumulators start at b_e + pxj[s] + pxi[i] read
// through L2.  99,328 bytes: the activation tile, the staging tile, two
// chunks and the indices; two blocks share an SM.  Weight traffic: each
// tile reads every weight from L2 once, 1,317 tiles x 320 KB = 432 MB a
// launch at MAgNet[GNN]'s eval batch (84,256 LR u HR edges); each weight
// byte feeds 64 rows x 3 TF32 products (96 flop a byte), so running at the
// TF32 peak would ask ~5 TB/s of L2 and a quarter of it ~1.3 TB/s.  Tiles
// of 128 edges would halve the traffic but leave one block per SM.  Bound there: fold 81,920 multiply-adds an edge, 0.084 ms
// in three TF32 products at 495 TFLOP/s (0.206 on the f32 CUDA cores); pe
// 65,536, 0.067 ms, against 43 MB of pe (0.013 ms): bound by operations.
// What still holds both widths (reckoned from the code; the times are in
// PERF.md): the instructions around each mma (fragment loads and splits)
// and the latency that 16 warps an SM leave exposed between barriers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (magnet_tpu_torch/ops/cuda_build.py does this).

#include <cuda_runtime.h>

#include <atomic>

#include "tile_mm.cuh"

namespace {

using tile128::Entry;
using tile128::kFold;
using tile128::kPe;
using tile128::kPregathered;

constexpr float kLnEps = 1e-5f;
constexpr int kTE = 64;          // edges per tile
constexpr int kThreads = 256;    // 8 warps

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

// acc += corr, and corr = 0 (the small products' accumulator, mm_rows64).
template <int N>
__device__ __forceinline__ void add_apart(float (&acc)[2][N / 32][4],
                                          float (&corr)[2][N / 32][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < N / 32; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[mi][ni][c] += corr[mi][ni][c];
        corr[mi][ni][c] = 0.f;
      }
}

// acc = bias on the columns mm_rows64<N, K> gives the thread.
template <int N>
__device__ __forceinline__ void bias_init(float (&acc)[2][N / 32][4],
                                          const float* bias) {
  using namespace tf32x3;
  const int n0 = (N / 4) * (threadIdx.x >> 6);  // warp w: (N / 4) (w >> 1)
#pragma unroll
  for (int ni = 0; ni < N / 32; ++ni)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float b = bias[acc_col(n0 + 8 * ni, c)];
      acc[0][ni][c] = b;
      acc[1][ni][c] = b;
    }
}

// acc = b_e + pxj[sender] + pxi[receiver] on the rows and columns
// mm_rows64<N, K> gives the thread, zero past n_valid: the start of the
// fold entry's first product.  pxj and pxi rows hold N floats, 8-byte
// aligned; s_snd / s_rcv hold the tile's indices (zero past n_valid).
template <int N>
__device__ __forceinline__ void fold_init(float (&acc)[2][N / 32][4],
                                          const float* __restrict__ be,
                                          const float* __restrict__ pxj,
                                          const float* __restrict__ pxi,
                                          const int* s_snd, const int* s_rcv,
                                          int n_valid) {
  using namespace tf32x3;
  const int w = threadIdx.x >> 5, m0 = 32 * (w & 1), n0 = (N / 4) * (w >> 1);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int e = acc_row(m0 + 16 * mi, 2 * hf);
      const bool valid = e < n_valid;
      const float* pj = pxj + (size_t)s_snd[e] * N;
      const float* pi = pxi + (size_t)s_rcv[e] * N;
#pragma unroll
      for (int ni = 0; ni < N / 32; ++ni) {
        const int n = acc_col(n0 + 8 * ni, 0);
        const float2 j = __ldg(reinterpret_cast<const float2*>(pj + n));
        const float2 i = __ldg(reinterpret_cast<const float2*>(pi + n));
        acc[mi][ni][2 * hf] = valid ? __ldg(be + n) + j.x + i.x : 0.f;
        acc[mi][ni][2 * hf + 1] = valid ? __ldg(be + n + 1) + j.y + i.y : 0.f;
      }
    }
}

// s_act (a swizzled (kTE, N) tile) <- acc, through relu when RELU, on the
// rows and columns mm_rows64<N, K> gives the thread.
template <int N, bool RELU>
__device__ __forceinline__ void store_acc(float* s_act,
                                          const float (&acc)[2][N / 32][4]) {
  using namespace tf32x3;
  const int w = threadIdx.x >> 5, m0 = 32 * (w & 1), n0 = (N / 4) * (w >> 1);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < N / 32; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = acc[mi][ni][c];
        s_act[swz_at<N>(acc_row(m0 + 16 * mi, c), acc_col(n0 + 8 * ni, c))] =
            RELU ? fmaxf(v, 0.f) : v;
      }
}

// LayerNorm (two-pass variance) of the tile's rows y (a swizzled (kTE, C)
// tile), in place: four threads an edge, thread q of edge e holding
// columns q, q + 4, ... (free of bank conflicts).
template <int C>
__device__ __forceinline__ void layer_norm(float* s_y,
                                           const float* __restrict__ ln_s,
                                           const float* __restrict__ ln_b) {
  static_assert(kTE * 4 == kThreads, "LayerNorm: four threads per edge");
  using namespace tf32x3;
  constexpr int CP = C / 4;
  const int e = threadIdx.x >> 2, q = threadIdx.x & 3;
  float v[CP];
  float mu = 0.f;
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    v[j] = s_y[swz_at<C>(e, q + 4 * j)];
    mu += v[j];
  }
  mu += __shfl_xor_sync(0xffffffffu, mu, 1);
  mu += __shfl_xor_sync(0xffffffffu, mu, 2);
  mu *= 1.f / C;
  float var = 0.f;
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const float d = v[j] - mu;
    var = fmaf(d, d, var);
  }
  var += __shfl_xor_sync(0xffffffffu, var, 1);
  var += __shfl_xor_sync(0xffffffffu, var, 2);
  var *= 1.f / C;
  const float rstd = rsqrtf(var + kLnEps);
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const int c = q + 4 * j;
    s_y[swz_at<C>(e, c)] =
        (v[j] - mu) * rstd * __ldg(ln_s + c) + __ldg(ln_b + c);
  }
}

// The launch shared by both widths: the persistent grid of `kernel`
// (smem bytes a block), then the partial-row sum of the receivers that
// cross a tile.
template <int C, class Kernel, class... Args>
int launch_tiles(Kernel kernel, GridCache& cache, size_t smem, int n_nodes,
                 int n_edges, int l1, const int* rowptr, float* out,
                 float* part, cudaStream_t stream, Args... args) {
  int cap = 0;
  cudaError_t err = grid_cap(kernel, kThreads, cache, l1, smem, &cap);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes == 0 || n_edges <= 0) return (int)cudaSuccess;
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int blocks = n_tiles < cap ? n_tiles : cap;
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n_tiles > 1)
    csr_tile::cross_tile_sum_kernel<kTE, C>
        <<<n_tiles - 1, C, 0, stream>>>(rowptr, part, out, n_nodes, n_edges);
  return (int)cudaGetLastError();
}

namespace w128 {

using tile128::kW;
constexpr int kKC = 32;                // weight rows a streamed chunk
constexpr int kChunks = kW / kKC;      // chunks a weight
constexpr int kPieces = kTE * kW / 4;  // 16-byte pieces of a tile's rows

// Offsets, in floats, into dynamic shared memory: 99,328 bytes, so that
// two blocks share an SM.
struct Layout {
  static constexpr int tile = kTE * kW;         // a swizzled (kTE, kW) tile
  static constexpr int act = 0;                 // activations, then y
  static constexpr int src = act + tile;        // staged e0 / pe / h0 rows
  static constexpr int w = src + tile;          // 2 x (kKC, kW) chunks
  static constexpr int rcv = w + 2 * kKC * kW;  // 2 x (kTE) int, two tiles
  static constexpr int snd = rcv + 2 * kTE;     // 2 x (kTE) int
  static constexpr int floats = snd + 2 * kTE;
};

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
  using L = Layout;
  using namespace tf32x3;
  constexpr bool kFoldE = E == kFold;
  constexpr bool kGathers = E != kPregathered;  // reads senders and pxj
  extern __shared__ __align__(16) float w128_smem[];
  float* s_act = w128_smem + L::act;
  float* s_src = w128_smem + L::src;
  float* s_w = w128_smem + L::w;
  int* s_rcv = reinterpret_cast<int*>(w128_smem + L::rcv);
  int* s_snd = reinterpret_cast<int*>(w128_smem + L::snd);
  const int tid = threadIdx.x, warp = tid >> 5;

  int t_beg, t_end;
  tile128::block_tiles<kTE>(n_edges, &t_beg, &t_end);
  if (t_beg >= t_end) return;  // the whole block

  // The weight chain, one step a chunk: W_e (fold), W_1 .. W_L1, W_out.
  // n_steps is even, so chunk s of every tile lands in buffer s & 1.
  const int first = kFoldE ? 1 : 0;  // W_1's place in the chain
  const int n_mats = l1 + 1 + first;
  const int n_steps = n_mats * kChunks;
  auto matrix = [&](int m, const float* head, const float* rest, int size,
                    const float* tail) {
    return kFoldE && m == 0 ? head
           : m - first < l1 ? rest + (size_t)(m - first) * size
                            : tail;
  };
  auto load_chunk = [&](int s) {
    const float* w = matrix(s / kChunks, we, w_rest, kW * kW, w_out) +
                     (size_t)(s % kChunks) * kKC * kW;
    rows_async<kKC>(s_w + (s & 1) * kKC * kW, 0, w,
                    [&](int r) { return w + r * kW; });
  };
  // pieces [p0, p1) of tile `tile`'s input rows into the staging tile
  auto stage = [&](int tile, int p0, int p1) {
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    for (int p = p0 + tid; p < p1; p += kThreads) {
      const int r = p >> 5, c = (p & 31) * 4;
      const bool valid = r < n_valid;
      cp_async16(s_src + swz_at(r, c),
                 valid ? src + (size_t)(base + r) * kW + c : src, valid);
    }
  };
  // the next tile's rows arrive in pieces over the steps whose staging
  // tile is free: from W_1's first chunk on (the fold's first product
  // reads e0 there), or from the first step (the other entries form their
  // first input from it before)
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
    float acc[2][4][4], corr[2][4][4] = {};
    if (kFoldE) {
      // z = b_e + pxj[sender] + pxi[receiver] (+ e0 . W_e below); the
      // loads run while the block waits for its rows
      fold_init<kW>(acc, be, pxj, pxi, snd, rcv, n_valid);
    } else {
      cp_async_wait<0>();
      __syncthreads();  // the rows are in; the last tile's sums are done
      // act = relu(src + pxi[i] (+ pxj[s])), zero past n_valid
#pragma unroll 2
      for (int p = tid; p < kPieces; p += kThreads) {
        const int r = p >> 5, c = (p & 31) * 4, o = swz_at(r, c);
        float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < n_valid) {
          const float4 a = *reinterpret_cast<const float4*>(s_src + o);
          const float4 b = __ldg(
              reinterpret_cast<const float4*>(pxi + (size_t)rcv[r] * kW + c));
          z = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
          if (E == kPe) {
            const float4 j = __ldg(reinterpret_cast<const float4*>(
                pxj + (size_t)snd[r] * kW + c));
            z = make_float4(z.x + j.x, z.y + j.y, z.z + j.z, z.w + j.w);
          }
        }
        *reinterpret_cast<float4*>(s_act + o) =
            make_float4(fmaxf(z.x, 0.f), fmaxf(z.y, 0.f), fmaxf(z.z, 0.f),
                        fmaxf(z.w, 0.f));
      }
    }

    for (int s = 0; s < n_steps; ++s) {
      const int m = s / kChunks, c = s % kChunks;
      if (c == 0 && !(kFoldE && m == 0))
        bias_init<kW>(acc, matrix(m, be, b_rest, kW, b_out));
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
      const float* a = kFoldE && m == 0 ? s_src : s_act;
      mm_rows64<kW, kKC>(acc, corr, LdsmRows<kW>{a + c * kKC},
                         RowsB<kW>{s_w + (s & 1) * kKC * kW});
      if (c == kChunks - 1) {
        // the layer's end: act <- relu(acc), or y for the last layer
        add_apart<kW>(acc, corr);
        if (!(kFoldE && m == 0)) __syncthreads();  // every warp read act
        if (m == n_mats - 1)
          store_acc<kW, false>(s_act, acc);
        else
          store_acc<kW, true>(s_act, acc);
      }
    }
    __syncthreads();  // y written
    layer_norm<kW>(s_act, ln_s, ln_b);
    __syncthreads();
    // the receiver sums over each run of equal receivers; partial rows for
    // the receivers that cross a tile boundary
    csr_tile::receiver_sums<kTE, kW>(
        [&](int e, int col) -> float& { return s_act[swz_at(e, col)]; }, rcv,
        rowptr, n_edges, tile, n_valid, out, part);
  }
}

template <Entry E>
int launch(const float* src, const float* we, const float* be,
           const float* pxj, const float* pxi, const int* senders,
           const int* rowptr, const float* w_rest, const float* b_rest,
           const float* w_out, const float* b_out, const float* ln_s,
           const float* ln_b, float* out, float* part, int n_nodes,
           int n_edges, int l1, cudaStream_t stream) {
  static GridCache cache;
  return launch_tiles<kW>(edge_tail_kernel<E>, cache,
                          sizeof(float) * Layout::floats, n_nodes, n_edges,
                          l1, rowptr, out, part, stream, src, we, be, pxj,
                          pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
                          ln_s, ln_b, out, part, n_nodes, n_edges, l1);
}

}  // namespace w128

namespace w64 {

constexpr int kCe = 32;         // the fold's edge-latent width
constexpr int kH = 64;          // hidden width
constexpr int kC = 32;          // output width

// Offsets, in floats, into dynamic shared memory: the tiles, then the
// weights, all XOR-swizzled (tf32x3::swz_at); 92,032 bytes (fold), 107,904
// (pregathered) and 108,416 (pe) at L1 = 3.
template <Entry E>
struct Layout {
  static constexpr bool fold = E == kFold;
  static constexpr bool gathers = E != kPregathered;  // stages senders
  static constexpr int tile = kTE * kH;          // a (kTE, kH) tile
  static constexpr int src = 0;                  // the tile's h0 / pe / e0
  static constexpr int pxi = src + (fold ? kTE * kCe : tile);  // its pxi
  static constexpr int act = pxi + (fold ? 0 : tile);  // h, then y (kTE, kC)
  static constexpr int rcv = act + tile;         // 2 x (kTE) int, two tiles
  static constexpr int snd = rcv + 2 * kTE;      // fold, pe: 2 x (kTE) int
  static constexpr int we = snd + (gathers ? 2 * kTE : 0);  // fold: (kH, kCe)
  static constexpr int wo = we + (fold ? kH * kCe : 0);  // (kC, kH)
  static constexpr int bo = wo + kH * kC;        // (kC)
  static constexpr int wr = bo + kC;             // L1 x (kH, kH), (L1, kH)
  static size_t bytes(int l1) {
    return sizeof(float) * (size_t)(wr + l1 * (kH * kH + kH));
  }
};

// dst <- the transposes of n_mat (K x N) weights w, each an (N x K)
// XOR-swizzled tile (row n holds column n of its weight), so that ldmatrix
// reads their fragments as it reads the activations'.
template <int K, int N>
__device__ __forceinline__ void load_transposed(float* dst,
                                                const float* __restrict__ w,
                                                int n_mat) {
  for (int k = threadIdx.x; k < n_mat * K * N; k += kThreads) {
    const int m = k / (K * N), kk = (k / N) % K, n = k % N;
    dst[m * K * N + tf32x3::swz_at<K>(n, kk)] = __ldg(w + k);
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
  float acc[2][N / 32][4], corr[2][N / 32][4] = {};
  bias_init<N>(acc, s_bias);
  mm_rows64<N, K>(acc, corr, LdsmRows<K>{s_act}, LdsmCols<K>{s_w});
  add_apart<N>(acc, corr);
  __syncthreads();  // every warp has read the tile
  store_acc<N, RELU>(s_act, acc);
  __syncthreads();
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
  using L = Layout<E>;
  using namespace tf32x3;
  constexpr bool kFoldE = E == kFold;
  constexpr bool kGathers = L::gathers;   // reads senders and pxj
  constexpr int kIn = kFoldE ? kCe : kH;  // the staged rows' width
  extern __shared__ __align__(16) float w64_smem[];
  float* s_src = w64_smem + L::src;
  float* s_pxi = w64_smem + L::pxi;
  float* s_act = w64_smem + L::act;
  int* s_rcv = reinterpret_cast<int*>(w64_smem + L::rcv);
  int* s_snd = reinterpret_cast<int*>(w64_smem + L::snd);
  float* s_we = w64_smem + L::we;
  float* s_wo = w64_smem + L::wo;
  float* s_bo = w64_smem + L::bo;
  float* s_wr = w64_smem + L::wr;
  float* s_br = s_wr + l1 * kH * kH;
  const int tid = threadIdx.x, warp = tid >> 5;
  load_transposed<kH, kH>(s_wr, w_rest, l1);
  load_transposed<kH, kC>(s_wo, w_out, 1);
  if (kFoldE) load_transposed<kCe, kH>(s_we, we, 1);
  for (int k = tid; k < l1 * kH; k += kThreads) s_br[k] = __ldg(b_rest + k);
  if (tid < kC) s_bo[tid] = __ldg(b_out + tid);

  int t_beg, t_end;
  tile128::block_tiles<kTE>(n_edges, &t_beg, &t_end);
  // the input rows of tile `tile`, whose receivers are in buffer `buf`:
  // h0 (pregathered) or pe (pe) and pxi, or e0 (fold), one committed group
  auto gather = [&](int tile, int buf) {
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    rows_async<kTE, kIn>(s_src, 0, src, [&](int e) {
      return e < n_valid ? src + (size_t)(base + e) * kIn : nullptr;
    });
    if (!kFoldE) {
      const int* rcv = s_rcv + buf * kTE;
      rows_async<kTE, kH>(s_pxi, 0, pxi, [&](int e) {
        return e < n_valid ? pxi + (size_t)rcv[e] * kH : nullptr;
      });
    }
    cp_async_commit();
  };

  if (t_beg < t_end) {
    if (warp < 2)
      tile128::tile_indices<kTE, kGathers>(s_rcv, s_snd, senders, rowptr,
                                           n_nodes, n_edges, t_beg, -1);
    __syncthreads();
    gather(t_beg, 0);
  }
  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const int n_valid = min(kTE, n_edges - tile * kTE);
    const int* rcv = s_rcv + cur * kTE;
    const bool more = tile + 1 < t_end;
    float acc[2][kH / 32][4];
    if (kFoldE)  // z = b_e + pxj[s] + pxi[i], loaded while the rows arrive
      fold_init<kH>(acc, be, pxj, pxi, s_snd + cur * kTE, rcv, n_valid);
    cp_async_wait<0>();
    __syncthreads();  // the rows are in; the last tile's sums are done

    if (kFoldE) {
      // h = relu(z + e0 . W_e); act is free, the product reads e0
      float corr[2][kH / 32][4] = {};
      mm_rows64<kH, kCe>(acc, corr, LdsmRows<kCe>{s_src},
                         LdsmCols<kCe>{s_we});
      add_apart<kH>(acc, corr);
      store_acc<kH, true>(s_act, acc);
    } else {
      // act = relu(h0[e] + pxi[i]), or relu((pe[e] + pxj[s]) + pxi[i]) with
      // pxj read through L2, from the staging rows (zero past n_valid, and
      // so zero in act)
      const int* snd = s_snd + cur * kTE;
      for (int k = tid; k < kTE * kH / 4; k += kThreads) {
        const int e = k >> 4, c = (k & 15) * 4, o = swz_at<kH>(e, c);
        float4 a = *reinterpret_cast<const float4*>(s_src + o);
        if (E == kPe && e < n_valid) {
          const float4 j = __ldg(
              reinterpret_cast<const float4*>(pxj + (size_t)snd[e] * kH + c));
          a = make_float4(a.x + j.x, a.y + j.y, a.z + j.z, a.w + j.w);
        }
        const float4 b = *reinterpret_cast<const float4*>(s_pxi + o);
        *reinterpret_cast<float4*>(s_act + o) =
            make_float4(fmaxf(a.x + b.x, 0.f), fmaxf(a.y + b.y, 0.f),
                        fmaxf(a.z + b.z, 0.f), fmaxf(a.w + b.w, 0.f));
      }
    }
    if (more && warp < 2)
      tile128::tile_indices<kTE, kGathers>(
          s_rcv + nxt * kTE, s_snd + nxt * kTE, senders, rowptr, n_nodes,
          n_edges, tile + 1, rcv[n_valid - 1]);
    __syncthreads();  // act written, the staging buffers free
    if (more) gather(tile + 1, nxt);

    for (int k = 0; k < l1; ++k)
      layer<kH, kH, true>(s_act, s_wr + k * kH * kH, s_br + k * kH);
    layer<kC, kH, false>(s_act, s_wo, s_bo);
    layer_norm<kC>(s_act, ln_s, ln_b);
    __syncthreads();

    csr_tile::receiver_sums<kTE, kC>(
        [&](int e, int c) -> float& { return s_act[swz_at<kC>(e, c)]; },
        rcv, rowptr, n_edges, tile, n_valid, out, part);
  }
}

template <Entry E>
int launch(const float* src, const float* we, const float* be,
           const float* pxj, const float* pxi, const int* senders,
           const int* rowptr, const float* w_rest, const float* b_rest,
           const float* w_out, const float* b_out, const float* ln_s,
           const float* ln_b, float* out, float* part, int n_nodes,
           int n_edges, int l1, cudaStream_t stream) {
  static GridCache cache;
  return launch_tiles<kC>(edge_tail_kernel<E>, cache, Layout<E>::bytes(l1),
                          n_nodes, n_edges, l1, rowptr, out, part, stream,
                          src, we, be, pxj, pxi, senders, rowptr, w_rest,
                          b_rest, w_out, b_out, ln_s, ln_b, out, part,
                          n_nodes, n_edges, l1);
}

}  // namespace w64

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success.  Launches on `stream` and does not
// synchronise.  entry (an Entry): kFold, src is e0 (n_edges, ce) and we,
// be, pxj and senders are read; kPregathered, src is h0 (n_edges, h) and
// those four are ignored (they may be null); kPe, src is pe (n_edges, h),
// pxj and senders are read, we and be ignored.  src, pxj and pxi are
// 16-byte aligned.  out (n_nodes, c) must arrive zeroed; part is scratch of
// 2 * ceil(n_edges / 64) rows of c floats.  The compiled builds are those
// of the header; other widths return cudaErrorInvalidValue.
int fused_edge_tail_agg_f32(const float* src, const float* we, const float* be,
                            const float* pxj, const float* pxi,
                            const int* senders, const int* rowptr,
                            const float* w_rest, const float* b_rest,
                            const float* w_out, const float* b_out,
                            const float* ln_s, const float* ln_b, float* out,
                            float* part, int n_nodes, int n_edges, int ce,
                            int h, int c, int l1, int entry, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = h == 64 && c == 32, wide = h == 128 && c == 128;
  const bool gathers = pxj != nullptr && senders != nullptr;
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  if (entry == kFold && gathers && we != nullptr && be != nullptr) {
    if (ce == 32 && narrow)
      return w64::launch<kFold>(src, we, be, pxj, pxi, senders, rowptr,
                                w_rest, b_rest, w_out, b_out, ln_s, ln_b, out,
                                part, n_nodes, n_edges, l1, s);
    if (ce == 128 && wide)
      return w128::launch<kFold>(src, we, be, pxj, pxi, senders, rowptr,
                                 w_rest, b_rest, w_out, b_out, ln_s, ln_b,
                                 out, part, n_nodes, n_edges, l1, s);
  } else if (entry == kPregathered) {
    if (narrow)
      return w64::launch<kPregathered>(src, we, be, pxj, pxi, senders,
                                       rowptr, w_rest, b_rest, w_out, b_out,
                                       ln_s, ln_b, out, part, n_nodes,
                                       n_edges, l1, s);
    if (wide)
      return w128::launch<kPregathered>(src, we, be, pxj, pxi, senders,
                                        rowptr, w_rest, b_rest, w_out, b_out,
                                        ln_s, ln_b, out, part, n_nodes,
                                        n_edges, l1, s);
  } else if (entry == kPe && gathers) {
    if (narrow)
      return w64::launch<kPe>(src, we, be, pxj, pxi, senders, rowptr, w_rest,
                              b_rest, w_out, b_out, ln_s, ln_b, out, part,
                              n_nodes, n_edges, l1, s);
    if (wide)
      return w128::launch<kPe>(src, we, be, pxj, pxi, senders, rowptr,
                               w_rest, b_rest, w_out, b_out, ln_s, ln_b, out,
                               part, n_nodes, n_edges, l1, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
