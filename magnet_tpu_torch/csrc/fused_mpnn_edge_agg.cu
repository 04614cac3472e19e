// Fused MPNN message path, forward, f32 operands, the product on the tensor
// cores in error-compensated TF32.
//
// Replaces two TPU kernels of magnet_tpu/ops/pallas_kernels.py:
//   GATHER = true   _mpnn2r_fwd_pallas (public entry fused_mpnn_edge_agg2r),
//                   oracle _mpnn2r_ref_impl: the sender row is read as
//                   pxj[senders[e]] inside the kernel;
//   GATHER = false  _mpnn_fwd_pallas (public entry fused_mpnn_edge_agg),
//                   oracle _mpnn_ref_impl: the sender row is h0[e], gathered
//                   by the caller into an (E, H) array.
// Math, for every edge j -> i of a receiver-grouped CSR graph:
//
//     z1 = send[e] + pr[i];   h1 = swish(z1)
//     z2 = h1 . W + b;        h2 = swish(z2)
//   out[i] = sum of h2 over the edges of i            (N, H) f32
//
// swish(z) = z * sigmoid(z).  The mean over the degree is the caller's.  A
// receiver of degree 0 gets a zero row; every edge range is clamped to the
// E rows given.
//
// What bounds it on an H100: H * H = 16,384 multiply-adds per edge.  Issued
// as three TF32 products per f32 product (see csrc/tile_mm.cuh, tf32x3)
// that is 6 E H^2 FLOP at 495 TFLOP/s: 0.104 ms at MPNN-2D's 524,256 edges
// against 0.008 ms for the node tables read once and out written once
// (GATHER; h0 read once, 0.08 ms, for the pre-gathered entry): bound by the
// tensor cores' operations.
//
// Design (H = 128).  The first design gave each receiver a warp and each
// edge a lane that held h1 (128 floats) in registers and formed z2 on the
// f32 CUDA cores from float4 broadcasts of W: ~190 live registers, one
// block per SM, the shared-memory and FMA pipes both near their limit.
// Now:
//   * a persistent block of 256 threads (8 warps) walks consecutive tiles of
//     TE = 32 CSR edges (the MPNN graphs' mean in-degree is ~32, so a tile
//     holds about one receiver, and 32 rows feed the m16n8k8 products with
//     no padding); warp 0 finds the next tile's receivers from the last
//     receiver of this one (tile128::warp_receiver);
//   * W (64 KB, transposed and XOR-swizzled) stays in shared memory for the
//     whole launch; the tile's sender and receiver rows arrive by cp.async
//     into staging
//     buffers, which are free again as soon as h1 is formed, so the next
//     tile's rows load while this one's product and sums run;
//   * z2 = h1 . W is a tf32x3 product of a 32 x 128 tile (mm_rows32, a warp
//     owns 16 columns; fragments by ldmatrix, split by split_fast);
//     h2 = swish(z2) goes back into h1's buffer;
//   * 115,072 bytes of shared memory and at most 128 registers a thread:
//     two blocks share an SM, so one block's loads and sums overlap the
//     other's products;
//   * the receiver sums are deterministic (csr_tile, csrc/tile_mm.cuh): each
//     run of equal receivers summed in CSR order, a thread per column and
//     half-tile, then the halves joined; a receiver wholly inside a tile is
//     written directly, one that crosses a tile boundary leaves partial
//     rows that a second small kernel adds in tile order.  No atomics: out
//     has the same bits from run to run.
// What still holds it (measured, H100): the product phase issues ~4.6
// instructions per mma (fragment loads, the hi/lo splits) and 16 warps an
// SM (shared memory allows two blocks) hide too little latency; the swish
// passes, the sums and the gathers take about a third of the time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (magnet_tpu_torch/ops/cuda_build.py does this).

#include <cuda_runtime.h>

#include <atomic>

#include "tile_mm.cuh"

namespace {

constexpr int kH = 128;        // the compiled hidden width
constexpr int kTE = 32;        // edges per tile
constexpr int kThreads = 256;  // 8 warps

// z sigmoid(z) by the fast exponential and division (a few ulp each; 0
// where exp(-z) overflows)
__device__ __forceinline__ float swish(float z) {
  return __fdividef(z, 1.f + __expf(-z));
}

// Offsets, in floats, into dynamic shared memory: 115,072 bytes, so that
// two blocks share an SM's 228 KB.
struct Layout {
  static constexpr int tile = kTE * kH;       // a swizzled (kTE, kH) tile
  static constexpr int w = 0;                 // (kH, kH) swizzled
  static constexpr int s = w + kH * kH;       // the tile's send rows
  static constexpr int r = s + tile;          // the tile's pr rows
  static constexpr int h = r + tile;          // h1, then h2
  static constexpr int snd = h + tile;        // (kTE) int: send row indices
  static constexpr int rcv = snd + kTE;       // 2 x (kTE) int, two tiles
  static constexpr int smem_floats = rcv + 2 * kTE;
};

template <bool GATHER>
__global__ void __launch_bounds__(kThreads, 2)
fused_mpnn_edge_agg_kernel(const float* __restrict__ src,
                           const float* __restrict__ pr,
                           const float* __restrict__ w,
                           const float* __restrict__ b,
                           const int* __restrict__ senders,
                           const int* __restrict__ rowptr,
                           float* __restrict__ out, float* __restrict__ part,
                           int n_nodes, int n_edges) {
  using L = Layout;
  using namespace tf32x3;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem + L::w;
  float* s_s = smem + L::s;
  float* s_r = smem + L::r;
  float* s_h = smem + L::h;
  int* s_snd = reinterpret_cast<int*>(smem + L::snd);
  int* s_rcv = reinterpret_cast<int*>(smem + L::rcv);
  // W is stored transposed (row n holds column n of W), so that ldmatrix
  // reads its fragments as it reads h1's
  const LdsmRows<kH> h_rows{s_h};
  const LdsmCols<kH> w_cols{s_w};

  const int tid = threadIdx.x, warp = tid >> 5;
  for (int k = tid; k < kH * kH; k += kThreads)
    s_w[swz_at(k & (kH - 1), k >> 7)] = __ldg(w + k);

  // the block's tiles are consecutive, so each tile's receivers are found
  // from the last receiver of the one before (warp 0)
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int per_block = (n_tiles + gridDim.x - 1) / gridDim.x;
  const int t_beg = blockIdx.x * per_block;
  const int t_end = min(n_tiles, t_beg + per_block);
  auto indices = [&](int tile, int buf, int hint) {
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    const int rv =
        tile128::warp_receiver(rowptr, n_nodes, base, n_valid, hint);
    const bool valid = tid < n_valid;
    s_snd[tid] = !valid ? 0 : GATHER ? __ldg(senders + base + tid)
                                     : base + tid;
    s_rcv[buf * kTE + tid] = valid ? rv : 0;
  };
  // the send and pr rows of tile `tile`, whose indices are in s_snd and
  // receiver buffer `buf`: one committed group
  auto gather = [&](int tile, int buf) {
    const int n_valid = min(kTE, n_edges - tile * kTE);
    const int* rcv = s_rcv + buf * kTE;
    rows_async<kTE>(s_s, 0, src, [&](int e) {
      return e < n_valid ? src + (size_t)s_snd[e] * kH : nullptr;
    });
    rows_async<kTE>(s_r, 0, pr, [&](int e) {
      return e < n_valid ? pr + (size_t)rcv[e] * kH : nullptr;
    });
    cp_async_commit();
  };

  if (t_beg < t_end) {
    if (warp == 0) indices(t_beg, 0, -1);
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

    // h1 = swish(send + pr[i]) (rows past n_valid are zero and stay zero)
    for (int k = tid; k < kTE * kH / 4; k += kThreads) {
      const int o = swz_at(k >> 5, (k & 31) * 4);
      const float4 a = *reinterpret_cast<const float4*>(s_s + o);
      const float4 r = *reinterpret_cast<const float4*>(s_r + o);
      *reinterpret_cast<float4*>(s_h + o) =
          make_float4(swish(a.x + r.x), swish(a.y + r.y), swish(a.z + r.z),
                      swish(a.w + r.w));
    }
    if (more && warp == 0) indices(tile + 1, nxt, rcv[n_valid - 1]);
    __syncthreads();  // h1 written, the staging buffers free
    if (more) gather(tile + 1, nxt);

    // z2 = h1 . W + b, then h2 = swish(z2) over h1
    float acc[2][2][4];
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float bias = __ldg(b + acc_col(16 * warp + 8 * ni, c));
        acc[0][ni][c] = bias;
        acc[1][ni][c] = bias;
      }
    mm_rows32<kH>(acc, h_rows, w_cols);
    __syncthreads();  // every warp has read h1
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s_h[swz_at(acc_row(16 * mi, c), acc_col(16 * warp + 8 * ni, c))] =
              swish(acc[mi][ni][c]);
    __syncthreads();

    csr_tile::receiver_sums<kTE, kH>(
        [&](int e, int c) -> float& { return s_h[swz_at(e, c)]; }, rcv,
        rowptr, n_edges, tile, n_valid, out, part);
  }
}

constexpr int kMaxDevices = 64;

// The persistent grid's size (SMs x resident blocks per SM) on the current
// device.  The shared-memory opt-in and the device queries run once per
// device and instantiation; later launches read the cache.
template <bool GATHER>
cudaError_t grid_cap(size_t smem, int* cap) {
  static std::atomic<int> cache[kMaxDevices];  // 0: unset
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && (*cap = cache[device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  auto kernel = fused_mpnn_edge_agg_kernel<GATHER>;
  int optin = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *cap = n_sm * per_sm;
  if (cached) cache[device].store(*cap, std::memory_order_relaxed);
  return cudaSuccess;
}

template <bool GATHER>
int launch(const float* src, const float* pr, const float* w, const float* b,
           const int* senders, const int* rowptr, float* out, float* part,
           int n_nodes, int n_edges, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Layout::smem_floats;
  int cap = 0;
  cudaError_t err = grid_cap<GATHER>(smem, &cap);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes == 0 || n_edges <= 0) return (int)cudaSuccess;
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int blocks = n_tiles < cap ? n_tiles : cap;
  fused_mpnn_edge_agg_kernel<GATHER><<<blocks, kThreads, smem, stream>>>(
      src, pr, w, b, senders, rowptr, out, part, n_nodes, n_edges);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n_tiles > 1)
    csr_tile::cross_tile_sum_kernel<kTE, kH>
        <<<n_tiles - 1, kH, 0, stream>>>(rowptr, part, out, n_nodes,
                                         n_edges);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success.  Launches on `stream` and does not
// synchronise.  gather != 0: src is pxj (n_nodes, h) and senders (n_edges,)
// is read; gather == 0: src is h0 (n_edges, h) and senders is ignored.  out
// (n_nodes, h) must arrive zeroed; part is scratch of 2 * ceil(n_edges /
// 32) rows of h floats.  src and pr are 16-byte aligned.  Compiled for
// h = 128; other widths return cudaErrorInvalidValue.
int fused_mpnn_edge_agg_f32(const float* src, const float* pr, const float* w,
                            const float* b, const int* senders,
                            const int* rowptr, float* out, float* part,
                            int n_nodes, int n_edges, int h, int gather,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h != kH) return (int)cudaErrorInvalidValue;
  if (gather) {
    if (senders == nullptr) return (int)cudaErrorInvalidValue;
    return launch<true>(src, pr, w, b, senders, rowptr, out, part, n_nodes,
                        n_edges, s);
  }
  return launch<false>(src, pr, w, b, senders, rowptr, out, part, n_nodes,
                       n_edges, s);
}

}  // extern "C"
