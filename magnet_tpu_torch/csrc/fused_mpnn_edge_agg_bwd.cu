// Fused MPNN message path, backward by recompute, f32 operands, products on
// the tensor cores in error-compensated TF32.
//
// Replaces two TPU kernels of magnet_tpu/ops/pallas_kernels.py:
//   GATHER = true   _mpnn2r_bwd_pallas (gradient of fused_mpnn_edge_agg2r;
//                   the oracle is autodiff of _mpnn2r_ref_impl): the sender
//                   row is pxj[senders[e]], and d_z1 is scattered into the
//                   sender table d_pxj as well as the receiver table d_pr;
//   GATHER = false  _mpnn_bwd_pallas (gradient of fused_mpnn_edge_agg; the
//                   oracle is autodiff of _mpnn_ref_impl): the sender row
//                   is h0[e], and d_h0[e] = d_z1 is written per edge.
//
// Given the forward's operands and g (N, H), for every edge j -> i of a
// receiver-grouped CSR graph it recomputes
//
//     z1 = send[e] + pr[i];  h1 = swish(z1);  z2 = h1 . W + b
//
// and forms, all f32:
//     d_z2 = g[i] * swish'(z2)          dW += h1^T . d_z2     db += sum d_z2
//     d_h1 = d_z2 . W^T                 d_z1 = d_h1 * swish'(z1)
//     d_pr[i] += d_z1                   d_pxj[j] += d_z1  or  d_h0[e] = d_z1
// with swish'(z) = s (1 + z (1 - s)), s = sigmoid(z).  A receiver of degree
// 0 has no edge, so its d_pr row stays 0.  No (E, H) array is written to
// device memory except d_h0, which is an output of the pre-gathered entry.
//
// What bounds it on an H100: recompute, data gradient and weight gradient
// are each H * H multiply-adds per edge.  Issued as three TF32 products per
// f32 product that is 18 E H^2 FLOP at 495 TFLOP/s (0.31 ms at MPNN-2D's
// 524,256 edges, H = 128), against node tables read once and written once
// (GATHER) or h0 read and d_h0 written once: bound by operations.
//
// Design (one kernel, H = 128):
//   * a persistent block of 256 threads (8 warps, one block per SM) walks
//     tiles of 32 consecutive CSR edges; warp 0 finds the tile's receivers
//     in rowptr (tile128::warp_receiver);
//   * W (132-float rows) stays in shared memory for the whole launch; the
//     tile's sender and receiver rows are gathered with cp.async into a
//     second pair of buffers while the current tile computes, so the
//     gathers of tile t + 1 overlap the products of tile t;
//   * the three products are tf32x3 tensor-core products (csrc/tile_mm.cuh):
//     z2 = h1 . W and d_h1 = d_z2 . W^T as 32 x 128 tiles (a warp owns 16
//     columns), dW += h1^T . d_z2 as a 128 x 128 result whose 64 f32
//     accumulators a thread keeps across all tiles of its block; h1 and
//     d_z2, which every warp reads, are split into hi / lo once as they are
//     formed, W as its fragments are loaded (204 KB of shared memory);
//   * mma.sync and not wgmma: the three products read W as stored and
//     transposed and h1 / d_z2 row-major and transposed, while wgmma's tf32
//     form reads only K-major operands from shared memory; mma.sync's
//     fragments are loaded by threads at any strides from one copy;
//   * a block writes its dW and db once; a second small kernel adds the
//     blocks' partials in a fixed order, so dW and db are the same from run
//     to run;
//   * d_pxj is scattered over senders with f32 atomicAdd into a zeroed
//     buffer; d_pr is summed over each run of equal receivers inside half a
//     tile and added with one atomicAdd per run.  Both therefore differ in
//     the last bits from run to run.  (The scatter's share of the launch is
//     measured by magnet_tpu_torch/probe_atomics.py.)
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

// sigmoid by the fast exponential (a few ulp) and a correctly rounded
// reciprocal: 48 of them a thread per tile
__device__ __forceinline__ float sigmoidf(float z) {
  return __frcp_rn(1.f + __expf(-z));
}

__device__ __forceinline__ float dswish(float z) {
  const float s = sigmoidf(z);
  return s * (1.f + z * (1.f - s));
}

// Offsets, in floats, into dynamic shared memory: 115,200 bytes, so that
// two blocks share an SM's 228 KB.
struct Layout {
  static constexpr int tile = kTE * kH;          // a swizzled (kTE, kH) tile
  static constexpr int w = 0;                    // (kH, kH) swizzled
  static constexpr int s = w + kH * kH;          // send rows, z1, then d_z1
  static constexpr int r = s + tile;             // pr rows, then h1
  static constexpr int d2 = r + tile;            // d_z2
  static constexpr int snd = d2 + tile;          // 2 x (kTE) int, two tiles
  static constexpr int rcv = snd + 2 * kTE;      // 2 x (kTE) int
  static constexpr int smem_floats = rcv + 2 * kTE;
  static constexpr int g_total = kH * kH + kH;   // packed dW (H, H), db (H)
};

template <bool GATHER>
__global__ void __launch_bounds__(kThreads, 2)
fused_mpnn_edge_agg_bwd_kernel(
    const float* __restrict__ src, const float* __restrict__ pr,
    const float* __restrict__ w, const float* __restrict__ b,
    const int* __restrict__ senders, const int* __restrict__ rowptr,
    const float* __restrict__ g, float* __restrict__ d_src,
    float* __restrict__ d_pr, float* __restrict__ partial, int n_nodes,
    int n_edges) {
  using L = Layout;
  using namespace tf32x3;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem + L::w;
  float* s_z1 = smem + L::s;
  float* s_h1 = smem + L::r;
  float* s_d2 = smem + L::d2;
  int* s_snd = reinterpret_cast<int*>(smem + L::snd);
  int* s_rcv = reinterpret_cast<int*>(smem + L::rcv);
  const Swz w_rows{s_w, false}, w_cols{s_w, true};  // W and W^T
  const Swz h1_rows{s_h1, false}, h1_cols{s_h1, true};
  const Swz d2_rows{s_d2, false};

  const int tid = threadIdx.x, warp = tid >> 5;
  for (int k = tid; k < kH * kH / 4; k += kThreads)
    *reinterpret_cast<float4*>(s_w + swz_at(k >> 5, (k & 31) * 4)) =
        __ldg(reinterpret_cast<const float4*>(w) + k);

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
    s_snd[buf * kTE + tid] = !valid ? 0 : GATHER ? senders[base + tid]
                                                 : base + tid;
    s_rcv[buf * kTE + tid] = valid ? rv : 0;
  };
  // the sender rows (into z1's buffer) or the receiver rows (into h1's) of
  // tile `tile`, whose indices are in buffer `buf`; one committed group
  auto gather = [&](float* dst, const float* table, const int* idx,
                    int tile) {
    const int n_valid = min(kTE, n_edges - tile * kTE);
    rows_async<kTE>(dst, 0, table, [&](int r) {
      return r < n_valid ? table + (size_t)idx[r] * kH : nullptr;
    });
    cp_async_commit();
  };

  // the thread's part of dW (rows 32 (w & 3) + ..., columns 64 (w >> 2) +
  // ...) and, threads < kH, db[tid], over all its tiles
  float acc_w[2][8][4] = {};
  float acc_b = 0.f;

  if (t_beg < t_end) {
    if (warp == 0) indices(t_beg, 0, -1);
    __syncthreads();
    gather(s_z1, src, s_snd, t_beg);
    gather(s_h1, pr, s_rcv, t_beg);
  }
  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const int base = tile * kTE;
    const int n_valid = min(kTE, n_edges - base);
    const int* snd = s_snd + cur * kTE;
    const int* rcv = s_rcv + cur * kTE;
    const bool more = tile + 1 < t_end;
    if (more && warp == 0) indices(tile + 1, nxt, rcv[n_valid - 1]);
    cp_async_wait<0>();
    __syncthreads();

    // z1 = send + pr[i] and h1 = swish(z1) (zero rows stay zero)
    for (int k = tid; k < kTE * kH; k += kThreads) {
      const int o = swz_at(k >> 7, k & (kH - 1));
      const float z = s_z1[o] + s_h1[o];
      s_z1[o] = z;
      s_h1[o] = z * sigmoidf(z);
    }
    __syncthreads();

    // z2 = h1 . W + b, stored as d_z2 = g[i] * swish'(z2)
    {
      float acc[2][2][4];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float bias = __ldg(b + acc_col(16 * warp + 8 * ni, c));
          acc[0][ni][c] = bias;
          acc[1][ni][c] = bias;
        }
      mm_rows32<kH>(acc, h1_rows, w_rows);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int e = acc_row(16 * mi, c);
            const int n = acc_col(16 * warp + 8 * ni, c);
            const float gv =
                e < n_valid ? __ldg(g + (size_t)rcv[e] * kH + n) : 0.f;
            s_d2[swz_at(e, n)] = gv * dswish(acc[mi][ni][c]);
          }
    }
    __syncthreads();

    // dW += h1^T . d_z2 and db += sum d_z2
    mm_square128<kTE>(acc_w, h1_cols, d2_rows);
    if (tid < kH)
      for (int e = 0; e < kTE; ++e) acc_b += s_d2[swz_at(e, tid)];
    __syncthreads();  // h1 read for the last time
    if (more) gather(s_h1, pr, s_rcv + nxt * kTE, tile + 1);

    // d_h1 = d_z2 . W^T, and d_z1 = d_h1 * swish'(z1) over z1 in place
    // (each element is read and written by one thread)
    {
      float acc[2][2][4] = {};
      mm_rows32<kH>(acc, d2_rows, w_cols);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int o = swz_at(acc_row(16 * mi, c),
                                 acc_col(16 * warp + 8 * ni, c));
            s_z1[o] = acc[mi][ni][c] * dswish(s_z1[o]);
          }
    }
    __syncthreads();

    // scatter d_z1: the sender side, then the receiver side
    if (GATHER) {
      for (int k = tid; k < n_valid * kH; k += kThreads) {
        const int e = k >> 7, n = k & (kH - 1);
        atomicAdd(d_src + (size_t)snd[e] * kH + n, s_z1[swz_at(e, n)]);
      }
    } else {
      for (int k = tid; k < n_valid * kH / 4; k += kThreads) {
        const int e = k >> 5, c = (k & 31) * 4;
        *reinterpret_cast<float4*>(d_src + (size_t)(base + e) * kH + c) =
            *reinterpret_cast<const float4*>(s_z1 + swz_at(e, c));
      }
    }
    {
      constexpr int kHalf = kTE / 2;
      const int n = tid & (kH - 1);
      const int e_beg = (tid >> 7) * kHalf;
      const int e_end = min(e_beg + kHalf, n_valid);
      if (e_beg < e_end) {
        int at = rcv[e_beg];
        float s = 0.f;
        for (int e = e_beg; e < e_end; ++e) {
          if (rcv[e] != at) {
            atomicAdd(d_pr + (size_t)at * kH + n, s);
            s = 0.f;
            at = rcv[e];
          }
          s += s_z1[swz_at(e, n)];
        }
        atomicAdd(d_pr + (size_t)at * kH + n, s);
      }
    }
    __syncthreads();  // d_z1 read for the last time
    if (more) gather(s_z1, src, s_snd + nxt * kTE, tile + 1);
  }
  cp_async_wait<0>();

  // this block's partial dW and db, in the packed layout
  float* p = partial + (size_t)blockIdx.x * L::g_total;
  const int m0 = 32 * (warp & 3), n0 = 64 * (warp >> 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p[acc_row(m0 + 16 * mi, c) * kH + acc_col(n0 + 8 * ni, c)] =
            acc_w[mi][ni][c];
  if (tid < kH) p[kH * kH + tid] = acc_b;
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

constexpr int kMaxDevices = 64;

// The persistent grid's size (SMs x resident blocks per SM) on the current
// device.  The shared-memory opt-in and the device queries run once per
// device and instantiation; later launches read the cache.
template <bool GATHER>
cudaError_t grid_cap(size_t smem_bytes, int* cap) {
  static std::atomic<int> cache[kMaxDevices];  // 0: unset
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && (*cap = cache[device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  auto kernel = fused_mpnn_edge_agg_bwd_kernel<GATHER>;
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

template <bool GATHER>
int launch(const float* src, const float* pr, const float* w, const float* b,
           const int* senders, const int* rowptr, const float* g,
           float* d_src, float* d_pr, float* wgrad, float* partial,
           int n_nodes, int n_edges, int scratch_blocks,
           cudaStream_t stream) {
  using L = Layout;
  const size_t smem_bytes = sizeof(float) * (size_t)L::smem_floats;
  int cap = 0;
  const cudaError_t err = grid_cap<GATHER>(smem_bytes, &cap);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  int blocks = n_tiles < cap ? n_tiles : cap;
  if (blocks > scratch_blocks) blocks = scratch_blocks;
  if (n_tiles > 0 && blocks < 1) return (int)cudaErrorInvalidValue;
  if (n_nodes == 0) blocks = 0;
  if (blocks > 0) {
    fused_mpnn_edge_agg_bwd_kernel<GATHER>
        <<<blocks, kThreads, smem_bytes, stream>>>(
            src, pr, w, b, senders, rowptr, g, d_src, d_pr, partial, n_nodes,
            n_edges);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return (int)launched;
  }
  reduce_partials_kernel<<<(L::g_total + 255) / 256, 256, 0, stream>>>(
      partial, wgrad, blocks, L::g_total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success.  Launches on `stream` and does not
// synchronise.  gather != 0: src is pxj (n_nodes, h), senders (E,) is read
// and d_src is d_pxj (n_nodes, h), which must arrive zeroed; gather == 0:
// src is h0 (E, h), senders is ignored and d_src is d_h0 (E, h), written
// whole.  d_pr (n_nodes, h) must arrive zeroed; wgrad holds, packed, dW
// (h, h) then db (h); partial is scratch for scratch_blocks x (h*h + h)
// floats.  Every float array is 16-byte aligned.  Compiled for h = 128;
// others return cudaErrorInvalidValue.
int fused_mpnn_edge_agg_bwd_f32(const float* src, const float* pr,
                                const float* w, const float* b,
                                const int* senders, const int* rowptr,
                                const float* g, float* d_src, float* d_pr,
                                float* wgrad, float* partial, int n_nodes,
                                int n_edges, int h, int gather,
                                int scratch_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h != kH) return (int)cudaErrorInvalidValue;
  if (gather) {
    if (senders == nullptr) return (int)cudaErrorInvalidValue;
    return launch<true>(src, pr, w, b, senders, rowptr, g, d_src, d_pr,
                        wgrad, partial, n_nodes, n_edges, scratch_blocks, s);
  }
  return launch<false>(src, pr, w, b, senders, rowptr, g, d_src, d_pr, wgrad,
                       partial, n_nodes, n_edges, scratch_blocks, s);
}

}  // extern "C"
