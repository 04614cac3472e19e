// Fused MPNN message path, backward by recompute, f32.
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
// Design (that of fused_edge_tail_agg_bwd.cu, at twice its width):
//   * a block of 256 threads (16 x 16) owns a tile of 64 consecutive CSR
//     edges; tiles need not align with receivers, each edge finds its
//     receiver by a binary search in rowptr;
//   * W (129-float rows) and three tile buffers, z1 (then d_z1 in place),
//     h1 and d_z2 (64 x 129 each), live in ~166 KB of dynamic shared
//     memory: one block per SM;
//   * the three products (recompute, data gradient, weight gradient) are
//     register tiles of 4 x 8 (8 x 8 for dW) per thread, from tile_mm.cuh;
//   * each thread keeps its 8 x 8 patch of dW and its 8 sums of db in
//     registers across all tiles of its persistent block; a block writes
//     its partial once and a second small kernel adds the blocks' partials
//     in a fixed order, so dW and db are the same from run to run;
//   * d_pxj is scattered over senders with f32 atomicAdd into a zeroed
//     buffer; d_pr is summed over each run of equal receivers inside half a
//     tile and added with one atomicAdd per run.  Both therefore differ in
//     the last bits from run to run.  On a graph where a few senders serve
//     most receivers (the lowest-index neighbour cap on a regular 2D grid)
//     the d_pxj atomics of many blocks meet on the same rows.
//
// What bounds it on an H100: recompute, data gradient and weight gradient
// are each H * H multiply-adds per edge, 6 E H^2 FLOP on the f32 CUDA
// cores, against node tables read once and written once (GATHER) or h0
// read and d_h0 written once: bound by operations.  Each product step
// makes 12 (16 for dW) shared-memory loads for 32 (64) FMAs, so the
// shared-memory pipe is the limit of this first version; wgmma is left for
// later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (magnet_tpu_torch/ops/cuda_build.py does this).

#include <cuda_runtime.h>

#include <atomic>

#include "tile_mm.cuh"

namespace {

using namespace tile_mm;  // kTE, kThreads, kRows, mm_fwd, mm_bwd_data, mm_bwd_w

__device__ __forceinline__ float sigmoidf(float z) {
  return 1.f / (1.f + expf(-z));
}

__device__ __forceinline__ float dswish(float z) {
  const float s = sigmoidf(z);
  return s * (1.f + z * (1.f - s));
}

// Offsets, in floats, into dynamic shared memory.
template <int H>
struct Layout {
  static constexpr int ld = H + 1;
  static constexpr int w = 0;                  // (H, ld)
  static constexpr int b = w + H * ld;         // (H)
  static constexpr int z1 = b + H;             // (kTE, ld) z1, then d_z1
  static constexpr int h1 = z1 + kTE * ld;     // (kTE, ld)
  static constexpr int d2 = h1 + kTE * ld;     // (kTE, ld) d_z2
  static constexpr int snd = d2 + kTE * ld;    // (kTE) int
  static constexpr int rcv = snd + kTE;        // (kTE) int
  static constexpr int smem_floats = rcv + kTE;
  static constexpr int g_total = H * H + H;    // packed dW (H, H), db (H)
};

template <int H, bool GATHER>
__global__ void __launch_bounds__(kThreads, 1)
fused_mpnn_edge_agg_bwd_kernel(
    const float* __restrict__ src, const float* __restrict__ pr,
    const float* __restrict__ w, const float* __restrict__ b,
    const int* __restrict__ senders, const int* __restrict__ rowptr,
    const float* __restrict__ g, float* __restrict__ d_src,
    float* __restrict__ d_pr, float* __restrict__ partial, int n_nodes,
    int n_edges) {
  using L = Layout<H>;
  static_assert(H % 16 == 0, "H must be a multiple of 16 (16 x 16 threads)");
  static_assert(kThreads % H == 0 && kTE % (kThreads / H) == 0,
                "d_pr phase: one column per thread, equal edge ranges");
  constexpr int ld = L::ld;
  constexpr int NJ = H / 16;

  extern __shared__ float smem[];
  float* s_w = smem + L::w;
  float* s_b = smem + L::b;
  float* s_z1 = smem + L::z1;
  float* s_h1 = smem + L::h1;
  float* s_d2 = smem + L::d2;
  int* s_snd = reinterpret_cast<int*>(smem + L::snd);
  int* s_rcv = reinterpret_cast<int*>(smem + L::rcv);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  for (int k = tid; k < H * H; k += kThreads) s_w[(k / H) * ld + k % H] = w[k];
  for (int k = tid; k < H; k += kThreads) s_b[k] = b[k];
  __syncthreads();

  // the thread's patch of dW and its sums of db, over all its tiles
  float acc_w[NJ][NJ], acc_b[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    acc_b[j] = 0.f;
#pragma unroll
    for (int i = 0; i < NJ; ++i) acc_w[i][j] = 0.f;
  }

  const int n_tiles = (n_edges + kTE - 1) / kTE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kTE;
    const int n_valid = min(kTE, n_edges - base);

    // the tile's sender rows and receivers; rows past the end are zero
    if (tid < kTE) {
      int sv = 0, rv = 0;
      if (tid < n_valid) {
        const int e = base + tid;
        sv = GATHER ? senders[e] : e;
        int lo = 0, hi = n_nodes;  // rowptr[lo] <= e < rowptr[hi]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (rowptr[mid] <= e) lo = mid; else hi = mid;
        }
        rv = lo;
      }
      s_snd[tid] = sv;
      s_rcv[tid] = rv;
    }
    __syncthreads();

    // recompute z1 = send + pr[i] and h1 = swish(z1)
    for (int k = tid; k < kTE * H; k += kThreads) {
      const int r = k / H, c = k % H;
      float z = 0.f;
      if (r < n_valid)
        z = src[(size_t)s_snd[r] * H + c] + pr[(size_t)s_rcv[r] * H + c];
      s_z1[r * ld + c] = z;
      s_h1[r * ld + c] = z * sigmoidf(z);
    }
    __syncthreads();

    // z2 = h1 . W + b, stored as d_z2 = g[i] * swish'(z2)
    mm_fwd<H, H, false>(
        s_h1, ld, s_w, ld, [&](int, int n) { return s_b[n]; },
        [&](int e, int n, float v) {
          const float gv = e < n_valid ? g[(size_t)s_rcv[e] * H + n] : 0.f;
          s_d2[e * ld + n] = gv * dswish(v);
        },
        tx, ty);
    __syncthreads();

    // dW += h1^T . d_z2, db += sum d_z2; d_z1 = (d_z2 . W^T) * swish'(z1),
    // in place over z1 (each element is read and written by one thread)
    mm_bwd_w<H, H>(s_h1, ld, s_d2, ld, acc_w, acc_b, tx, ty);
    mm_bwd_data<H, H>(
        s_d2, ld, s_w, ld,
        [&](int e, int k, float v) {
          s_z1[e * ld + k] = v * dswish(s_z1[e * ld + k]);
        },
        tx, ty);
    __syncthreads();

    // scatter d_z1: the sender side, then the receiver side
    if (GATHER) {
      for (int k = tid; k < n_valid * H; k += kThreads) {
        const int e = k / H, n = k % H;
        atomicAdd(d_src + (size_t)s_snd[e] * H + n, s_z1[e * ld + n]);
      }
    } else {
      for (int k = tid; k < n_valid * H; k += kThreads) {
        const int e = k / H, n = k % H;
        d_src[(size_t)(base + e) * H + n] = s_z1[e * ld + n];
      }
    }
    {
      constexpr int kPart = kTE / (kThreads / H);
      const int n = tid % H;
      const int e_beg = (tid / H) * kPart;
      const int e_end = min(e_beg + kPart, n_valid);
      if (e_beg < e_end) {
        int cur = s_rcv[e_beg];
        float s = 0.f;
        for (int e = e_beg; e < e_end; ++e) {
          const int r = s_rcv[e];
          if (r != cur) {
            atomicAdd(d_pr + (size_t)cur * H + n, s);
            s = 0.f;
            cur = r;
          }
          s += s_z1[e * ld + n];
        }
        atomicAdd(d_pr + (size_t)cur * H + n, s);
      }
    }
    __syncthreads();
  }

  // this block's partial dW and db, in the packed layout
  float* p = partial + (size_t)blockIdx.x * L::g_total;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = tx + 16 * j;
#pragma unroll
    for (int i = 0; i < NJ; ++i) p[(ty + 16 * i) * H + n] = acc_w[i][j];
    if (ty == 0) p[H * H + n] = acc_b[j];
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

constexpr int kMaxDevices = 64;

// The persistent grid's size (SMs x resident blocks per SM) on the current
// device.  The shared-memory opt-in and the device queries run once per
// device and instantiation; later launches read the cache.
template <int H, bool GATHER>
cudaError_t grid_cap(size_t smem_bytes, int* cap) {
  static std::atomic<int> cache[kMaxDevices];  // 0: unset
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && (*cap = cache[device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  auto kernel = fused_mpnn_edge_agg_bwd_kernel<H, GATHER>;
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

template <int H, bool GATHER>
int launch(const float* src, const float* pr, const float* w, const float* b,
           const int* senders, const int* rowptr, const float* g,
           float* d_src, float* d_pr, float* wgrad, float* partial,
           int n_nodes, int n_edges, int scratch_blocks,
           cudaStream_t stream) {
  using L = Layout<H>;
  const size_t smem_bytes = sizeof(float) * (size_t)L::smem_floats;
  int cap = 0;
  const cudaError_t err = grid_cap<H, GATHER>(smem_bytes, &cap);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  int blocks = n_tiles < cap ? n_tiles : cap;
  if (blocks > scratch_blocks) blocks = scratch_blocks;
  if (n_tiles > 0 && blocks < 1) return (int)cudaErrorInvalidValue;
  if (n_nodes == 0) blocks = 0;
  if (blocks > 0) {
    fused_mpnn_edge_agg_bwd_kernel<H, GATHER>
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
// floats.  Compiled for h = 128; others return cudaErrorInvalidValue.
int fused_mpnn_edge_agg_bwd_f32(const float* src, const float* pr,
                                const float* w, const float* b,
                                const int* senders, const int* rowptr,
                                const float* g, float* d_src, float* d_pr,
                                float* wgrad, float* partial, int n_nodes,
                                int n_edges, int h, int gather,
                                int scratch_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h != 128) return (int)cudaErrorInvalidValue;
  if (gather) {
    if (senders == nullptr) return (int)cudaErrorInvalidValue;
    return launch<128, true>(src, pr, w, b, senders, rowptr, g, d_src, d_pr,
                             wgrad, partial, n_nodes, n_edges, scratch_blocks,
                             s);
  }
  return launch<128, false>(src, pr, w, b, senders, rowptr, g, d_src, d_pr,
                            wgrad, partial, n_nodes, n_edges, scratch_blocks,
                            s);
}

}  // extern "C"
