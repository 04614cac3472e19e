// Fused MPNN message path, forward, f32.
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
// receiver of degree 0 gets a zero row.
//
// Design.  Hopper gathers natively, so none of the TPU's one-hot gather
// matmuls, 128-row tiles, sender-tile windows or live-chunk lists carry
// over:
//   * W (H x H, 64 KB at H = 128) and b sit in dynamic shared memory, loaded
//     once per block of a persistent grid;
//   * one warp owns one receiver at a time; lane k runs edge rowptr[i] + k
//     (a loop of 32-edge rounds covers any degree);
//   * a lane keeps its edge's h1 (H floats) in registers and forms z2 in
//     chunks of 32 output columns (H + 32 live floats, not 2 H), reading
//     each weight row as float4 broadcasts from shared memory, so no (E, H)
//     activation reaches device memory;
//   * the receiver sum is a warp butterfly over the lanes, with no atomics,
//     since CSR keeps a receiver's edges together; lane q keeps column
//     32 c + q of chunk c.
//
// What bounds it on an H100: H * H = 16,384 multiply-adds per edge on the
// f32 CUDA cores (2 E H^2 FLOP) against pxj and pr read once (GATHER) or h0
// read once: bound by operations for the gather entry at every degree above
// ~1, and for the pre-gathered entry too (512 B per edge at 3.35 TB/s is
// 0.15 ns, the product 0.49 ns at 67 TFLOP/s).  Each float4 weight load
// feeds four FMAs of a lane, so the shared-memory pipe and the FMA pipe are
// both near their limit; wgmma/TMA are left for a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (magnet_tpu_torch/ops/cuda_build.py does this).

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;  // output columns formed at a time

__device__ __forceinline__ float swish(float z) {
  return z / (1.f + expf(-z));
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

template <int H, bool GATHER>
__global__ void __launch_bounds__(kThreads)
fused_mpnn_edge_agg_kernel(const float* __restrict__ src,
                           const float* __restrict__ pr,
                           const float* __restrict__ w,
                           const float* __restrict__ b,
                           const int* __restrict__ senders,
                           const int* __restrict__ rowptr,
                           float* __restrict__ out, int n_nodes,
                           int n_edges) {
  static_assert(H % kChunk == 0, "H must be a multiple of 32");
  constexpr int NC = H / kChunk;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // (H, H)
  float* s_b = s_w + H * H;                      // (H,)
  for (int k = threadIdx.x; k < H * H; k += kThreads) s_w[k] = w[k];
  for (int k = threadIdx.x; k < H; k += kThreads) s_b[k] = b[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  for (int i = blockIdx.x * kWarps + (threadIdx.x >> 5); i < n_nodes;
       i += n_warps) {
    // rowptr is trusted to be a CSR; the clamp keeps every read inside the
    // E rows that src (or senders) has, whatever rowptr says
    const int beg = rowptr[i];
    const int end = min(rowptr[i + 1], n_edges);
    float sum[NC];  // this lane's column of every chunk
#pragma unroll
    for (int c = 0; c < NC; ++c) sum[c] = 0.f;

    for (int base = beg; base < end; base += 32) {
      const int e = base + lane;
      const bool valid = e < end;
      float h1[H];
      if (valid) {
        const size_t row = GATHER ? (size_t)senders[e] : (size_t)e;
        const float4* ps = reinterpret_cast<const float4*>(src + row * H);
        const float4* pi = reinterpret_cast<const float4*>(pr + (size_t)i * H);
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const float4 a = __ldg(ps + q), r = __ldg(pi + q);
          h1[4 * q + 0] = swish(a.x + r.x);
          h1[4 * q + 1] = swish(a.y + r.y);
          h1[4 * q + 2] = swish(a.z + r.z);
          h1[4 * q + 3] = swish(a.w + r.w);
        }
      } else {
#pragma unroll
        for (int k = 0; k < H; ++k) h1[k] = 0.f;
      }
#pragma unroll 1
      for (int c = 0; c < NC; ++c) {
        float z2[kChunk];
#pragma unroll
        for (int q = 0; q < kChunk; ++q) z2[q] = s_b[c * kChunk + q];
#pragma unroll
        for (int k = 0; k < H; ++k)
          axpy_row<kChunk>(z2, h1[k], s_w + k * H + c * kChunk);
        // receiver sum over the 32 lanes of this round
        float mine = 0.f;
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
          float v = valid ? swish(z2[q]) : 0.f;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (q == lane) mine = v;
        }
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          if (cc == c) sum[cc] += mine;
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      out[(size_t)i * H + c * kChunk + lane] = sum[c];
  }
}

constexpr int kMaxDevices = 64;

// The persistent grid's size (SMs x resident blocks per SM) on the current
// device.  The shared-memory opt-in and the device queries run once per
// device and instantiation; later launches read the cache.
template <int H, bool GATHER>
cudaError_t grid_cap(size_t smem, int* cap) {
  static std::atomic<int> cache[kMaxDevices];  // 0: unset
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && (*cap = cache[device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  auto kernel = fused_mpnn_edge_agg_kernel<H, GATHER>;
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

template <int H, bool GATHER>
int launch(const float* src, const float* pr, const float* w, const float* b,
           const int* senders, const int* rowptr, float* out, int n_nodes,
           int n_edges, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(H * H + H);
  int cap = 0;
  const cudaError_t err = grid_cap<H, GATHER>(smem, &cap);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes == 0) return (int)cudaSuccess;
  int blocks = (n_nodes + kWarps - 1) / kWarps;
  if (blocks > cap) blocks = cap;
  fused_mpnn_edge_agg_kernel<H, GATHER><<<blocks, kThreads, smem, stream>>>(
      src, pr, w, b, senders, rowptr, out, n_nodes, n_edges);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success.  Launches on `stream` and does not
// synchronise.  gather != 0: src is pxj (n_nodes, h) and senders (n_edges,)
// is read; gather == 0: src is h0 (n_edges, h) and senders is ignored.
// Compiled for h = 128; other widths return cudaErrorInvalidValue.
int fused_mpnn_edge_agg_f32(const float* src, const float* pr, const float* w,
                            const float* b, const int* senders,
                            const int* rowptr, float* out, int n_nodes,
                            int n_edges, int h, int gather, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h != 128) return (int)cudaErrorInvalidValue;
  if (gather) {
    if (senders == nullptr) return (int)cudaErrorInvalidValue;
    return launch<128, true>(src, pr, w, b, senders, rowptr, out, n_nodes,
                             n_edges, s);
  }
  return launch<128, false>(src, pr, w, b, senders, rowptr, out, n_nodes,
                            n_edges, s);
}

}  // extern "C"
