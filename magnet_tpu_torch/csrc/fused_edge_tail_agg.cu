// Fused InteractionNetwork edge pipeline, forward, f32, two entries.
//
// fold (FOLD = true) replaces the TPU kernel
// magnet_tpu/ops/pallas_kernels.py:_fused2r_fwd_pallas as called with
// we/be (fold-e, public entry fused_edge_tail_agg2rf; the oracle is
// _fused2re_ref_impl + _fused2_ref_impl + _tail_ref); pregathered
// (FOLD = false) replaces _fused_fwd_pallas (public entry
// fused_edge_tail_agg; the oracle is _fused_ref_impl), whose first-layer
// input h0 = pxj[j] + W_e . e + b_e the caller has formed per edge.
// Math:
//
//   for every edge j -> i of a receiver-grouped CSR graph
//     z   = e0[e] . W_e + b_e + pxj[j] + pxi[i]     (fold)
//     z   = h0[e] + pxi[i]                          (pregathered)
//     h   = relu(z);  h = relu(h . W_k + b_k)   for k < L1
//     y   = h . W_out + b_out
//     y   = LayerNorm(y)      (two-pass f32 variance, eps 1e-5, affine)
//   out[i] = sum of y over the edges of i          (N, C) f32
//
// The mean over the degree is taken by the caller.  A receiver of degree 0
// gets a zero row; every edge range is clamped to the E rows given.
//
// Design.  Hopper gathers natively, so none of the TPU's one-hot gather
// matmuls, sender-tile windows or live-chunk lists carry over:
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
//
// What bounds it on an H100: at the slice's shapes (E ~ 186.6k edges,
// Ce = 32, H = 64, L1 = 3, C = 32) one launch does E * 16,384
// multiply-adds ~ 6.1 GFLOP on the f32 CUDA cores, against ~25 MB of
// input (mostly e0), so it is bound by operations, not bytes.  The
// pregathered entry skips the (Ce x H) product (14,336 multiply-adds per
// edge remain) but reads an (E, H) h0 instead of e0, twice the bytes; at the
// MAgNet[CNN] 2D training shape (E ~ 299.8k) that is ~77 MB against
// 8.6 GFLOP, still bound by operations.  Each
// float4 weight load feeds four FMAs of a lane, so the shared-memory pipe
// and the FMA pipe are both near their limit; wgmma/TMA are left for a
// later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (magnet_tpu_torch/ops/cuda_build.py does this).

#include <cuda_runtime.h>

#include <atomic>

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

// Offsets, in floats, of the weights in dynamic shared memory; the
// pregathered entry has no W_e and no b_e.
template <int CE, int H, int C, bool FOLD>
struct Smem {
  static constexpr int we = 0;                     // (CE, H)
  static constexpr int wo = we + (FOLD ? CE * H : 0);  // (H, C)
  static constexpr int be = wo + H * C;            // (H,)
  static constexpr int bo = be + (FOLD ? H : 0);   // (C,)
  static constexpr int ls = bo + C;                // (C,)
  static constexpr int lb = ls + C;                // (C,)
  static constexpr int wr = lb + C;                // (L1, H, H), then (L1, H)
  static size_t bytes(int l1) {
    return sizeof(float) * (size_t)(wr + l1 * (H * H + H));
  }
};

template <int CE, int H, int C, bool FOLD>
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
  using S = Smem<CE, H, C, FOLD>;
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
  if (FOLD) {
    copy_to_smem(s_we, we, CE * H);
    copy_to_smem(s_be, be, H);
  }
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
        if (FOLD) {
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
        } else {
          // z = h0[e] + pxi[receiver]
          const float4* ph =
              reinterpret_cast<const float4*>(src + (size_t)e * H);
#pragma unroll
          for (int q = 0; q < H / 4; ++q) {
            const float4 a = __ldg(ph + q), b = __ldg(pi + q);
            h[4 * q + 0] = a.x + b.x;
            h[4 * q + 1] = a.y + b.y;
            h[4 * q + 2] = a.z + b.z;
            h[4 * q + 3] = a.w + b.w;
          }
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

// The persistent grid's size (SMs x resident blocks per SM) for `l1` tail
// layers on the current device.  The device queries, the occupancy query
// and the shared-memory opt-in run once per (device, l1) and entry; later
// launches only read the cache.  The opt-in is always the device's
// maximum, so a later call for a smaller l1 never lowers it below what a
// larger one needs.
template <int CE, int H, int C, bool FOLD>
cudaError_t grid_cap(int l1, size_t smem, int* cap) {
  static std::atomic<int> cache[kMaxDevices][kMaxCachedL1 + 1];  // 0: unset
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices && l1 <= kMaxCachedL1;
  if (cached && (*cap = cache[device][l1].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  auto kernel = fused_edge_tail_agg_kernel<CE, H, C, FOLD>;
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
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *cap = n_sm * per_sm;
  if (cached) cache[device][l1].store(*cap, std::memory_order_relaxed);
  return cudaSuccess;
}

template <int CE, int H, int C, bool FOLD>
int launch(const float* src, const float* we, const float* be,
           const float* pxj, const float* pxi, const int* senders,
           const int* rowptr, const float* w_rest, const float* b_rest,
           const float* w_out, const float* b_out, const float* ln_s,
           const float* ln_b, float* out, int n_nodes, int n_edges, int l1,
           cudaStream_t stream) {
  const size_t smem = Smem<CE, H, C, FOLD>::bytes(l1);
  int cap = 0;
  const cudaError_t err = grid_cap<CE, H, C, FOLD>(l1, smem, &cap);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes == 0) return (int)cudaSuccess;
  int blocks = (n_nodes + kWarps - 1) / kWarps;
  if (blocks > cap) blocks = cap;
  fused_edge_tail_agg_kernel<CE, H, C, FOLD>
      <<<blocks, kThreads, smem, stream>>>(src, we, be, pxj, pxi, senders,
                                           rowptr, w_rest, b_rest, w_out,
                                           b_out, ln_s, ln_b, out, n_nodes,
                                           n_edges, l1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success.  Launches on `stream` and does not
// synchronise.  fold != 0: src is e0 (n_edges, ce), and we, be, pxj and
// senders are read; fold == 0: src is h0 (n_edges, h), and those four are
// ignored (they may be null).  Compiled widths (ce, h, c): (32, 64, 32),
// the magnet_cnn configs'; others return cudaErrorInvalidValue.
int fused_edge_tail_agg_f32(const float* src, const float* we, const float* be,
                            const float* pxj, const float* pxi,
                            const int* senders, const int* rowptr,
                            const float* w_rest, const float* b_rest,
                            const float* w_out, const float* b_out,
                            const float* ln_s, const float* ln_b, float* out,
                            int n_nodes, int n_edges, int ce, int h, int c,
                            int l1, int fold, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ce != 32 || h != 64 || c != 32) return (int)cudaErrorInvalidValue;
  if (fold) {
    if (we == nullptr || be == nullptr || pxj == nullptr || senders == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch<32, 64, 32, true>(src, we, be, pxj, pxi, senders, rowptr,
                                    w_rest, b_rest, w_out, b_out, ln_s, ln_b,
                                    out, n_nodes, n_edges, l1, s);
  }
  return launch<32, 64, 32, false>(src, we, be, pxj, pxi, senders, rowptr,
                                   w_rest, b_rest, w_out, b_out, ln_s, ln_b,
                                   out, n_nodes, n_edges, l1, s);
}

}  // extern "C"
