// Segment sum over a CSR, f32:
//
//   out[s] = sum over k = ptr[s] .. ptr[s+1]-1 of x[perm[k]]   (S, C)
//
// (x[k] where perm is null).  Replaces the TPU kernel
// magnet_tpu/ops/pallas_kernels.py:_pallas_impl (public entry
// blocked_segment_sum), whose one-hot matmul sums the edge rows of a
// 128-row receiver tile into its receiver slots; through
// magnet_tpu/ops/segment.py:_transpose_sum_by_sender it is also the
// backward of the sender gather (gather_sender), which is its main use in
// the port: ptr and perm are then the graph's sender CSR (the edges stably
// sorted by sender) and x the cotangent of the gathered (E, H) rows, so
// out = d_pxj.  The oracle is _einsum_impl (a masked sum per receiver).
//
// Design.  Hopper gathers natively, so none of the TPU's tiles or one-hot
// products carry over.  One warp owns one segment; lane l holds columns
// l, l + 32, ... (NJ registers, C <= 32 NJ), so each row read is a
// coalesced 128-byte run per 32 columns.  The warp walks its segment in
// order, four rows' loads in flight at a time, and adds them in index
// order: the sum has a fixed order, no atomics, and two launches give the
// same bits.  A segment of any length (an out-degree of 45 or 77) is one
// warp's loop.  Every row index is clamped to the n_items given.
//
// What bounds it on an H100: each input row is read once and each output
// row written once (~87 MB at the MAgNet[CNN] 2D training shape: 299.8k
// rows of 64 floats in, 33.8k rows out), against one add per element:
// bound by bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (magnet_tpu_torch/ops/cuda_build.py does this).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;

template <int NJ>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ x, const int* __restrict__ ptr,
                   const int* __restrict__ perm, float* __restrict__ out,
                   int n_seg, int n_items, int c) {
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= n_seg) return;
  const int beg = min(ptr[seg], n_items);
  const int end = min(ptr[seg + 1], n_items);
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  int k = beg;
  for (; k + kUnroll <= end; k += kUnroll) {
    float v[kUnroll][NJ];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const size_t row = perm ? (size_t)__ldg(perm + k + q) : (size_t)(k + q);
      const float* xr = x + row * c;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = lane + 32 * j;
        v[q][j] = col < c ? __ldg(xr + col) : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] += v[q][j];
  }
  for (; k < end; ++k) {
    const size_t row = perm ? (size_t)__ldg(perm + k) : (size_t)k;
    const float* xr = x + row * c;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      if (col < c) acc[j] += __ldg(xr + col);
    }
  }
  float* o = out + (size_t)seg * c;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = lane + 32 * j;
    if (col < c) o[col] = acc[j];
  }
}

template <int NJ>
int launch(const float* x, const int* ptr, const int* perm, float* out,
           int n_seg, int n_items, int c, cudaStream_t stream) {
  if (n_seg == 0) return (int)cudaSuccess;
  const int blocks = (n_seg + kWarps - 1) / kWarps;
  segment_sum_kernel<NJ><<<blocks, kThreads, 0, stream>>>(x, ptr, perm, out,
                                                          n_seg, n_items, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success.  Launches on `stream` and does not
// synchronise.  x is (rows, c) with every perm entry (or, with perm null,
// every k < n_items) a row of x; ptr is (n_seg + 1); out is (n_seg, c) and
// every row of it is written.  c in 1..256; others return
// cudaErrorInvalidValue.
int segment_sum_f32(const float* x, const int* ptr, const int* perm,
                    float* out, int n_seg, int n_items, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((c + 31) / 32) {
    case 1: return launch<1>(x, ptr, perm, out, n_seg, n_items, c, s);
    case 2: return launch<2>(x, ptr, perm, out, n_seg, n_items, c, s);
    case 3: return launch<3>(x, ptr, perm, out, n_seg, n_items, c, s);
    case 4: return launch<4>(x, ptr, perm, out, n_seg, n_items, c, s);
    case 5: return launch<5>(x, ptr, perm, out, n_seg, n_items, c, s);
    case 6: return launch<6>(x, ptr, perm, out, n_seg, n_items, c, s);
    case 7: return launch<7>(x, ptr, perm, out, n_seg, n_items, c, s);
    case 8: return launch<8>(x, ptr, perm, out, n_seg, n_items, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
