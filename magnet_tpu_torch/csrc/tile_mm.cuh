// Register-tiled products over shared memory for the backward kernels.
//
// A block of kThreads = 256 threads, seen as a 16 x 16 grid (tx = tid & 15,
// ty = tid >> 4), owns a tile of kTE = 64 edges.  Every operand lives in
// shared memory with a leading dimension of (width + 1) floats, so that row
// reads and column reads are both free of bank conflicts with scalar loads.
// Each thread computes a kRows x (N / 16) register tile of a product.
#pragma once

namespace tile_mm {

constexpr int kTE = 64;          // edges per tile
constexpr int kThreads = 256;    // tx = tid & 15, ty = tid >> 4
constexpr int kRows = kTE / 16;  // tile rows per thread

// out(e, n) <- act(init(e, n) + sum_k A[e][k] * W[k][n]) for the thread's
// rows e = ty + 16 i and columns n = tx + 16 j.
template <int K, int N, bool RELU, class Init, class Store>
__device__ __forceinline__ void mm_fwd(const float* __restrict__ A, int lda,
                                       const float* __restrict__ W, int ldw,
                                       Init init, Store store, int tx,
                                       int ty) {
  constexpr int NJ = N / 16;
  float acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = init(ty + 16 * i, tx + 16 * j);
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float a[kRows], w[NJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) w[j] = W[k * ldw + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      store(ty + 16 * i, tx + 16 * j,
            RELU ? fmaxf(acc[i][j], 0.f) : acc[i][j]);
}

// store(e, k, sum_n DA[e][n] * W[k][n]) for rows e = ty + 16 i and
// k = tx + 16 j: the product with the transposed weight.
template <int K, int N, class Store>
__device__ __forceinline__ void mm_bwd_data(const float* __restrict__ DA,
                                            int ldd,
                                            const float* __restrict__ W,
                                            int ldw, Store store, int tx,
                                            int ty) {
  constexpr int KJ = K / 16;
  float acc[kRows][KJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int n = 0; n < N; ++n) {
    float d[kRows], w[KJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i) d[i] = DA[(ty + 16 * i) * ldd + n];
#pragma unroll
    for (int j = 0; j < KJ; ++j) w[j] = W[(tx + 16 * j) * ldw + n];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) acc[i][j] = fmaf(d[i], w[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) store(ty + 16 * i, tx + 16 * j, acc[i][j]);
}

// acc[i][j] += sum_e A[e][ty + 16 i] * DA[e][tx + 16 j] over the tile, and
// bacc[j] += sum_e DA[e][tx + 16 j] (the bias gradient; rows ty == 0 keep it).
template <int K, int N>
__device__ __forceinline__ void mm_bwd_w(const float* __restrict__ A, int lda,
                                         const float* __restrict__ DA,
                                         int ldd, float (&acc)[K / 16][N / 16],
                                         float (&bacc)[N / 16], int tx,
                                         int ty) {
#pragma unroll 8
  for (int e = 0; e < kTE; ++e) {
    float a[K / 16], d[N / 16];
#pragma unroll
    for (int i = 0; i < K / 16; ++i) a[i] = A[e * lda + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      d[j] = DA[e * ldd + tx + 16 * j];
      bacc[j] += d[j];
    }
#pragma unroll
    for (int i = 0; i < K / 16; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) acc[i][j] = fmaf(a[i], d[j], acc[i][j]);
  }
}

}  // namespace tile_mm
