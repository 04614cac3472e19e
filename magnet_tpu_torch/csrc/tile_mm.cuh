// Register-tiled products over shared memory for the edge kernels.
//
// tile_mm (the width-64 backward kernels): a block of kThreads = 256
// threads, seen as a 16 x 16 grid (tx = tid & 15, ty = tid >> 4), owns a
// tile of kTE = 64 edges.  Every operand lives in shared memory with a
// leading dimension of (width + 1) floats, so that row reads and column
// reads are both free of bank conflicts with scalar loads.  Each thread
// computes a kRows x (N / 16) register tile of a product.
//
// tile128 (the width-128 builds of csrc/fused_edge_tail_agg*.cu): the same
// 16 x 16 grid over a tile of TE consecutive CSR edges and one (128 x 128)
// weight, both in shared memory with rows of kLd floats; each thread holds
// an R x 8 register tile (R = TE / 16): rows ty + 16 i, columns tx + 16 j.
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

namespace tile128 {

// Values of the C entries' `entry` argument.
enum Entry : int { kPregathered = 0, kFold = 1, kPe = 2 };

constexpr int kW = 128;          // Ce = H = C
constexpr int kLd = kW + 1;      // shared-memory row stride, in floats
constexpr int kThreads = 256;    // tx = tid & 15, ty = tid >> 4
constexpr int kCols = kW / 16;   // register tile columns tx + 16 j

// The receiver of edge e: the last i with rowptr[i] <= e.
__device__ __forceinline__ int receiver_of(const int* __restrict__ rowptr,
                                           int n_nodes, int e) {
  int lo = 0, hi = n_nodes;  // rowptr[lo] <= e < rowptr[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (rowptr[mid] <= e) lo = mid; else hi = mid;
  }
  return lo;
}

// s_w[k][n] = w[k * kW + n].
__device__ __forceinline__ void load_weight(float* __restrict__ s_w,
                                            const float* __restrict__ w) {
  for (int k = threadIdx.x; k < kW * kW; k += kThreads)
    s_w[(k >> 7) * kLd + (k & (kW - 1))] = __ldg(w + k);
}

// dst[r][c] = src[base + r][c] for the tile's TE rows, zero past n_valid.
template <int TE>
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int base, int n_valid) {
  for (int k = threadIdx.x; k < TE * kW; k += kThreads) {
    const int r = k >> 7, c = k & (kW - 1);
    dst[r * kLd + c] = r < n_valid ? src[(size_t)(base + r) * kW + c] : 0.f;
  }
}

// The tile's senders (none for the pregathered entry) and receivers, zero
// past n_valid.
template <int TE, Entry E>
__device__ __forceinline__ void load_indices(int* s_snd, int* s_rcv,
                                             const int* __restrict__ senders,
                                             const int* __restrict__ rowptr,
                                             int n_nodes, int base,
                                             int n_valid) {
  const int t = threadIdx.x;
  if (t < TE) {
    int sv = 0, rv = 0;
    if (t < n_valid) {
      if (E != kPregathered) sv = senders[base + t];
      rv = receiver_of(rowptr, n_nodes, base + t);
    }
    s_snd[t] = sv;
    s_rcv[t] = rv;
  }
}

// h_0 = relu(src[e] + pxi[receiver]), plus pxj[sender] for the pe entry:
// the pregathered and pe entries' first layer over the tile, zero past
// n_valid.
template <int TE, Entry E>
__device__ __forceinline__ void first_input(
    float* __restrict__ s_act, const float* __restrict__ src,
    const float* __restrict__ pxj, const float* __restrict__ pxi,
    const int* s_snd, const int* s_rcv, int base, int n_valid) {
  for (int k = threadIdx.x; k < TE * kW; k += kThreads) {
    const int r = k >> 7, c = k & (kW - 1);
    float z = 0.f;
    if (r < n_valid) {
      z = src[(size_t)(base + r) * kW + c] +
          __ldg(pxi + (size_t)s_rcv[r] * kW + c);
      if (E == kPe) z += __ldg(pxj + (size_t)s_snd[r] * kW + c);
    }
    s_act[r * kLd + c] = fmaxf(z, 0.f);
  }
}

// acc = b_e + pxj[sender] + pxi[receiver] on the thread's rows and columns,
// zero past n_valid: the start of the fold entry's first product.
template <int R>
__device__ __forceinline__ void fold_init(float (&acc)[R][kCols],
                                          const float* __restrict__ be,
                                          const float* __restrict__ pxj,
                                          const float* __restrict__ pxi,
                                          const int* s_snd, const int* s_rcv,
                                          int n_valid, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int e = ty + 16 * i;
    const bool valid = e < n_valid;
    const float* pj = pxj + (size_t)s_snd[e] * kW;
    const float* pi = pxi + (size_t)s_rcv[e] * kW;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int n = tx + 16 * j;
      acc[i][j] = valid ? __ldg(be + n) + __ldg(pj + n) + __ldg(pi + n) : 0.f;
    }
  }
}

// acc[i][j] += sum_k A[ty + 16 i][k] * W[k][tx + 16 j]   (A . W)
template <int R>
__device__ __forceinline__ void mm_aw(const float* __restrict__ A,
                                      const float* __restrict__ W,
                                      float (&acc)[R][kCols], int tx, int ty) {
#pragma unroll 4
  for (int k = 0; k < kW; ++k) {
    float a[R], w[kCols];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * kLd + k];
#pragma unroll
    for (int j = 0; j < kCols; ++j) w[j] = W[k * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

// acc[i][j] += sum_n D[ty + 16 i][n] * W[tx + 16 j][n]   (D . W^T)
template <int R>
__device__ __forceinline__ void mm_dwt(const float* __restrict__ D,
                                       const float* __restrict__ W,
                                       float (&acc)[R][kCols], int tx,
                                       int ty) {
#pragma unroll 4
  for (int n = 0; n < kW; ++n) {
    float d[R], w[kCols];
#pragma unroll
    for (int i = 0; i < R; ++i) d[i] = D[(ty + 16 * i) * kLd + n];
#pragma unroll
    for (int j = 0; j < kCols; ++j) w[j] = W[(tx + 16 * j) * kLd + n];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(d[i], w[j], acc[i][j]);
  }
}

// dst[e][n] = acc, through relu when RELU, on the thread's rows and columns.
template <bool RELU, int R>
__device__ __forceinline__ void store(float* dst,
                                      const float (&acc)[R][kCols], int tx,
                                      int ty) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      dst[(ty + 16 * i) * kLd + tx + 16 * j] =
          RELU ? fmaxf(acc[i][j], 0.f) : acc[i][j];
}

}  // namespace tile128
