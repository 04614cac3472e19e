// Fused InteractionNetwork edge pipeline, backward, f32, three entries.
//
// fold (kFold) replaces the TPU kernel
// magnet_tpu/ops/pallas_kernels.py:_fused2r_bwd_pallas as
// _make_fused2r(fold_e=True).bwd calls it (public entry
// fused_edge_tail_agg2rf; the oracle is autodiff of _fused2re_ref_impl);
// pregathered (kPregathered) replaces _fused_bwd_pallas, the VJP of
// fused_edge_tail_agg (the oracle is _fused_ref_bwd); pe (kPe) replaces
// _fused2_bwd_pallas, the kernel of the VJP of fused_edge_tail_agg2 (the
// oracle is autodiff of _fused2_ref_impl).
//
// Given the forward's operands and g (N, C), for every edge j -> i of a
// receiver-grouped CSR graph it recomputes
//
//     z = e0[e] . W_e + b_e + pxj[j] + pxi[i]     (fold)
//     z = h0[e] + pxi[i]                          (pregathered)
//     z = pe[e] + pxj[j] + pxi[i]                 (pe)
//     h_0 = relu(z)
//     h_k = relu(h_{k-1} . W_k + b_k)  for k = 1..L1
//     y = h_L1 . W_out + b_out;  xhat = (y - mean) * rstd   (eps 1e-5)
//
// and returns, all f32:
//     fold:        d_e0 (E, Ce) = dz . W_e^T,  d_pxj[j] (N, H) += dz
//     pregathered: d_h0 (E, H) = dz  (the sender gather's cotangent is the
//                  caller's: a segment sum over the sender CSR)
//     pe:          d_pe (E, H) = dz  (d_pxj likewise the caller's: the
//                  segment sum of dz over the sender CSR, as the JAX VJP
//                  reduces it outside the kernel)
//     d_pxi[i] (N, H) += dz              and, packed into one buffer,
//     dW_e, db_e (fold only), dW_k, db_k, dW_out, db_out, d_ln_s, d_ln_b.
// relu's derivative at 0 is 0; a receiver of degree 0 has no edge, so its
// d_pxi row stays 0.  No (E, H) activation is written to device memory:
// the activations are recomputed per tile in shared memory (the
// pregathered and pe entries write their d_h0 / d_pe, which is their
// output).
//
// Compiled builds: fold (Ce, H, C) = (32, 64, 32) and (128, 128, 128);
// pregathered (H, C) = (64, 32) and (128, 128); pe (H, C) = (128, 128);
// L1 in 0..3.
//
// Design at width 64.  The backward is three matrix products per layer
// (recompute, data gradient, weight gradient), so it is written as tiled
// products, not as one lane per edge (a lane that kept every layer's
// activation would need 4 x 64 registers and spill):
//   * a block of 256 threads (16 x 16) owns a tile of 64 consecutive CSR
//     edges; tiles need not align with receivers, each edge finds its
//     receiver by a binary search in rowptr;
//   * all weights (67 KB) and the tile's activations h_0..h_L1 (65-float
//     rows, so that row and column reads are both free of bank conflicts)
//     live in dynamic shared memory, ~185 KB at L1 = 3: one block per SM;
//   * every thread computes a 4 x 4 (or 4 x 2) register tile of each
//     product; da_k overwrites the buffer of h_{k+1}, which is dead by then;
//   * weight gradients: each thread keeps its 4 x 4 patch of every dW in
//     registers across all tiles of its (persistent) block, so there are no
//     shared-memory atomics and no per-warp reduction; a block writes its
//     partial sums once, and a second small kernel in this file adds the
//     blocks' partials in a fixed order, so the weight gradients are the
//     same from run to run;
//   * fold: d_pxj is scattered over senders with f32 atomicAdd into a
//     zeroed buffer; the pregathered entry has no d_pxj; d_pxi is summed
//     over each run of equal receivers inside a quarter tile and then added
//     with one atomicAdd per run.  Both therefore differ in the last bits
//     from run to run (d_h0 does not).
//
// What bounds it on an H100: recompute, data and weight gradients are each
// the forward's 16,384 multiply-adds per edge (Ce = 32, H = 64, L1 = 3,
// C = 32), 2 x E x 49,152 FLOP on the f32 CUDA cores, against e0 read and
// d_e0 written once: bound by operations (the pregathered entry: three
// times 14,336 multiply-adds per edge against h0 read and d_h0 written,
// ~154 MB at E ~ 299.8k, still bound by operations).  Each product step
// makes 8 shared-memory loads for 16 FMAs, so the shared-memory pipe, not
// the FMA pipe, is the limit of this first version; wgmma is left for
// later.
//
// Design at width 128 (all three entries).  Neither the weights
// (258-322 KB) nor every dW as register patches (320 registers a thread)
// fit, so:
//   * a block of 256 threads owns a tile of 32 consecutive CSR edges and
//     keeps h_0..h_L1 and y (then dy) in shared memory (129-float rows,
//     ~83 KB at L1 = 3); each weight is streamed through one 66 KB shared
//     buffer when a product needs it (~149 KB in all: one block per SM);
//   * products are 2 x 8 register tiles (rows ty + 16 i, columns
//     tx + 16 j); da_k overwrites h_k in place, masked by h_k > 0;
//   * weight gradients: per tile, each thread forms an 8 x 8 patch of each
//     dW (and the bias sums) in registers and adds it into its block's
//     partial in device memory, which only that thread touches, in tile
//     order; the same second-pass reduce adds the blocks' partials in
//     block order, so the weight gradients are the same from run to run;
//   * d_pxj (fold) and d_pxi as at width 64: atomics, the last bits vary.
// Bound at MAgNet[GNN]'s training batch (~67.3k LR u HR edges, L1 = 3):
// fold 3 x 81,920 multiply-adds per edge = 33 GFLOP, ~0.49 ms at 67
// TFLOP/s; pe 3 x 65,536: both bound by operations.  The per-tile partial
// read-modify-write (64 KB per weight per 32 edges, from L2) and the
// shared-memory loads (10 per 16 FMAs) limit this first version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (magnet_tpu_torch/ops/cuda_build.py does this).

#include <cuda_runtime.h>

#include <atomic>

#include "tile_mm.cuh"

namespace {

using namespace tile_mm;  // kTE, kThreads, kRows, mm_fwd, mm_bwd_data, mm_bwd_w

constexpr float kLnEps = 1e-5f;

// Offsets, in floats, into dynamic shared memory and into the packed
// weight-gradient buffer.
// The pregathered entry (FOLD = false) has no W_e, b_e and e0 tile.
template <int CE, int H, int C, int L1, bool FOLD>
struct Layout {
  static constexpr int ldE = CE + 1, ldH = H + 1, ldC = C + 1;
  static constexpr int CEF = FOLD ? CE : 0, HF = FOLD ? H : 0;
  static constexpr int we = 0;                       // (CE, ldH)
  static constexpr int wr = we + CEF * ldH;          // (L1, H, ldH)
  static constexpr int wo = wr + L1 * H * ldH;       // (H, ldC)
  static constexpr int be = wo + H * ldC;            // (H)
  static constexpr int br = be + H;                  // (L1, H)
  static constexpr int bo = br + L1 * H;             // (C)
  static constexpr int ls = bo + C;                  // (C)
  static constexpr int e0 = ls + C;                  // (kTE, ldE)
  static constexpr int act = e0 + (FOLD ? kTE * ldE : 0);  // (L1+2, kTE, ldH)
  static constexpr int y = act + (L1 + 2) * kTE * ldH;  // (kTE, ldC)
  static constexpr int gx = y + kTE * ldC;           // (kTE, ldC) g * xhat
  static constexpr int gg = gx + kTE * ldC;          // (kTE, ldC) g
  static constexpr int snd = gg + kTE * ldC;         // (kTE) int
  static constexpr int rcv = snd + kTE;              // (kTE) int
  static constexpr int smem_floats = rcv + kTE;

  static constexpr int g_we = 0;
  static constexpr int g_be = g_we + CEF * H;
  static constexpr int g_wr = g_be + HF;
  static constexpr int g_br = g_wr + L1 * H * H;
  static constexpr int g_wo = g_br + L1 * H;
  static constexpr int g_bo = g_wo + H * C;
  static constexpr int g_ls = g_bo + C;
  static constexpr int g_lb = g_ls + C;
  static constexpr int g_total = g_lb + C;
};

template <int CE, int H, int C, int L1, bool FOLD>
__global__ void __launch_bounds__(kThreads, 1)
fused_edge_tail_agg_bwd_kernel(
    const float* __restrict__ src, const float* __restrict__ we,
    const float* __restrict__ be, const float* __restrict__ pxj,
    const float* __restrict__ pxi, const int* __restrict__ senders,
    const int* __restrict__ rowptr, const float* __restrict__ w_rest,
    const float* __restrict__ b_rest, const float* __restrict__ w_out,
    const float* __restrict__ b_out, const float* __restrict__ ln_s,
    const float* __restrict__ g, float* __restrict__ d_src,
    float* __restrict__ d_pxj, float* __restrict__ d_pxi,
    float* __restrict__ partial, int n_nodes, int n_edges) {
  using L = Layout<CE, H, C, L1, FOLD>;
  static_assert(CE % 16 == 0 && H % 16 == 0 && C % 16 == 0,
                "widths must be multiples of 16 (16 x 16 thread grid)");
  static_assert(kTE * 4 == kThreads && C % 4 == 0,
                "LayerNorm phase: four threads per edge");
  static_assert(kThreads % H == 0 && kTE % (kThreads / H) == 0,
                "d_pxi phase: one column per thread, equal edge ranges");
  static_assert(2 * C <= kThreads, "LayerNorm column sums");
  constexpr int ldE = L::ldE, ldH = L::ldH, ldC = L::ldC;
  constexpr int NL = L1 > 0 ? L1 : 1;

  extern __shared__ float smem[];
  float* s_we = smem + L::we;
  float* s_wr = smem + L::wr;
  float* s_wo = smem + L::wo;
  float* s_be = smem + L::be;
  float* s_br = smem + L::br;
  float* s_bo = smem + L::bo;
  float* s_ls = smem + L::ls;
  float* s_e0 = smem + L::e0;
  float* s_act = smem + L::act;
  float* s_y = smem + L::y;
  float* s_gx = smem + L::gx;
  float* s_gg = smem + L::gg;
  int* s_snd = reinterpret_cast<int*>(smem + L::snd);
  int* s_rcv = reinterpret_cast<int*>(smem + L::rcv);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  if (FOLD) {
    for (int k = tid; k < CE * H; k += kThreads)
      s_we[(k / H) * ldH + k % H] = we[k];
    for (int k = tid; k < H; k += kThreads) s_be[k] = be[k];
  }
  for (int k = tid; k < L1 * H * H; k += kThreads)
    s_wr[(k / H) * ldH + k % H] = w_rest[k];
  for (int k = tid; k < H * C; k += kThreads)
    s_wo[(k / C) * ldC + k % C] = w_out[k];
  for (int k = tid; k < L1 * H; k += kThreads) s_br[k] = b_rest[k];
  for (int k = tid; k < C; k += kThreads) {
    s_bo[k] = b_out[k];
    s_ls[k] = ln_s[k];
  }
  __syncthreads();

  // the thread's patches of the weight gradients, summed over its tiles
  float acc_we[CE / 16][H / 16], acc_be[H / 16];
  float acc_wr[NL][H / 16][H / 16], acc_br[NL][H / 16];
  float acc_wo[H / 16][C / 16], acc_bo[C / 16];
  float acc_ln = 0.f;  // tid < C: d_ln_s[tid]; tid < 2C: d_ln_b[tid - C]
#pragma unroll
  for (int j = 0; j < H / 16; ++j) {
    acc_be[j] = 0.f;
#pragma unroll
    for (int i = 0; i < CE / 16; ++i) acc_we[i][j] = 0.f;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      acc_br[l][j] = 0.f;
#pragma unroll
      for (int i = 0; i < H / 16; ++i) acc_wr[l][i][j] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < C / 16; ++j) {
    acc_bo[j] = 0.f;
#pragma unroll
    for (int i = 0; i < H / 16; ++i) acc_wo[i][j] = 0.f;
  }

  const int n_tiles = (n_edges + kTE - 1) / kTE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kTE;
    const int n_valid = min(kTE, n_edges - base);

    // the tile's indices and edge latents; rows past the end are zero
    if (tid < kTE) {
      int sv = 0, rv = 0;
      if (tid < n_valid) {
        const int e = base + tid;
        sv = FOLD ? senders[e] : 0;
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
    if constexpr (FOLD) {
      for (int k = tid; k < kTE * CE; k += kThreads) {
        const int r = k / CE, c = k % CE;
        s_e0[r * ldE + c] =
            r < n_valid ? src[(size_t)(base + r) * CE + c] : 0.f;
      }
      __syncthreads();
      // recompute: h_0 = relu(e0 . W_e + b_e + pxj[j] + pxi[i])
      float* out = s_act;
      mm_fwd<CE, H, true>(
          s_e0, ldE, s_we, ldH,
          [&](int e, int n) {
            return e < n_valid ? s_be[n] + pxj[(size_t)s_snd[e] * H + n] +
                                     pxi[(size_t)s_rcv[e] * H + n]
                               : 0.f;
          },
          [&](int e, int n, float v) { out[e * ldH + n] = v; }, tx, ty);
    } else {
      __syncthreads();
      // recompute: h_0 = relu(h0[e] + pxi[i]); rows past the end are zero
      for (int k = tid; k < kTE * H; k += kThreads) {
        const int e = k / H, n = k % H;
        const float z = e < n_valid ? src[(size_t)(base + e) * H + n] +
                                          pxi[(size_t)s_rcv[e] * H + n]
                                    : 0.f;
        s_act[e * ldH + n] = fmaxf(z, 0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 1; k <= L1; ++k) {
      const float* b = s_br + (k - 1) * H;
      float* out = s_act + k * kTE * ldH;
      mm_fwd<H, H, true>(
          s_act + (k - 1) * kTE * ldH, ldH, s_wr + (k - 1) * H * ldH, ldH,
          [&](int, int n) { return b[n]; },
          [&](int e, int n, float v) { out[e * ldH + n] = v; }, tx, ty);
      __syncthreads();
    }
    mm_fwd<H, C, false>(
        s_act + L1 * kTE * ldH, ldH, s_wo, ldC,
        [&](int, int c) { return s_bo[c]; },
        [&](int e, int c, float v) { s_y[e * ldC + c] = v; }, tx, ty);
    __syncthreads();

    // LayerNorm backward, four threads per edge: y -> dy in place, and the
    // tile's g and g * xhat for the scale and bias gradients
    {
      constexpr int CP = C / 4;
      const int e = tid >> 2, c0 = (tid & 3) * CP;
      float* yr = s_y + e * ldC + c0;
      float v[CP], dx[CP];
      float mu = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        v[c] = yr[c];
        mu += v[c];
      }
      mu += __shfl_xor_sync(0xffffffffu, mu, 1);
      mu += __shfl_xor_sync(0xffffffffu, mu, 2);
      mu *= 1.f / C;
      float var = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const float d = v[c] - mu;
        var = fmaf(d, d, var);
      }
      var += __shfl_xor_sync(0xffffffffu, var, 1);
      var += __shfl_xor_sync(0xffffffffu, var, 2);
      var *= 1.f / C;
      const float rstd = rsqrtf(var + kLnEps);
      const bool valid = e < n_valid;
      const float* gp = g + (size_t)s_rcv[e] * C + c0;
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const float gv = valid ? gp[c] : 0.f;
        const float xh = (v[c] - mu) * rstd;
        dx[c] = gv * s_ls[c0 + c];
        m1 += dx[c];
        m2 = fmaf(dx[c], xh, m2);
        s_gx[e * ldC + c0 + c] = gv * xh;
        s_gg[e * ldC + c0 + c] = gv;
        v[c] = xh;
      }
      m1 += __shfl_xor_sync(0xffffffffu, m1, 1);
      m1 += __shfl_xor_sync(0xffffffffu, m1, 2);
      m2 += __shfl_xor_sync(0xffffffffu, m2, 1);
      m2 += __shfl_xor_sync(0xffffffffu, m2, 2);
      m1 *= 1.f / C;
      m2 *= 1.f / C;
#pragma unroll
      for (int c = 0; c < CP; ++c) yr[c] = rstd * (dx[c] - m1 - v[c] * m2);
    }
    __syncthreads();

    // output layer: dW_out, db_out, d_ln_s, d_ln_b, and
    // da_L1 = (dy . W_out^T) where h_L1 > 0, into the spare buffer
    {
      const float* h = s_act + L1 * kTE * ldH;
      float* out = s_act + (L1 + 1) * kTE * ldH;
      mm_bwd_w<H, C>(h, ldH, s_y, ldC, acc_wo, acc_bo, tx, ty);
      if (tid < 2 * C) {
        const float* src = (tid < C ? s_gx : s_gg) + tid % C;
        float s = 0.f;
        for (int e = 0; e < kTE; ++e) s += src[e * ldC];
        acc_ln += s;
      }
      mm_bwd_data<H, C>(
          s_y, ldC, s_wo, ldC,
          [&](int e, int k, float v) {
            out[e * ldH + k] = h[e * ldH + k] > 0.f ? v : 0.f;
          },
          tx, ty);
    }
    __syncthreads();

    // tail layers, last to first; da_k sits in the buffer of h_{k+1}
#pragma unroll
    for (int k = L1; k >= 1; --k) {
      const float* h = s_act + (k - 1) * kTE * ldH;
      const float* da = s_act + (k + 1) * kTE * ldH;
      float* out = s_act + k * kTE * ldH;
      mm_bwd_w<H, H>(h, ldH, da, ldH, acc_wr[k - 1], acc_br[k - 1], tx, ty);
      mm_bwd_data<H, H>(
          da, ldH, s_wr + (k - 1) * H * ldH, ldH,
          [&](int e, int n, float v) {
            out[e * ldH + n] = h[e * ldH + n] > 0.f ? v : 0.f;
          },
          tx, ty);
      __syncthreads();
    }

    // first layer: dz = da_0
    {
      const float* dz = s_act + kTE * ldH;
      if constexpr (FOLD) {
        mm_bwd_w<CE, H>(s_e0, ldE, dz, ldH, acc_we, acc_be, tx, ty);
        mm_bwd_data<CE, H>(
            dz, ldH, s_we, ldH,
            [&](int e, int c, float v) {
              if (e < n_valid) d_src[(size_t)(base + e) * CE + c] = v;
            },
            tx, ty);
        for (int k = tid; k < n_valid * H; k += kThreads) {
          const int e = k / H, n = k % H;
          atomicAdd(d_pxj + (size_t)s_snd[e] * H + n, dz[e * ldH + n]);
        }
      } else {
        for (int k = tid; k < n_valid * H; k += kThreads) {
          const int e = k / H, n = k % H;
          d_src[(size_t)(base + e) * H + n] = dz[e * ldH + n];
        }
      }
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
            atomicAdd(d_pxi + (size_t)cur * H + n, s);
            s = 0.f;
            cur = r;
          }
          s += dz[e * ldH + n];
        }
        atomicAdd(d_pxi + (size_t)cur * H + n, s);
      }
    }
    __syncthreads();
  }

  // this block's partial weight gradients, in the packed layout
  float* p = partial + (size_t)blockIdx.x * L::g_total;
#pragma unroll
  for (int j = 0; j < H / 16; ++j) {
    const int n = tx + 16 * j;
    if (FOLD) {
#pragma unroll
      for (int i = 0; i < CE / 16; ++i)
        p[L::g_we + (ty + 16 * i) * H + n] = acc_we[i][j];
      if (ty == 0) p[L::g_be + n] = acc_be[j];
    }
#pragma unroll
    for (int l = 0; l < L1; ++l) {
#pragma unroll
      for (int i = 0; i < H / 16; ++i)
        p[L::g_wr + (l * H + ty + 16 * i) * H + n] = acc_wr[l][i][j];
      if (ty == 0) p[L::g_br + l * H + n] = acc_br[l][j];
    }
  }
#pragma unroll
  for (int j = 0; j < C / 16; ++j) {
    const int c = tx + 16 * j;
#pragma unroll
    for (int i = 0; i < H / 16; ++i)
      p[L::g_wo + (ty + 16 * i) * C + c] = acc_wo[i][j];
    if (ty == 0) p[L::g_bo + c] = acc_bo[j];
  }
  if (tid < C)
    p[L::g_ls + tid] = acc_ln;
  else if (tid < 2 * C)
    p[L::g_lb + tid - C] = acc_ln;
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
template <int CE, int H, int C, int L1, bool FOLD>
cudaError_t grid_cap(size_t smem_bytes, int* cap) {
  static std::atomic<int> cache[kMaxDevices];  // 0: unset
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && (*cap = cache[device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  auto kernel = fused_edge_tail_agg_bwd_kernel<CE, H, C, L1, FOLD>;
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

template <int CE, int H, int C, int L1, bool FOLD>
int launch(const float* src, const float* we, const float* be,
           const float* pxj, const float* pxi, const int* senders,
           const int* rowptr, const float* w_rest, const float* b_rest,
           const float* w_out, const float* b_out, const float* ln_s,
           const float* g, float* d_src, float* d_pxj, float* d_pxi,
           float* wgrad, float* partial, int n_nodes, int n_edges,
           int scratch_blocks, cudaStream_t stream) {
  using L = Layout<CE, H, C, L1, FOLD>;
  const size_t smem_bytes = sizeof(float) * (size_t)L::smem_floats;
  int cap = 0;
  const cudaError_t err = grid_cap<CE, H, C, L1, FOLD>(smem_bytes, &cap);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  int blocks = n_tiles < cap ? n_tiles : cap;
  if (blocks > scratch_blocks) blocks = scratch_blocks;
  if (n_tiles > 0 && blocks < 1) return (int)cudaErrorInvalidValue;
  if (n_nodes == 0) blocks = 0;
  if (blocks > 0) {
    fused_edge_tail_agg_bwd_kernel<CE, H, C, L1, FOLD>
        <<<blocks, kThreads, smem_bytes, stream>>>(
            src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out,
            b_out, ln_s, g, d_src, d_pxj, d_pxi, partial, n_nodes, n_edges);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return (int)launched;
  }
  reduce_partials_kernel<<<(L::g_total + 255) / 256, 256, 0, stream>>>(
      partial, wgrad, blocks, L::g_total);
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
constexpr int kTE = 32;             // edges per tile
constexpr int kRows = kTE / 16;     // register tile rows
constexpr int kBuf = kTE * kLd;     // floats of one activation buffer

// shared memory, in floats: the weight, then L1 + 2 activation buffers
// (h_0..h_L1, then y / dy / the e0 tile), then indices and row statistics
__host__ __device__ constexpr int smem_floats(int l1) {
  return kW * kLd + (l1 + 2) * kBuf + 4 * kTE;
}

// the packed weight-gradient layout, in floats
struct Packed {
  int we, be, wr, br, wo, bo, ls, lb, total;
  __host__ __device__ Packed(bool fold, int l1) {
    we = 0;
    be = we + (fold ? kW * kW : 0);
    wr = be + (fold ? kW : 0);
    br = wr + l1 * kW * kW;
    wo = br + l1 * kW;
    bo = wo + kW * kW;
    ls = bo + kW;
    lb = ls + kW;
    total = lb + kW;
  }
};

// P[a][b] (+)= sum_e A[e][a] * D[e][b] over the tile, for a = ty + 16 i,
// b = tx + 16 j (i, j < 8), and pb[b] (+)= sum_e D[e][b] (threads ty == 0):
// written on the block's first tile, added after.  Only this thread
// touches these entries of the block's partial.
__device__ __forceinline__ void wgrad(const float* __restrict__ A,
                                      const float* __restrict__ D,
                                      float* __restrict__ P,
                                      float* __restrict__ pb, bool first,
                                      int tx, int ty) {
  float acc[kCols][kCols], bacc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    bacc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i][j] = 0.f;
  }
#pragma unroll 2
  for (int e = 0; e < kTE; ++e) {
    float a[kCols], d[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) a[i] = A[e * kLd + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      d[j] = D[e * kLd + tx + 16 * j];
      bacc[j] += d[j];
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], d[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float* p = P + (ty + 16 * i) * kW + tx + 16 * j;
      *p = first ? acc[i][j] : *p + acc[i][j];
    }
  if (ty == 0) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float* p = pb + tx + 16 * j;
      *p = first ? bacc[j] : *p + bacc[j];
    }
  }
}

// dst[e][a] <- acc where keep[e][a] > 0, else 0 (dst may be keep).
__device__ __forceinline__ void store_masked(float* dst, const float* keep,
                                             const float (&acc)[kRows][kCols],
                                             int tx, int ty) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int o = (ty + 16 * i) * kLd + tx + 16 * j;
      dst[o] = keep[o] > 0.f ? acc[i][j] : 0.f;
    }
}

template <Entry E>
__global__ void __launch_bounds__(kThreads, 1)
edge_tail_bwd_kernel(
    const float* __restrict__ src, const float* __restrict__ we,
    const float* __restrict__ be, const float* __restrict__ pxj,
    const float* __restrict__ pxi, const int* __restrict__ senders,
    const int* __restrict__ rowptr, const float* __restrict__ w_rest,
    const float* __restrict__ b_rest, const float* __restrict__ w_out,
    const float* __restrict__ b_out, const float* __restrict__ ln_s,
    const float* __restrict__ g, float* __restrict__ d_src,
    float* __restrict__ d_pxj, float* __restrict__ d_pxi,
    float* __restrict__ partial, int n_nodes, int n_edges, int l1) {
  static_assert(kTE * 8 == kThreads, "LayerNorm: eight threads per edge");
  constexpr bool FOLD = E == kFold;
  const Packed L(FOLD, l1);
  extern __shared__ float smem[];
  float* s_w = smem;
  float* s_act = smem + kW * kLd;               // buffer k: s_act + k * kBuf
  float* s_x = s_act + (l1 + 1) * kBuf;         // y, dy, or the e0 tile
  int* s_snd = reinterpret_cast<int*>(s_x + kBuf);
  int* s_rcv = s_snd + kTE;
  float* s_mu = reinterpret_cast<float*>(s_rcv + kTE);
  float* s_rstd = s_mu + kTE;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float* p = partial + (size_t)blockIdx.x * L.total;
  float acc_ln = 0.f;  // tid < kW: d_ln_s[tid]; else d_ln_b[tid - kW]

  const int n_tiles = (n_edges + kTE - 1) / kTE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int base = tile * kTE;
    const int n_valid = min(kTE, n_edges - base);
    tile128::load_indices<kTE, E>(s_snd, s_rcv, senders, rowptr, n_nodes,
                                  base, n_valid);

    // recompute h_0; rows past the end are zero
    if (FOLD) {
      tile128::load_rows<kTE>(s_x, src, base, n_valid);
      tile128::load_weight(s_w, we);
      __syncthreads();
      float acc[kRows][kCols];
      tile128::fold_init(acc, be, pxj, pxi, s_snd, s_rcv, n_valid, tx, ty);
      tile128::mm_aw(s_x, s_w, acc, tx, ty);
      tile128::store<true>(s_act, acc, tx, ty);
    } else {
      __syncthreads();  // s_snd, s_rcv
      tile128::first_input<kTE, E>(s_act, src, pxj, pxi, s_snd, s_rcv, base,
                                   n_valid);
    }
    // recompute h_1..h_L1, then y into s_x
    for (int k = 0; k <= l1; ++k) {
      const bool out_layer = k == l1;
      __syncthreads();  // s_w free; the previous layer written
      tile128::load_weight(s_w,
                           out_layer ? w_out : w_rest + (size_t)k * kW * kW);
      __syncthreads();
      const float* bias = out_layer ? b_out : b_rest + k * kW;
      float acc[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = __ldg(bias + tx + 16 * j);
      tile128::mm_aw(s_act + k * kBuf, s_w, acc, tx, ty);
      if (out_layer)
        tile128::store<false>(s_x, acc, tx, ty);
      else
        tile128::store<true>(s_act + (k + 1) * kBuf, acc, tx, ty);
    }
    __syncthreads();

    // LayerNorm backward, eight threads per edge: row statistics and the
    // row means of dx = g * ln_s and dx * xhat, kept in registers
    constexpr int CP = kW / 8;
    const int le = tid >> 3, c0 = (tid & 7) * CP;
    float v[CP], gv[CP];
    float mu = 0.f, rstd, m1 = 0.f, m2 = 0.f;
    {
      const bool valid = le < n_valid;
      const float* gp = g + (size_t)s_rcv[le] * kW + c0;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        v[c] = s_x[le * kLd + c0 + c];
        gv[c] = valid ? __ldg(gp + c) : 0.f;
        mu += v[c];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mu += __shfl_xor_sync(0xffffffffu, mu, o);
      mu *= 1.f / kW;
      float var = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const float d = v[c] - mu;
        var = fmaf(d, d, var);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        var += __shfl_xor_sync(0xffffffffu, var, o);
      var *= 1.f / kW;
      rstd = rsqrtf(var + kLnEps);
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        v[c] = (v[c] - mu) * rstd;  // xhat
        const float dx = gv[c] * __ldg(ln_s + c0 + c);
        m1 += dx;
        m2 = fmaf(dx, v[c], m2);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        m1 += __shfl_xor_sync(0xffffffffu, m1, o);
        m2 += __shfl_xor_sync(0xffffffffu, m2, o);
      }
      m1 *= 1.f / kW;
      m2 *= 1.f / kW;
      if ((tid & 7) == 0) {
        s_mu[le] = mu;
        s_rstd[le] = rstd;
      }
    }
    __syncthreads();
    // d_ln_s, d_ln_b: column sums over the tile's edges, one thread each
    {
      const int c = tid & (kW - 1);
      float s = 0.f;
      for (int e = 0; e < n_valid; ++e) {
        const float ge = __ldg(g + (size_t)s_rcv[e] * kW + c);
        s += tid < kW ? ge * (s_x[e * kLd + c] - s_mu[e]) * s_rstd[e] : ge;
      }
      acc_ln += s;
    }
    __syncthreads();  // y read by every thread
    // dy = rstd * (dx - mean(dx) - xhat * mean(dx * xhat)), in place
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      const float dx = gv[c] * __ldg(ln_s + c0 + c);
      s_x[le * kLd + c0 + c] = rstd * (dx - m1 - v[c] * m2);
    }
    __syncthreads();

    // output layer: dW_out, db_out; da_L1 = (dy . W_out^T) where h_L1 > 0,
    // over h_L1 in place (W_out is still in s_w)
    {
      float* h = s_act + l1 * kBuf;
      wgrad(h, s_x, p + L.wo, p + L.bo, first, tx, ty);
      float acc[kRows][kCols] = {};
      tile128::mm_dwt(s_x, s_w, acc, tx, ty);
      __syncthreads();  // every read of h is done
      store_masked(h, h, acc, tx, ty);
    }
    // tail layers, last to first: da_{k-1} over h_{k-1} in place
    for (int k = l1; k >= 1; --k) {
      float* h = s_act + (k - 1) * kBuf;
      const float* da = s_act + k * kBuf;
      __syncthreads();  // da written; s_w free
      tile128::load_weight(s_w, w_rest + (size_t)(k - 1) * kW * kW);
      wgrad(h, da, p + L.wr + (k - 1) * kW * kW, p + L.br + (k - 1) * kW,
            first, tx, ty);
      __syncthreads();  // s_w loaded; every read of h is done
      float acc[kRows][kCols] = {};
      tile128::mm_dwt(da, s_w, acc, tx, ty);
      store_masked(h, h, acc, tx, ty);
    }
    __syncthreads();  // dz = da_0 in buffer 0

    const float* dz = s_act;
    if (FOLD) {
      // dW_e, db_e from the e0 tile (into s_x: dy is dead), d_e0 = dz . W_e^T,
      // d_pxj scattered over senders
      tile128::load_rows<kTE>(s_x, src, base, n_valid);
      tile128::load_weight(s_w, we);
      for (int k = tid; k < n_valid * kW; k += kThreads) {
        const int e = k >> 7, n = k & (kW - 1);
        atomicAdd(d_pxj + (size_t)s_snd[e] * kW + n, dz[e * kLd + n]);
      }
      __syncthreads();
      wgrad(s_x, dz, p + L.we, p + L.be, first, tx, ty);
      float acc[kRows][kCols] = {};
      tile128::mm_dwt(dz, s_w, acc, tx, ty);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int e = ty + 16 * i;
        if (e < n_valid)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            d_src[(size_t)(base + e) * kW + tx + 16 * j] = acc[i][j];
      }
    } else {
      for (int k = tid; k < n_valid * kW; k += kThreads) {
        const int e = k >> 7, n = k & (kW - 1);
        d_src[(size_t)(base + e) * kW + n] = dz[e * kLd + n];
      }
    }
    // d_pxi: one atomicAdd per run of equal receivers in each half tile
    {
      constexpr int kHalf = kTE / 2;
      const int n = tid & (kW - 1);
      const int e_beg = (tid >> 7) * kHalf;
      const int e_end = min(e_beg + kHalf, n_valid);
      if (e_beg < e_end) {
        int cur = s_rcv[e_beg];
        float s = 0.f;
        for (int e = e_beg; e < e_end; ++e) {
          const int r = s_rcv[e];
          if (r != cur) {
            atomicAdd(d_pxi + (size_t)cur * kW + n, s);
            s = 0.f;
            cur = r;
          }
          s += dz[e * kLd + n];
        }
        atomicAdd(d_pxi + (size_t)cur * kW + n, s);
      }
    }
    __syncthreads();  // before the next tile overwrites shared memory
  }
  if (tid < kW)
    p[L.ls + tid] = acc_ln;
  else
    p[L.lb + tid - kW] = acc_ln;
}

template <Entry E>
int launch(const float* src, const float* we, const float* be,
           const float* pxj, const float* pxi, const int* senders,
           const int* rowptr, const float* w_rest, const float* b_rest,
           const float* w_out, const float* b_out, const float* ln_s,
           const float* g, float* d_src, float* d_pxj, float* d_pxi,
           float* wgrad_out, float* partial, int n_nodes, int n_edges, int l1,
           int scratch_blocks, cudaStream_t stream) {
  static std::atomic<int> cache[kMaxDevices];  // blocks per SM; 0: unset
  const size_t smem = sizeof(float) * (size_t)smem_floats(3);
  const Packed L(E == kFold, l1);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int cap = device < kMaxDevices ? cache[device].load(std::memory_order_relaxed)
                                 : 0;
  if (cap == 0) {
    auto kernel = edge_tail_bwd_kernel<E>;
    int n_sm = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cap = n_sm * per_sm;
    if (device < kMaxDevices) cache[device].store(cap, std::memory_order_relaxed);
  }
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  int blocks = n_tiles < cap ? n_tiles : cap;
  if (blocks > scratch_blocks) blocks = scratch_blocks;
  if (n_tiles > 0 && blocks < 1) return (int)cudaErrorInvalidValue;
  if (n_nodes == 0) blocks = 0;
  if (blocks > 0) {
    edge_tail_bwd_kernel<E><<<blocks, kThreads,
                              sizeof(float) * (size_t)smem_floats(l1),
                              stream>>>(
        src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
        ln_s, g, d_src, d_pxj, d_pxi, partial, n_nodes, n_edges, l1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  reduce_partials_kernel<<<(L.total + 255) / 256, 256, 0, stream>>>(
      partial, wgrad_out, blocks, L.total);
  return (int)cudaGetLastError();
}

}  // namespace w128

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 is success.  Launches on `stream` and does not
// synchronise.  entry (an Entry): kFold, src is e0 (n_edges, ce) and d_src
// its gradient, and we, be, pxj, senders and d_pxj are used; kPregathered,
// src is h0 (n_edges, h) and d_src its gradient, and those five are
// ignored (they may be null); kPe, src is pe (n_edges, h) and d_src its
// gradient, pxj and senders are read, we, be and d_pxj ignored.  d_pxj and
// d_pxi must arrive zeroed; wgrad holds, packed, dW_e (ce, h) and db_e (h)
// (fold only), dW_rest (l1, h, h), db_rest (l1, h), dW_out (h, c), db_out
// (c), d_ln_s (c), d_ln_b (c); partial is scratch for scratch_blocks x
// that many floats.  The compiled builds are those of the header, each for
// l1 in 0..3; others return cudaErrorInvalidValue.
int fused_edge_tail_agg_bwd_f32(
    const float* src, const float* we, const float* be, const float* pxj,
    const float* pxi, const int* senders, const int* rowptr,
    const float* w_rest, const float* b_rest, const float* w_out,
    const float* b_out, const float* ln_s, const float* g, float* d_src,
    float* d_pxj, float* d_pxi, float* wgrad, float* partial, int n_nodes,
    int n_edges, int ce, int h, int c, int l1, int entry, int scratch_blocks,
    void* stream) {
  using tile128::kFold;
  using tile128::kPe;
  using tile128::kPregathered;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = h == 64 && c == 32, wide = h == 128 && c == 128;
  const bool gathers = pxj != nullptr && senders != nullptr;
  if (l1 < 0 || l1 > 3) return (int)cudaErrorInvalidValue;
  if (entry == kFold &&
      (!gathers || we == nullptr || be == nullptr || d_pxj == nullptr))
    return (int)cudaErrorInvalidValue;
  if (entry == kPe && !gathers) return (int)cudaErrorInvalidValue;
  if (entry == kFold && ce == 128 && wide)
    return w128::launch<kFold>(src, we, be, pxj, pxi, senders, rowptr, w_rest,
                               b_rest, w_out, b_out, ln_s, g, d_src, d_pxj,
                               d_pxi, wgrad, partial, n_nodes, n_edges, l1,
                               scratch_blocks, s);
  if (entry == kPregathered && wide)
    return w128::launch<kPregathered>(
        src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
        ln_s, g, d_src, d_pxj, d_pxi, wgrad, partial, n_nodes, n_edges, l1,
        scratch_blocks, s);
  if (entry == kPe && wide)
    return w128::launch<kPe>(src, we, be, pxj, pxi, senders, rowptr, w_rest,
                             b_rest, w_out, b_out, ln_s, g, d_src, d_pxj,
                             d_pxi, wgrad, partial, n_nodes, n_edges, l1,
                             scratch_blocks, s);
  const bool fold = entry == kFold;
  if (!(narrow && (fold ? ce == 32 : entry == kPregathered)))
    return (int)cudaErrorInvalidValue;
#define MAGNET_BWD_CASE(L1V)                                                 \
  case L1V:                                                                  \
    return fold ? launch<32, 64, 32, L1V, true>(                             \
                      src, we, be, pxj, pxi, senders, rowptr, w_rest,        \
                      b_rest, w_out, b_out, ln_s, g, d_src, d_pxj, d_pxi,    \
                      wgrad, partial, n_nodes, n_edges, scratch_blocks, s)   \
                : launch<32, 64, 32, L1V, false>(                            \
                      src, we, be, pxj, pxi, senders, rowptr, w_rest,        \
                      b_rest, w_out, b_out, ln_s, g, d_src, d_pxj, d_pxi,    \
                      wgrad, partial, n_nodes, n_edges, scratch_blocks, s)
  switch (l1) {
    MAGNET_BWD_CASE(0);
    MAGNET_BWD_CASE(1);
    MAGNET_BWD_CASE(2);
    MAGNET_BWD_CASE(3);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MAGNET_BWD_CASE
}

}  // extern "C"
