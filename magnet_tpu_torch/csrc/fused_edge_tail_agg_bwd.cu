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
// d_pxi row stays 0.  At width 64 no (E, H) activation is written to device
// memory: the activations are recomputed per tile in shared memory (the
// pregathered entry writes its d_h0, which is its output); at width 128
// they go through a scratch buffer (below).
//
// Compiled builds: fold (Ce, H, C) = (32, 64, 32) and (128, 128, 128);
// pregathered (H, C) = (64, 32) and (128, 128); pe (H, C) = (128, 128);
// L1 in 0..3.  The width-64 and width-128 builds are two designs.
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
// Design at width 128 (all three entries, Ce = H = C = 128, L1 <= 3).
// Five f32 weight gradients (320 KB at L1 = 3) fit neither a block's
// 227 KB of shared memory nor its registers, and neither do the five
// weights the recompute and the data gradients need, so the backward is
// two hand-written kernels in one launch sequence, not one fused kernel:
//   (a) the recompute and the data-gradient chain, as one pass per layer
//       over every edge (edge_pass_kernel): h_0 (fold: e0 . W_e + b_e +
//       pxj[j] + pxi[i]; pregathered, pe: an elementwise kernel), h_1..h_L1,
//       y and LayerNorm's backward to dy, then da_L1..da_1 and dz through
//       each W^T masked by h > 0, and, fold, d_e0 = dz . W_e^T.  Each pass
//       keeps its one weight resident in shared memory for the whole launch
//       (no weight is reloaded per tile), walks 32-edge tiles on a
//       persistent grid, and fetches the next tile's rows with cp.async
//       while the current tile computes; 103 KB of shared memory and at
//       most 128 registers, so two blocks of 8 warps share an SM (splitting the weight and each tile once in shared memory would
//       save the warps' repeated splits but needs 203 KB, one block per SM,
//       and these passes are held by latency more than by the splits).
//       Each h_k and each layer's output gradient (dz, da_1..da_L1,
//       dy) is written once to a scratch buffer the wrapper allocates: at
//       MAgNet[GNN]'s training batch (67,572 edges, L1 = 3) 9 planes of 512 B
//       per edge, 311 MB written and read back, ~0.19 ms at 3.35 TB/s, in
//       place of the per-tile read-modify-write of every dW partial in
//       device memory (~1.35 GB a launch) of the design before;
//   (b) wgrad_kernel, a tall-skinny product dW_k = sum_e h_k[e]^T da_k[e]
//       (with db_k = sum_e da_k[e]) for every weight at once: the edges are
//       split into ranges over the blocks, each block keeps its 128 x 128
//       result in 64 f32 accumulators a thread across its range (32-edge
//       slabs double-buffered with cp.async, 70 KB), and writes it once; a
//       last
//       kernel adds the ranges' partials in range order, so the weight
//       gradients are the same from run to run.  d_ln_s / d_ln_b are summed
//       per block in the LN pass and added the same way.
// d_pxj (fold) and d_pxi are scattered from dz by scatter_kernel with f32
// atomics (one per element for d_pxj, one per run of equal receivers in a
// half tile for d_pxi): their last bits vary from run to run.
// Every product runs on the tensor cores in error-compensated TF32
// (tf32x3, csrc/tile_mm.cuh): ~2^-21 relative per product, so a recomputed
// pre-activation stays far closer to the f32 one than the relu-tie band
// that chip_smoke.py guards (1e-5 of the layer's RMS); one TF32 pass
// (~5e-4) would not.  mma.sync m16n8k8 and not wgmma: the passes read W as
// stored (forward) and transposed (backward) and kernel (b) reads both
// tiles down their columns, while wgmma's tf32 form reads only K-major
// operands from shared memory; mma.sync's fragments are loaded by threads
// from f32 shared memory at any strides and split into hi / lo in
// registers, so no lo plane doubles a weight.
// Bound at MAgNet[GNN]'s training batch (~67.6k LR u HR edges, L1 = 3):
// fold 3 x 81,920 multiply-adds per edge = 33 GFLOP, ~0.49 ms at 67 TFLOP/s
// on the f32 CUDA cores, or 99 GFLOP as issued in three TF32 products,
// ~0.20 ms at 495 TFLOP/s; pe 3 x 65,536.
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
using tile128::kFold;
using tile128::kPe;
using tile128::kPregathered;
using tile128::kW;
constexpr int kThreads = 256;  // 8 warps
constexpr int kTE = 32;        // edges per tile of a pass
constexpr int kLd = kW + 4;    // shared row stride of an edge tile, floats
constexpr int kLdT = kW + 8;   // the same, for tiles read down their columns
constexpr int kTile = kTE * kLd;

// The passes of kernel (a), each one product of one layer over every edge.
enum Pass : int {
  kFirst,      // h_0 = relu(e0 . W_e + b_e + pxj[s] + pxi[r])      (fold)
  kForward,    // h_k = relu(h_{k-1} . W_k + b_k)
  kOutput,     // y = h_L1 . W_out + b_out, then dy (LayerNorm backward)
  kBack,       // da_{k-1} = (da_k . W_k^T) where h_{k-1} > 0
  kBackPlain,  // d_e0 = dz . W_e^T                                 (fold)
};

struct PassArgs {
  const float* x;     // (E, kW) the product's input rows
  const float* w;     // (kW, kW) the weight, (in, out)
  const float* bias;  // (kW) kFirst, kForward, kOutput
  const float* mask;  // (E, kW) kBack: the output is kept where mask > 0
  float* out;         // (E, kW)
  const float* pxj;   // kFirst
  const float* pxi;   // kFirst
  const int* senders;  // kFirst
  const int* rowptr;   // kFirst, kOutput
  const float* g;      // kOutput: (N, kW) the output's cotangent
  const float* ln_s;   // kOutput
  float* ln_part;      // kOutput: block b writes its d_ln_s, d_ln_b sums
                       // (2 kW floats) at ln_part + b * 2 kW
  int n_nodes, n_edges;
};

// the weight's row stride: forward passes read W[k][n] down the rows of k,
// backward passes W[n][k] along them; each stride keeps its reads free of
// bank conflicts
template <Pass P>
__host__ __device__ constexpr int weight_ld() {
  return P == kBack || P == kBackPlain ? kLd : kLdT;
}

// shared memory: the weight (68-70 KB), two input tiles and the tile's
// indices: 103 KB, so that two blocks share an SM
template <Pass P>
__host__ __device__ constexpr int pass_smem_floats() {
  return kW * weight_ld<P>() + 2 * kTile + 2 * kTE;
}

// One pass: a persistent block keeps the layer's weight in shared memory
// for the whole launch and walks 32-edge tiles, each tile's input rows
// fetched with cp.async into a second buffer while the previous tile
// computes; the product is a tf32x3 32 x 128 tile (a warp owns 16
// columns), split as its fragments are loaded.
template <Pass P>
__global__ void __launch_bounds__(kThreads, 2) edge_pass_kernel(PassArgs a) {
  using namespace tf32x3;
  constexpr bool kBwd = P == kBack || P == kBackPlain;
  constexpr int ldw = weight_ld<P>();
  extern __shared__ __align__(16) float w128_smem[];
  float* s_w = w128_smem;
  float* s_x = s_w + kW * ldw;   // two tiles (kOutput: then y, xhat)
  int* s_snd = reinterpret_cast<int*>(s_x + 2 * kTile);
  int* s_rcv = s_snd + kTE;
  const int tid = threadIdx.x, warp = tid >> 5;
  const Raw w_op = kBwd ? Raw{s_w, 1, ldw} : Raw{s_w, ldw, 1};  // W^T or W

  for (int k = tid; k < kW * kW / 4; k += kThreads)
    *reinterpret_cast<float4*>(s_w + (k >> 5) * ldw + (k & 31) * 4) =
        __ldg(reinterpret_cast<const float4*>(a.w) + k);

  const int n_tiles = (a.n_edges + kTE - 1) / kTE;
  auto prefetch = [&](int tile, int buf) {
    const int base = tile * kTE, n_valid = min(kTE, a.n_edges - base);
    rows_async<kTE>(s_x + buf * kTile, kLd, a.x, [&](int r) {
      return r < n_valid ? a.x + (size_t)(base + r) * kW : nullptr;
    });
    cp_async_commit();
  };
  float acc_ln = 0.f;  // kOutput: tid < kW d_ln_s[tid], else d_ln_b[tid - kW]

  if ((int)blockIdx.x < n_tiles) prefetch(blockIdx.x, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int cur = it & 1;
    const int base = tile * kTE, n_valid = min(kTE, a.n_edges - base);
    const float* x = s_x + cur * kTile;
    if (tile + (int)gridDim.x < n_tiles)
      prefetch(tile + gridDim.x, cur ^ 1);
    else
      cp_async_commit();  // an empty group keeps the count
    if ((P == kFirst || P == kOutput) && warp == 0) {
      const int rv =
          tile128::warp_receiver(a.rowptr, a.n_nodes, base, n_valid);
      const bool valid = tid < n_valid;
      s_snd[tid] = P == kFirst && valid ? a.senders[base + tid] : 0;
      s_rcv[tid] = valid ? rv : 0;
    }
    cp_async_wait<1>();
    __syncthreads();

    // what the epilogue reads from device memory, loaded before the product
    // so that the loads' latency hides behind it: the bias and, kFirst, the
    // gathered node rows, added after the product; kBack, the mask
    float pre[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = acc_row(16 * mi, c);
          const int n = acc_col(16 * warp + 8 * ni, c);
          float v = 0.f;
          if (P == kFirst && e < n_valid)
            v = __ldg(a.bias + n) + __ldg(a.pxj + (size_t)s_snd[e] * kW + n) +
                __ldg(a.pxi + (size_t)s_rcv[e] * kW + n);
          else if (P == kForward || P == kOutput)
            v = __ldg(a.bias + n);
          else if (P == kBack && e < n_valid)
            v = __ldg(a.mask + (size_t)(base + e) * kW + n);
          pre[mi][ni][c] = v;
        }
    float acc[2][2][4] = {};
    mm_rows32<kW>(acc, Raw{x, kLd, 1}, w_op);
    if (P == kFirst || P == kForward || P == kOutput)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] += pre[mi][ni][c];

    if (P != kOutput) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // elements 2h, 2h + 1: one row
            const int e = acc_row(16 * mi, 2 * h);
            if (e >= n_valid) continue;
            const size_t o =
                (size_t)(base + e) * kW + acc_col(16 * warp + 8 * ni, 0);
            float2 v = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
            if (P == kFirst || P == kForward) {
              v.x = fmaxf(v.x, 0.f);
              v.y = fmaxf(v.y, 0.f);
            } else if (P == kBack) {
              v.x = pre[mi][ni][2 * h] > 0.f ? v.x : 0.f;
              v.y = pre[mi][ni][2 * h + 1] > 0.f ? v.y : 0.f;
            }
            *reinterpret_cast<float2*>(a.out + o) = v;
          }
    } else {
      // y over the input tile, once every warp has read it
      float* s_y = s_x + cur * kTile;
      __syncthreads();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s_y[acc_row(16 * mi, c) * kLd + acc_col(16 * warp + 8 * ni, c)] =
                acc[mi][ni][c];
      __syncthreads();
      // LayerNorm backward, eight threads per edge: the row's mean and rstd,
      // xhat over y in place, and
      // dy = rstd * (dx - mean(dx) - xhat * mean(dx * xhat)), dx = g * ln_s
      constexpr int CP = kW / 8;
      const int le = tid >> 3, c0 = (tid & 7) * CP;
      const bool valid = le < n_valid;
      const float* gp = a.g + (size_t)s_rcv[le] * kW + c0;
      float v[CP], gv[CP];
      float mu = 0.f, m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        v[c] = s_y[le * kLd + c0 + c];
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
      const float rstd = rsqrtf(var + kLnEps);
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        v[c] = (v[c] - mu) * rstd;  // xhat
        s_y[le * kLd + c0 + c] = v[c];
        const float dx = gv[c] * __ldg(a.ln_s + c0 + c);
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
      if (valid) {
        float* dy = a.out + (size_t)(base + le) * kW + c0;
#pragma unroll
        for (int c = 0; c < CP; c += 4) {
          float4 d;
          d.x = rstd * (gv[c] * __ldg(a.ln_s + c0 + c) - m1 - v[c] * m2);
          d.y = rstd * (gv[c + 1] * __ldg(a.ln_s + c0 + c + 1) - m1 -
                        v[c + 1] * m2);
          d.z = rstd * (gv[c + 2] * __ldg(a.ln_s + c0 + c + 2) - m1 -
                        v[c + 2] * m2);
          d.w = rstd * (gv[c + 3] * __ldg(a.ln_s + c0 + c + 3) - m1 -
                        v[c + 3] * m2);
          *reinterpret_cast<float4*>(dy + c) = d;
        }
      }
      __syncthreads();  // xhat written
      // d_ln_s, d_ln_b: column sums over the tile's edges, one thread each
      const int c = tid & (kW - 1);
      float s = 0.f;
      for (int e = 0; e < n_valid; ++e) {
        const float ge = __ldg(a.g + (size_t)s_rcv[e] * kW + c);
        s += tid < kW ? ge * s_y[e * kLd + c] : ge;
      }
      acc_ln += s;
    }
    __syncthreads();  // before the next prefetch overwrites this tile
  }
  cp_async_wait<0>();
  if (P == kOutput) a.ln_part[(size_t)blockIdx.x * 2 * kW + tid] = acc_ln;
}

// h_0 = relu(src[e] + pxi[r]), plus pxj[s] for the pe entry: the
// pregathered and pe entries' first layer, one warp per edge.
template <Entry E>
__global__ void __launch_bounds__(kThreads) first_input_kernel(
    const float* __restrict__ src, const float* __restrict__ pxj,
    const float* __restrict__ pxi, const int* __restrict__ senders,
    const int* __restrict__ rowptr, float* __restrict__ h0, int n_nodes,
    int n_edges) {
  const int lane = threadIdx.x & 31;
  for (int e = (blockIdx.x * kThreads + threadIdx.x) >> 5; e < n_edges;
       e += (gridDim.x * kThreads) >> 5) {
    const int r = tile128::receiver_of(rowptr, n_nodes, e);
    float4 z = __ldg(reinterpret_cast<const float4*>(src + (size_t)e * kW) + lane);
    const float4 q =
        __ldg(reinterpret_cast<const float4*>(pxi + (size_t)r * kW) + lane);
    z.x += q.x;
    z.y += q.y;
    z.z += q.z;
    z.w += q.w;
    if (E == kPe) {
      const float4 p = __ldg(
          reinterpret_cast<const float4*>(pxj + (size_t)senders[e] * kW) + lane);
      z.x += p.x;
      z.y += p.y;
      z.z += p.z;
      z.w += p.w;
    }
    z.x = fmaxf(z.x, 0.f);
    z.y = fmaxf(z.y, 0.f);
    z.z = fmaxf(z.z, 0.f);
    z.w = fmaxf(z.w, 0.f);
    reinterpret_cast<float4*>(h0 + (size_t)e * kW)[lane] = z;
  }
}

// d_pxi[r] += dz over the receivers (one atomicAdd per run of equal
// receivers in each half of a 32-edge tile) and, fold, d_pxj[s] += dz with
// one atomicAdd per element.
template <bool FOLD>
__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const float* __restrict__ dz, const int* __restrict__ senders,
    const int* __restrict__ rowptr, float* __restrict__ d_pxj,
    float* __restrict__ d_pxi, int n_nodes, int n_edges) {
  __shared__ int s_snd[kTE], s_rcv[kTE];
  const int tid = threadIdx.x, n = tid & (kW - 1);
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    if (tid < kTE) {  // warp 0
      const int rv = tile128::warp_receiver(rowptr, n_nodes, base, n_valid);
      if (tid < n_valid) {
        s_snd[tid] = FOLD ? senders[base + tid] : 0;
        s_rcv[tid] = rv;
      }
    }
    __syncthreads();
    constexpr int kHalf = kTE / 2;
    const int e_beg = (tid >> 7) * kHalf;
    const int e_end = min(e_beg + kHalf, n_valid);
    if (e_beg < e_end) {
      int at = s_rcv[e_beg];
      float s = 0.f;
      for (int e = e_beg; e < e_end; ++e) {
        const float v = __ldg(dz + (size_t)(base + e) * kW + n);
        if (FOLD) atomicAdd(d_pxj + (size_t)s_snd[e] * kW + n, v);
        if (s_rcv[e] != at) {
          atomicAdd(d_pxi + (size_t)at * kW + n, s);
          s = 0.f;
          at = s_rcv[e];
        }
        s += v;
      }
      atomicAdd(d_pxi + (size_t)at * kW + n, s);
    }
    __syncthreads();
  }
}

// The packed weight-gradient layout, in floats; d_ln_s and d_ln_b follow
// at ls.
struct Packed {
  int we, be, wr, br, wo, bo, ls;
  __host__ __device__ Packed(bool fold, int l1) {
    we = 0;
    be = we + (fold ? kW * kW : 0);
    wr = be + (fold ? kW : 0);
    br = wr + l1 * kW * kW;
    wo = br + l1 * kW;
    bo = wo + kW * kW;
    ls = bo + kW;
  }
};

constexpr int kMaxPairs = 5;  // W_e, three tail weights, W_out

// Kernel (b): dW = sum_e A[e]^T D[e] and db = sum_e D[e] for each weight
// (blockIdx.y) over one edge range (blockIdx.x); the block writes its
// partial at partial + blockIdx.x * stride + off_w / off_b.
struct WgradArgs {
  const float* a[kMaxPairs];  // (E, kW) the layer's input rows
  const float* d[kMaxPairs];  // (E, kW) its output's gradient rows
  int off_w[kMaxPairs], off_b[kMaxPairs];
  float* partial;
  int stride, chunk, n_edges;
};

constexpr int kSlab = 32;  // edges per slab of kernel (b)
constexpr int kSlabTile = kSlab * kLdT;

// A 128 x 128 tf32x3 product over each 32-edge slab, both slabs read down
// their columns (hence the kLdT stride), split as fragments are loaded; 64
// f32 accumulators a thread over the block's whole edge range; slabs
// double-buffered with cp.async (70 KB: two blocks share an SM).
__global__ void __launch_bounds__(kThreads, 1) wgrad_kernel(WgradArgs args) {
  using namespace tf32x3;
  extern __shared__ __align__(16) float w128_smem[];
  float* s_a = w128_smem;                  // two slabs
  float* s_d = w128_smem + 2 * kSlabTile;  // two slabs
  __shared__ float s_bsum[kW];
  const int tid = threadIdx.x, warp = tid >> 5, pair = blockIdx.y;
  const float* A = args.a[pair];
  const float* D = args.d[pair];
  const int e_beg = blockIdx.x * args.chunk;
  const int e_end = min(args.n_edges, e_beg + args.chunk);
  const int n_slabs = e_end > e_beg ? (e_end - e_beg + kSlab - 1) / kSlab : 0;
  auto prefetch = [&](int slab, int buf) {
    const int base = e_beg + slab * kSlab;
    rows_async<kSlab>(s_a + buf * kSlabTile, kLdT, A, [&](int r) {
      return base + r < e_end ? A + (size_t)(base + r) * kW : nullptr;
    });
    rows_async<kSlab>(s_d + buf * kSlabTile, kLdT, D, [&](int r) {
      return base + r < e_end ? D + (size_t)(base + r) * kW : nullptr;
    });
    cp_async_commit();
  };
  float acc[2][8][4] = {};
  float bsum = 0.f;  // column tid & 127 over rows (tid >> 7) * 16 .. + 15
  if (n_slabs > 0) prefetch(0, 0);
  for (int slab = 0; slab < n_slabs; ++slab) {
    const int cur = slab & 1;
    if (slab + 1 < n_slabs)
      prefetch(slab + 1, cur ^ 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* a = s_a + cur * kSlabTile;
    const float* d = s_d + cur * kSlabTile;
    mm_square128<kSlab>(acc, Raw{a, 1, kLdT}, Raw{d, kLdT, 1});  // A^T . D
    for (int e = (tid >> 7) * 16; e < (tid >> 7) * 16 + 16; ++e)
      bsum += d[e * kLdT + (tid & (kW - 1))];
    __syncthreads();  // before the next prefetch overwrites this slab
  }
  cp_async_wait<0>();
  float* p = args.partial + (size_t)blockIdx.x * args.stride;
  float* pw = p + args.off_w[pair];
  const int m0 = 32 * (warp & 3), n0 = 64 * (warp >> 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        pw[acc_row(m0 + 16 * mi, c) * kW + acc_col(n0 + 8 * ni, c)] =
            acc[mi][ni][c];
  if (tid >= kW) s_bsum[tid - kW] = bsum;
  __syncthreads();
  if (tid < kW) p[args.off_b[pair] + tid] = bsum + s_bsum[tid];
}

// Resident blocks of `kernel` per SM and the SM count on the current device
// at `smem` bytes of dynamic shared memory; the opt-in and the queries run
// once per device and kernel.
template <auto Kernel>
cudaError_t resident(size_t smem, int* per_sm, int* n_sm) {
  static std::atomic<int> cache[kMaxDevices];  // per_sm << 16 | n_sm; 0 unset
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int v = device < kMaxDevices ? cache[device].load(std::memory_order_relaxed)
                               : 0;
  if (v == 0) {
    int sms = 0, blocks = 0;
    if ((err = cudaFuncSetAttribute(Kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, Kernel, kThreads, smem)) != cudaSuccess)
      return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    v = blocks << 16 | sms;
    if (device < kMaxDevices) cache[device].store(v, std::memory_order_relaxed);
  }
  *per_sm = v >> 16;
  *n_sm = v & 0xffff;
  return cudaSuccess;
}

// One pass over every edge on a persistent grid of at most `max_blocks`
// blocks (0: as many as are resident); returns the blocks launched.
template <Pass P>
cudaError_t run_pass(const PassArgs& a, int max_blocks, cudaStream_t stream,
                     int* launched = nullptr) {
  const size_t smem = sizeof(float) * (size_t)pass_smem_floats<P>();
  int per_sm = 0, n_sm = 0;
  cudaError_t err = resident<edge_pass_kernel<P>>(smem, &per_sm, &n_sm);
  if (err != cudaSuccess) return err;
  const int n_tiles = (a.n_edges + kTE - 1) / kTE;
  int blocks = per_sm * n_sm;
  if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
  if (blocks > n_tiles) blocks = n_tiles;
  if (launched) *launched = blocks;
  if (blocks == 0) return cudaSuccess;
  edge_pass_kernel<P><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The backward as one launch sequence: kernel (a) as 2 L1 + 4 passes
// (pregathered, pe: an elementwise first layer and 2 L1 + 2 passes) that
// recompute h_0..h_L1, run LayerNorm's backward and the data gradients down
// to dz, each h_k and each layer's output gradient written to `scratch`;
// the scatter of dz; kernel (b) for every weight gradient; the fixed-order
// sums of the block partials.
template <Entry E>
int launch(const float* src, const float* we, const float* be,
           const float* pxj, const float* pxi, const int* senders,
           const int* rowptr, const float* w_rest, const float* b_rest,
           const float* w_out, const float* b_out, const float* ln_s,
           const float* g, float* d_src, float* d_pxj, float* d_pxi,
           float* wgrad_out, float* partial, float* scratch, int n_nodes,
           int n_edges, int l1, int scratch_blocks, cudaStream_t stream) {
  constexpr bool FOLD = E == kFold;
  const Packed L(FOLD, l1);
  const size_t plane = (size_t)n_edges * kW;
  if (n_nodes == 0) n_edges = 0;
  // act[k] = h_k, k = 0..L1; grad[k] = da_k (grad[0] = dz, grad[L1 + 1] =
  // dy); the pregathered and pe entries' dz is their d_src
  float* act[4];
  float* grad[5];
  for (int k = 0; k <= l1; ++k) act[k] = scratch + k * plane;
  float* next = scratch + (l1 + 1) * plane;
  for (int k = 0; k <= l1 + 1; ++k) {
    if (k == 0 && !FOLD) {
      grad[0] = d_src;
      continue;
    }
    grad[k] = next;
    next += plane;
  }
  const float* w_of[5];  // w_of[k]: the weight whose output gradient is grad[k]
  const float* b_of[5];
  w_of[0] = we;
  b_of[0] = be;
  for (int k = 1; k <= l1; ++k) {
    w_of[k] = w_rest + (size_t)(k - 1) * kW * kW;
    b_of[k] = b_rest + (size_t)(k - 1) * kW;
  }
  w_of[l1 + 1] = w_out;
  b_of[l1 + 1] = b_out;

  PassArgs a{};
  a.pxj = pxj;
  a.pxi = pxi;
  a.senders = senders;
  a.rowptr = rowptr;
  a.g = g;
  a.ln_s = ln_s;
  // the LN pass's block partials follow the planes in the scratch
  float* ln_part = next;
  a.ln_part = ln_part;
  a.n_nodes = n_nodes;
  a.n_edges = n_edges;
  cudaError_t err = cudaSuccess;
  int ln_blocks = 0;
  if (n_edges > 0) {
    // recompute h_0
    if (FOLD) {
      a.x = src;
      a.w = we;
      a.bias = be;
      a.out = act[0];
      if ((err = run_pass<kFirst>(a, 0, stream)) != cudaSuccess)
        return (int)err;
    } else {
      int per_sm = 0, n_sm = 0;
      if ((err = resident<first_input_kernel<E>>(0, &per_sm, &n_sm)) !=
          cudaSuccess)
        return (int)err;
      first_input_kernel<E><<<per_sm * n_sm, kThreads, 0, stream>>>(
          src, pxj, pxi, senders, rowptr, act[0], n_nodes, n_edges);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    // h_1..h_L1
    for (int k = 1; k <= l1; ++k) {
      a.x = act[k - 1];
      a.w = w_of[k];
      a.bias = b_of[k];
      a.out = act[k];
      if ((err = run_pass<kForward>(a, 0, stream)) != cudaSuccess)
        return (int)err;
    }
    // y, then dy and the blocks' d_ln_s, d_ln_b (one partial row a block)
    a.x = act[l1];
    a.w = w_out;
    a.bias = b_out;
    a.out = grad[l1 + 1];
    if ((err = run_pass<kOutput>(a, 2 * scratch_blocks, stream,
                                 &ln_blocks)) !=
        cudaSuccess)
      return (int)err;
    // da_L1 .. da_0 = dz
    for (int k = l1 + 1; k >= 1; --k) {
      a.x = grad[k];
      a.w = w_of[k];
      a.mask = act[k - 1];
      a.out = grad[k - 1];
      if ((err = run_pass<kBack>(a, 0, stream)) != cudaSuccess)
        return (int)err;
    }
    if (FOLD) {  // d_e0 = dz . W_e^T
      a.x = grad[0];
      a.w = we;
      a.out = d_src;
      if ((err = run_pass<kBackPlain>(a, 0, stream)) != cudaSuccess)
        return (int)err;
    }
    int per_sm = 0, n_sm = 0;
    if ((err = resident<scatter_kernel<FOLD>>(0, &per_sm, &n_sm)) !=
        cudaSuccess)
      return (int)err;
    const int n_tiles = (n_edges + kTE - 1) / kTE;
    const int sblocks = n_tiles < per_sm * n_sm ? n_tiles : per_sm * n_sm;
    scatter_kernel<FOLD><<<sblocks, kThreads, 0, stream>>>(
        grad[0], senders, rowptr, d_pxj, d_pxi, n_nodes, n_edges);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  // kernel (b): one partial row per edge range, as many ranges as fill the
  // card once (at most scratch_blocks rows)
  WgradArgs wa{};
  int pairs = 0;
  for (int k = FOLD ? 0 : 1; k <= l1 + 1; ++k, ++pairs) {
    wa.a[pairs] = k == 0 ? src : act[k - 1];
    wa.d[pairs] = grad[k];
    wa.off_w[pairs] = k == 0 ? L.we : k <= l1 ? L.wr + (k - 1) * kW * kW : L.wo;
    wa.off_b[pairs] = k == 0 ? L.be : k <= l1 ? L.br + (k - 1) * kW : L.bo;
  }
  int splits = 0;
  if (n_edges > 0) {
    const size_t smem = sizeof(float) * 4 * (size_t)kSlabTile;
    int per_sm = 0, n_sm = 0;
    if ((err = resident<wgrad_kernel>(smem, &per_sm, &n_sm)) != cudaSuccess)
      return (int)err;
    int want = per_sm * n_sm / pairs;
    if (want > scratch_blocks) want = scratch_blocks;
    if (want < 1) want = 1;
    const int n_slabs = (n_edges + kSlab - 1) / kSlab;
    wa.chunk = (n_slabs + want - 1) / want * kSlab;
    splits = (n_edges + wa.chunk - 1) / wa.chunk;
    wa.partial = partial;
    wa.stride = L.ls;
    wa.n_edges = n_edges;
    wgrad_kernel<<<dim3(splits, pairs), kThreads, smem, stream>>>(wa);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  reduce_partials_kernel<<<(L.ls + 255) / 256, 256, 0, stream>>>(
      partial, wgrad_out, splits, L.ls);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<1, 2 * kW, 0, stream>>>(
      ln_part, wgrad_out + L.ls, ln_blocks, 2 * kW);
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
// that many floats; scratch (width 128 only, else ignored) holds
// (2 l1 + 3) (fold) or (2 l1 + 2) planes of n_edges x 128 floats, then
// 2 scratch_blocks rows of 256.  Every float array is 16-byte aligned.
// The compiled builds are those of the header, each for
// l1 in 0..3; others return cudaErrorInvalidValue.
int fused_edge_tail_agg_bwd_f32(
    const float* src, const float* we, const float* be, const float* pxj,
    const float* pxi, const int* senders, const int* rowptr,
    const float* w_rest, const float* b_rest, const float* w_out,
    const float* b_out, const float* ln_s, const float* g, float* d_src,
    float* d_pxj, float* d_pxi, float* wgrad, float* partial, float* scratch,
    int n_nodes, int n_edges, int ce, int h, int c, int l1, int entry,
    int scratch_blocks, void* stream) {
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
  if (wide && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (entry == kFold && ce == 128 && wide)
    return w128::launch<kFold>(src, we, be, pxj, pxi, senders, rowptr, w_rest,
                               b_rest, w_out, b_out, ln_s, g, d_src, d_pxj,
                               d_pxi, wgrad, partial, scratch, n_nodes, n_edges,
                               l1, scratch_blocks, s);
  if (entry == kPregathered && wide)
    return w128::launch<kPregathered>(
        src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
        ln_s, g, d_src, d_pxj, d_pxi, wgrad, partial, scratch, n_nodes, n_edges,
        l1, scratch_blocks, s);
  if (entry == kPe && wide)
    return w128::launch<kPe>(src, we, be, pxj, pxi, senders, rowptr, w_rest,
                             b_rest, w_out, b_out, ln_s, g, d_src, d_pxj,
                             d_pxi, wgrad, partial, scratch, n_nodes, n_edges,
                             l1, scratch_blocks, s);
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
