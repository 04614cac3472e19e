// Fused InteractionNetwork edge pipeline, bf16 operands, in three entries:
// fold at (Ce, H, C) = (32, 64, 32), pre-gathered and pe at (H, C) = (64,
// 32), forward and backward, L1 in 0..3.
//
// Replaces the TPU kernels of magnet_tpu/ops/pallas_kernels.py on bf16
// operands (the JAX models' graph_dtype=bf16, whose GraphNet stage rounds
// its inputs and weights to bf16; ln_s and ln_b stay f32):
//   * fold: _fused2r_fwd_pallas (#8) and _fused2r_bwd_pallas (#9, with
//     dpxj_in_kernel=True) as the fold-e public entry fused_edge_tail_agg2rf
//     calls them (operands e0, W_e with the edge scale folded in, b_e, pxj,
//     pxi, W_k, b_k, W_out, b_out);
//   * pregathered: _fused_fwd_pallas (#2) and _fused_bwd_pallas (#3), the
//     public entry fused_edge_tail_agg (operands h0, the first layer's input
//     gathered per edge by the caller, pxi, W_k, b_k, W_out, b_out);
//   * pe: _fused2_fwd_pallas (#6) and _fused2_bwd_pallas (#7) with its VJP
//     _fused2_bwd, the public entry fused_edge_tail_agg2 (operands pe, the
//     edge projection formed per edge by the caller, pxj gathered in the
//     kernel, pxi, W_k, b_k, W_out, b_out).
// The arithmetic is the TPU kernels', rounding where they round:
//
//   forward, for every edge j -> i of a receiver-grouped CSR graph
//     z    = f32(e0[e] . W_e) + b_e + pxj[j] + pxi[i]      (fold, f32)
//     z    = h0[e] + pxi[i]                                (pregathered, f32)
//     z    = (pe[e] + pxj[j]) + pxi[i]                     (pe, f32)
//     h_0  = bf16(relu(z));  h_k = bf16(relu(f32(h_{k-1} . W_k) + b_k))
//     y    = f32(h_L1 . W_out) + b_out;  y = LayerNorm(y)  (f32, two-pass)
//     out[i] = sum over the edges of i of bf16(y), in f32     (N, C) f32
//   backward, given g (N, C) f32, with the activations recomputed
//     d_out = bf16(g[i]); LayerNorm's backward in f32 to dy;
//     dW_out = h_L1^T . bf16(dy), db_out = sum dy (f32);
//     da_L1 = (bf16(dy) . W_out^T) [h_L1 > 0];
//     dW_k = h_{k-1}^T . bf16(da_k), db_k = sum da_k,
//     da_{k-1} = (bf16(da_k) . W_k^T) [h_{k-1} > 0];   dz = da_0;
//     fold: d_e0 = bf16(bf16(dz) . W_e^T) (E, Ce) bf16;
//           dW_e = e0^T . bf16(dz), db_e = sum dz;  d_pxj[j] += bf16(dz);
//     pregathered: d_h0 = bf16(dz) (E, H) bf16;
//     pe: d_pe = bf16(dz) (E, H) bf16 and dz (E, H) f32 unrounded, from
//         which the caller sums d_pxj over the sender CSR (the f32 segment
//         sum, then one rounding, as the JAX VJP reduces it);
//     d_pxi[i] += bf16(dz) (f32 sums);
//     d_ln_s = sum bf16(g) xhat, d_ln_b = sum bf16(g);
// every product on bf16 operands with f32 accumulation, every weight
// gradient summed in f32; the caller casts each gradient to its operand's
// dtype, as the JAX VJPs do.  The plain versions are
// magnet_tpu_torch/ops/fused_edge.py:fused_edge_tail_agg_bf16_plain /
// _bwd_plain (fold), fused_edge_tail_agg_pregathered_bf16_plain /
// _bwd_plain and fused_edge_tail_agg_pe_bf16_plain / _bwd_plain.
//
// Design: the f32 builds' walk (csrc/fused_edge_tail_agg.cu and
// fused_edge_tail_agg_bwd.cu, namespace w64), with bf16 products; one
// template per kernel holds the three entries (an Entry value):
//   * persistent blocks walk consecutive tiles of TE = 64 CSR edges
//     (tile128::block_tiles); warps 0 and 1 find the next tile's receivers
//     and senders from the last receiver of this one (tile_indices); the
//     forward sums each run of equal receivers in CSR order and leaves
//     partial rows for the receivers that cross a tile (csr_tile), so its
//     result has the same bits from run to run;
//   * every product is mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32, one
//     product where the f32 builds issue three TF32 ones; warp w forms 16
//     rows and 8 NI columns of each (64 x N) result (Prod);
//   * every weight stays in shared memory as bf16 for the whole launch,
//     half the f32 builds' footprint: transposed (row n holds column n)
//     for the products h . W, and, in the backward, also as stored for the
//     data gradients da . W^T, so that every weight fragment is one 32-bit
//     load of two neighbouring bf16 values;
//   * the shared tiles' rows are padded by 16 bytes (bf16 rows of 72 or 40
//     elements, f32 rows of 68 or 36), which spreads a warp's fragment
//     loads over the 32 banks; fragments of a tile read down its columns
//     (the weight gradients' A and B) are gathered by 16-bit loads;
//   * activations h_k are bf16 tiles; the data gradients, which the bias
//     gradients sum unrounded, are f32 tiles rounded to bf16 as the
//     products load them (two tiles, one read while the other is written);
//     LayerNorm and the receiver sums are f32;
//   * backward: each tile's weight gradient is formed in fresh
//     accumulators and added to f32 running sums in registers; a block
//     writes its partial sums once and a second kernel adds the blocks'
//     partials in block order, so the weight gradients and d_e0 are the
//     same from run to run; d_pxj and d_pxi are f32 atomics (one per
//     element for d_pxj, one per run of equal receivers in an eighth of a
//     tile for d_pxi), whose last f32 bits vary before the caller's
//     rounding to bf16;
//   * pregathered: h_0 is formed elementwise from the tile's h0 rows and
//     its receivers' pxi rows (16-byte loads), in place of the fold's
//     first product; there is no W_e, e0, pxj or sender, and the backward
//     writes d_h0 = bf16(dz) per edge with plain stores (its d_pxi as the
//     fold's);
//   * pe: as pregathered, with the sender row of pxj added to each pe row
//     before pxi's (16-byte loads of all three, the order of the TPU
//     kernel's pe + g0 + gath); the sender ids are staged beside the
//     receivers, as the fold's; the backward writes d_pe = bf16(dz) and the
//     unrounded dz with plain stores (no d_pxj atomics: the caller's
//     segment sum over the sender CSR reads dz).
// Forward: 256 threads, 63,104 bytes of shared memory at L1 = 3 (every
// entry: the pre-gathered and pe ones leave the fold's W_e and e0 tiles
// unused), two blocks an SM.  Backward: 512 threads, 172,288 bytes at L1
// = 3 (fold) and 152,064 (pregathered and pe), one block an SM.
// fused_edge_tail_agg_bf16_smem reports each for each L1.
// What bounds it on an H100: Ce H + L1 H^2 + H C = 16,384 multiply-adds an
// edge at L1 = 3 in the fold forward, three times that in the backward; at
// MAgNet[CNN] 1D's eval graph (186,624 edges) 6.1 GFLOP, 0.0062 ms at the
// dense bf16 rate of 989 TFLOP/s, against 11.9 MB of e0 (0.0036 ms at 3.35
// TB/s): bound by operations.  The pregathered forward does L1 H^2 + H C =
// 14,336 an edge and reads an (E, 64) bf16 h0: at MAgNet[CNN] 2D's
// training graph (299,894 edges) 8.6 GFLOP (0.0087 ms) against 38.4 MB of
// h0 (0.0115 ms): bound by bytes.  The pe forward does the same work and
// reads an (E, 64) bf16 pe: at 1D's eval graph 23.9 MB (0.0071 ms) against
// 5.35 GFLOP (0.0054 ms), bound by bytes; its backward moves ~512 B an edge
// (pe, d_pe, dz), 0.010 ms at 1D's training graph (67,680 edges).  mma.sync and not wgmma, as in the f32
// builds: the products read their operands from padded tiles at any
// stride, transposed or not.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (magnet_tpu_torch/ops/cuda_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "tile_mm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tile128::Entry;
using tile128::kFold;
using tile128::kPe;
using tile128::kPregathered;

constexpr float kLnEps = 1e-5f;
constexpr int kTE = 64;         // edges per tile
constexpr int kCe = 32;         // the edge-latent width
constexpr int kH = 64;          // hidden width
constexpr int kC = 32;          // output width
constexpr int kLdH = kH + 8;    // bf16 rows of kH, padded
constexpr int kLdC = kC + 8;    // bf16 rows of kCe = kC, padded
constexpr int kLdHf = kH + 4;   // f32 rows of kH, padded
constexpr int kLdCf = kC + 4;   // f32 rows of kC, padded
constexpr int kMaxDevices = 64;
constexpr int kMaxL1 = 3;

static_assert(kCe == kC, "the e0 tiles and the (., kC) tiles share a stride");

// ---- bf16 products on the tensor cores -----------------------------------
//
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, lane = 4 g + t:
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//                a3 (g + 8, 2t + 8..)
//   B (16 x 8):  b0 (2t..2t+1, g), b1 (2t + 8.., g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// each register holding two bf16 values, the lower index in its low half.

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
// two f32 values rounded to bf16 (to nearest, ties to even), lo first
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 unpack(uint32_t a) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
}
// bf16(relu(f32(a) + f32(b))) of two pairs of bf16 values
__device__ __forceinline__ uint32_t relu_sum(uint32_t a, uint32_t b) {
  const float2 x = unpack(a), y = unpack(b);
  return pack_rn(fmaxf(x.x + y.x, 0.f), fmaxf(x.y + y.y, 0.f));
}
// bf16(relu((f32(a) + f32(j)) + f32(b))) of three pairs of bf16 values
__device__ __forceinline__ uint32_t relu_sum3(uint32_t a, uint32_t j,
                                              uint32_t b) {
  const float2 x = unpack(a), z = unpack(j), y = unpack(b);
  return pack_rn(fmaxf((x.x + z.x) + y.x, 0.f), fmaxf((x.y + z.y) + y.y, 0.f));
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A operands: rows m0.., columns k0.. (16 x 16) of A(m, k).
struct ARows {  // A(m, k) = p[m ld + k], bf16
  const bf16* p;
  int ld;
  __device__ __forceinline__ void load(uint32_t (&r)[4], int m0,
                                       int k0) const {
    const bf16* q = p + (m0 + lane_g()) * ld + k0 + 2 * lane_t();
    r[0] = ld32(q);
    r[1] = ld32(q + 8 * ld);
    r[2] = ld32(q + 8);
    r[3] = ld32(q + 8 * ld + 8);
  }
};
struct ACols {  // A(m, k) = p[k ld + m], bf16 (a tile read down its columns)
  const bf16* p;
  int ld;
  __device__ __forceinline__ void load(uint32_t (&r)[4], int m0,
                                       int k0) const {
    const bf16* q = p + (k0 + 2 * lane_t()) * ld + m0 + lane_g();
    r[0] = pack(q[0], q[ld]);
    r[1] = pack(q[8], q[ld + 8]);
    r[2] = pack(q[8 * ld], q[9 * ld]);
    r[3] = pack(q[8 * ld + 8], q[9 * ld + 8]);
  }
};
struct ARowsF {  // A(m, k) = bf16(p[m ld + k]), f32 in shared memory
  const float* p;
  int ld;
  __device__ __forceinline__ void load(uint32_t (&r)[4], int m0,
                                       int k0) const {
    const float* q = p + (m0 + lane_g()) * ld + k0 + 2 * lane_t();
    const float2 v0 = *reinterpret_cast<const float2*>(q);
    const float2 v1 = *reinterpret_cast<const float2*>(q + 8 * ld);
    const float2 v2 = *reinterpret_cast<const float2*>(q + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(q + 8 * ld + 8);
    r[0] = pack_rn(v0.x, v0.y);
    r[1] = pack_rn(v1.x, v1.y);
    r[2] = pack_rn(v2.x, v2.y);
    r[3] = pack_rn(v3.x, v3.y);
  }
};
// B operands: rows k0.. (16), columns n0.. (8) of B(k, n).
struct BNK {  // B(k, n) = p[n ld + k], bf16 (a weight transposed, or W^T)
  const bf16* p;
  int ld;
  __device__ __forceinline__ void load(uint32_t (&r)[2], int k0,
                                       int n0) const {
    const bf16* q = p + (n0 + lane_g()) * ld + k0 + 2 * lane_t();
    r[0] = ld32(q);
    r[1] = ld32(q + 8);
  }
};
struct BKNF {  // B(k, n) = bf16(p[k ld + n]), f32 in shared memory
  const float* p;
  int ld;
  __device__ __forceinline__ void load(uint32_t (&r)[2], int k0,
                                       int n0) const {
    const float* q = p + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
    r[0] = pack_rn(q[0], q[ld]);
    r[1] = pack_rn(q[8 * ld], q[9 * ld]);
  }
};

// The part of an (R x N) product that a warp of a block of WARPS forms:
// rows m0 .. m0 + 15 with m0 = 16 (w % (R / 16)), and NI tiles of 8
// columns from n0 = 8 NI (w / (R / 16)); acc[ni] is the 16 x 8 tile at
// column n0 + 8 ni.
template <int R, int N, int WARPS>
struct Prod {
  static constexpr int NI = R * N / (WARPS * 128);
  static_assert(NI >= 1 && R % 16 == 0 && WARPS % (R / 16) == 0 &&
                    NI * 8 * (WARPS / (R / 16)) == N,
                "the warps cover the result");
  float acc[NI][4];
  int m0, n0;

  __device__ __forceinline__ Prod() {
    const int w = threadIdx.x >> 5;
    m0 = 16 * (w % (R / 16));
    n0 = 8 * NI * (w / (R / 16));
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[ni][c] = 0.f;
  }
  __device__ __forceinline__ int row(int c) const {
    return m0 + lane_g() + 8 * (c >> 1);
  }
  __device__ __forceinline__ int col(int ni, int c) const {
    return n0 + 8 * ni + 2 * lane_t() + (c & 1);
  }
  // acc = f(row, column)
  template <class F>
  __device__ __forceinline__ void init(F f) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[ni][c] = f(row(c), col(ni, c));
  }
  // acc += A . B, A (R x K), B (K x N)
  template <int K, class OA, class OB>
  __device__ __forceinline__ void run(const OA& a, const OB& b) {
    static_assert(K % 16 == 0, "K in steps of 16");
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t fa[4];
      a.load(fa, m0, k0);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        uint32_t fb[2];
        b.load(fb, k0, n0 + 8 * ni);
        mma(acc[ni], fa, fb);
      }
    }
  }
  // f(row, column, v0, v1) on the thread's pairs of neighbouring columns
  template <class F>
  __device__ __forceinline__ void pairs(F f) const {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(row(2 * h), col(ni, 0), acc[ni][2 * h], acc[ni][2 * h + 1]);
  }
  // a bf16 tile (rows of ld) <- bf16(relu(acc))
  __device__ __forceinline__ void store_relu(bf16* t, int ld) const {
    pairs([&](int r, int c, float v0, float v1) {
      *reinterpret_cast<uint32_t*>(t + r * ld + c) =
          pack_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    });
  }
  // an f32 tile (rows of ld) <- acc, or where mask > 0 (a bf16 tile of
  // rows of mld) when mask is set
  __device__ __forceinline__ void store(float* t, int ld,
                                        const bf16* mask = nullptr,
                                        int mld = 0) const {
    pairs([&](int r, int c, float v0, float v1) {
      if (mask != nullptr) {
        const float2 m = ld_bf16x2(mask + r * mld + c);
        v0 = m.x > 0.f ? v0 : 0.f;
        v1 = m.y > 0.f ? v1 : 0.f;
      }
      *reinterpret_cast<float2*>(t + r * ld + c) = make_float2(v0, v1);
    });
  }
  // run += acc: a tile's weight gradient into the running sums
  __device__ __forceinline__ void add_to(float (&run)[NI][4]) const {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) run[ni][c] += acc[ni][c];
  }
  // out[row * N + column] = run, the running sums in this part's places
  __device__ __forceinline__ void write(float* out,
                                        const float (&run)[NI][4]) const {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[row(c) * N + col(ni, c)] = run[ni][c];
  }
};

// dst <- n_mat (K x N) bf16 weights w, transposed (row n of a matrix holds
// its column n) when TRANSPOSE, else as stored; rows of ld, matrices
// `stride` elements apart.
template <int K, int N, bool TRANSPOSE>
__device__ __forceinline__ void load_weights(bf16* dst,
                                             const bf16* __restrict__ w,
                                             int n_mat, int ld, int stride,
                                             int threads) {
  for (int i = threadIdx.x; i < n_mat * K * N; i += threads) {
    const int m = i / (K * N), k = (i / N) % K, n = i % N;
    dst[m * stride + (TRANSPOSE ? n * ld + k : k * ld + n)] = w[i];
  }
}

// n bf16 values to f32 in shared memory
__device__ __forceinline__ void load_f32(float* dst,
                                         const bf16* __restrict__ src, int n,
                                         int threads) {
  for (int i = threadIdx.x; i < n; i += threads)
    dst[i] = __bfloat162float(src[i]);
}

// Tile `tile`'s e0 rows (kCe bf16, 64 bytes each) into dst (rows of kLdC),
// zeros past the edge count, by cp.async; the caller commits.
__device__ __forceinline__ void stage_e0(bf16* dst,
                                         const bf16* __restrict__ e0,
                                         int n_edges, int tile, int threads) {
  constexpr int kPieces = kCe * 2 / 16;  // 16-byte pieces a row
  const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
  for (int p = threadIdx.x; p < kTE * kPieces; p += threads) {
    const int r = p / kPieces, c = (p % kPieces) * 8;
    const bool valid = r < n_valid;
    tf32x3::cp_async16(dst + r * kLdC + c,
                       valid ? e0 + (size_t)(base + r) * kCe + c : e0, valid);
  }
}

// z = b_e + pxj[sender] + pxi[receiver] at (e, n), zero past n_valid: the
// start of the first product's accumulators (bf16 rows of kH).
__device__ __forceinline__ float fold_z(const float* s_be,
                                        const bf16* __restrict__ pxj,
                                        const bf16* __restrict__ pxi,
                                        const int* snd, const int* rcv,
                                        int n_valid, int e, int n) {
  if (e >= n_valid) return 0.f;
  return s_be[n] + (__bfloat162float(pxj[(size_t)snd[e] * kH + n]) +
                    __bfloat162float(pxi[(size_t)rcv[e] * kH + n]));
}

// The pregathered entry's h_0 = bf16(relu(f32(h0[e]) + f32(pxi[rcv[e]]))),
// or (PE) the pe entry's bf16(relu((f32(pe[e]) + f32(pxj[snd[e]])) +
// f32(pxi[rcv[e]]))), of the tile's edges into dst (bf16 rows of kLdH),
// zeros past n_valid: 16-byte pieces of 8 columns, by a block of THREADS
// threads.  The rows of src, pxj and pxi start 16-byte aligned.
template <int THREADS, bool PE>
__device__ __forceinline__ void first_h0(bf16* dst,
                                         const bf16* __restrict__ src,
                                         const bf16* __restrict__ pxj,
                                         const bf16* __restrict__ pxi,
                                         const int* snd, const int* rcv,
                                         int n_valid, int base) {
  constexpr int kPieces = kH / 8;  // 16-byte pieces a row
  for (int p = threadIdx.x; p < kTE * kPieces; p += THREADS) {
    const int e = p / kPieces, c = (p % kPieces) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (e < n_valid) {
      const uint4 a = __ldg(
          reinterpret_cast<const uint4*>(src + (size_t)(base + e) * kH + c));
      const uint4 b = __ldg(
          reinterpret_cast<const uint4*>(pxi + (size_t)rcv[e] * kH + c));
      if constexpr (PE) {
        const uint4 j = __ldg(
            reinterpret_cast<const uint4*>(pxj + (size_t)snd[e] * kH + c));
        v = make_uint4(relu_sum3(a.x, j.x, b.x), relu_sum3(a.y, j.y, b.y),
                       relu_sum3(a.z, j.z, b.z), relu_sum3(a.w, j.w, b.w));
      } else {
        v = make_uint4(relu_sum(a.x, b.x), relu_sum(a.y, b.y),
                       relu_sum(a.z, b.z), relu_sum(a.w, b.w));
      }
    }
    *reinterpret_cast<uint4*>(dst + e * kLdH + c) = v;
  }
}

// The persistent grid's cap (SMs x resident blocks per SM) of `kernel` on
// the current device; the queries and the shared-memory opt-in run once per
// device (`cache`, zeros: unset).
template <class Kernel>
cudaError_t grid_cap(Kernel kernel, int threads, size_t smem,
                     std::atomic<int> (&cache)[kMaxDevices], int* cap) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && (*cap = cache[device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
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
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *cap = n_sm * per_sm;
  if (cached) cache[device].store(*cap, std::memory_order_relaxed);
  return cudaSuccess;
}

// ---- forward ---------------------------------------------------------------

namespace fwd {

constexpr int kThreads = 256;  // 8 warps, two blocks an SM
constexpr int kWarps = kThreads / 32;

// Offsets, in bytes, into dynamic shared memory; the tail weights last, so
// that the others do not move with L1.
struct Layout {
  static constexpr int act = 0;                          // (kTE, kLdH) bf16
  static constexpr int src = act + kTE * kLdH * 2;       // (kTE, kLdC) bf16
  static constexpr int y = src + kTE * kLdC * 2;         // (kTE, kLdCf) f32
  static constexpr int wte = y + kTE * kLdCf * 4;        // W_e^T (kH, kLdC)
  static constexpr int wto = wte + kH * kLdC * 2;        // W_out^T (kC, kLdH)
  static constexpr int be = wto + kC * kLdH * 2;         // (kH) f32
  static constexpr int bo = be + kH * 4;                 // (kC) f32
  static constexpr int rcv = bo + kC * 4;                // 2 x (kTE) int
  static constexpr int snd = rcv + 2 * kTE * 4;          // 2 x (kTE) int
  static constexpr int br = snd + 2 * kTE * 4;           // (L1, kH) f32
  __host__ __device__ static size_t bytes(int l1) {
    return (size_t)br + (size_t)l1 * (kH * 4 + kH * kLdH * 2);
  }
  __host__ __device__ static size_t wtr(int l1) {
    return (size_t)br + (size_t)l1 * kH * 4;
  }
};

// LayerNorm (two-pass variance) of the tile's rows y (rows of kLdCf), in
// place, each result rounded to bf16: four threads an edge, thread q of
// edge e holding columns q, q + 4, ...
__device__ __forceinline__ void layer_norm_bf16(float* s_y,
                                                const float* __restrict__ ln_s,
                                                const float* __restrict__ ln_b) {
  static_assert(kTE * 4 == kThreads, "four threads an edge");
  constexpr int CP = kC / 4;
  const int e = threadIdx.x >> 2, q = threadIdx.x & 3;
  float* row = s_y + e * kLdCf;
  float v[CP];
  float mu = 0.f;
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    v[j] = row[q + 4 * j];
    mu += v[j];
  }
  mu += __shfl_xor_sync(0xffffffffu, mu, 1);
  mu += __shfl_xor_sync(0xffffffffu, mu, 2);
  mu *= 1.f / kC;
  float var = 0.f;
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const float d = v[j] - mu;
    var = fmaf(d, d, var);
  }
  var += __shfl_xor_sync(0xffffffffu, var, 1);
  var += __shfl_xor_sync(0xffffffffu, var, 2);
  var *= 1.f / kC;
  const float rstd = rsqrtf(var + kLnEps);
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const int c = q + 4 * j;
    row[c] = round_bf16((v[j] - mu) * rstd * __ldg(ln_s + c) + __ldg(ln_b + c));
  }
}

// E: the fold entry (src is e0), the pregathered entry (src is h0; we, be,
// pxj, senders are null) or the pe entry (src is pe; we, be are null).
template <Entry E>
__global__ void __launch_bounds__(kThreads, 2)
edge_tail_kernel(const bf16* __restrict__ src, const bf16* __restrict__ we,
                 const bf16* __restrict__ be, const bf16* __restrict__ pxj,
                 const bf16* __restrict__ pxi,
                 const int* __restrict__ senders,
                 const int* __restrict__ rowptr,
                 const bf16* __restrict__ w_rest,
                 const bf16* __restrict__ b_rest,
                 const bf16* __restrict__ w_out,
                 const bf16* __restrict__ b_out,
                 const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, float* __restrict__ out,
                 float* __restrict__ part, int n_nodes, int n_edges, int l1) {
  using L = Layout;
  extern __shared__ __align__(16) unsigned char bf16_fwd_smem[];
  unsigned char* sm = bf16_fwd_smem;
  bf16* s_act = reinterpret_cast<bf16*>(sm + L::act);
  bf16* s_src = reinterpret_cast<bf16*>(sm + L::src);
  float* s_y = reinterpret_cast<float*>(sm + L::y);
  bf16* s_wte = reinterpret_cast<bf16*>(sm + L::wte);
  bf16* s_wto = reinterpret_cast<bf16*>(sm + L::wto);
  float* s_be = reinterpret_cast<float*>(sm + L::be);
  float* s_bo = reinterpret_cast<float*>(sm + L::bo);
  int* s_rcv = reinterpret_cast<int*>(sm + L::rcv);
  int* s_snd = reinterpret_cast<int*>(sm + L::snd);
  float* s_br = reinterpret_cast<float*>(sm + L::br);
  bf16* s_wtr = reinterpret_cast<bf16*>(sm + L::wtr(l1));
  const int tid = threadIdx.x, warp = tid >> 5;
  constexpr bool FOLD = E == kFold, GATHERS = E != kPregathered;

  if constexpr (FOLD) {
    load_weights<kCe, kH, true>(s_wte, we, 1, kLdC, 0, kThreads);
    load_f32(s_be, be, kH, kThreads);
  }
  load_weights<kH, kH, true>(s_wtr, w_rest, l1, kLdH, kH * kLdH, kThreads);
  load_weights<kH, kC, true>(s_wto, w_out, 1, kLdH, 0, kThreads);
  load_f32(s_br, b_rest, l1 * kH, kThreads);
  load_f32(s_bo, b_out, kC, kThreads);

  int t_beg, t_end;
  tile128::block_tiles<kTE>(n_edges, &t_beg, &t_end);
  if (t_beg < t_end) {
    if (warp < 2)
      tile128::tile_indices<kTE, GATHERS>(s_rcv, s_snd, senders, rowptr,
                                          n_nodes, n_edges, t_beg, -1);
    if constexpr (FOLD) {
      stage_e0(s_src, src, n_edges, t_beg, kThreads);
      tf32x3::cp_async_commit();
    }
  }
  __syncthreads();  // the weights and the first tile's indices

  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const int n_valid = min(kTE, n_edges - tile * kTE);
    const int* rcv = s_rcv + cur * kTE;
    const int* snd = s_snd + cur * kTE;
    const bool more = tile + 1 < t_end;

    if constexpr (!FOLD) {
      // h_0 = bf16(relu(h0 + pxi[i])) or bf16(relu((pe + pxj[s]) + pxi[i]))
      first_h0<kThreads, E == kPe>(s_act, src, pxj, pxi, snd, rcv, n_valid,
                                   tile * kTE);
      __syncthreads();  // h_0 written; the last tile's sums are done
      if (more && warp < 2)
        tile128::tile_indices<kTE, GATHERS>(
            s_rcv + nxt * kTE, s_snd + nxt * kTE, senders, rowptr, n_nodes,
            n_edges, tile + 1, rcv[n_valid - 1]);
    } else {
      // h_0 = bf16(relu(z + e0 . W_e)); z loaded while the rows arrive
      {
        Prod<kTE, kH, kWarps> p;
        p.init([&](int e, int n) {
          return fold_z(s_be, pxj, pxi, snd, rcv, n_valid, e, n);
        });
        tf32x3::cp_async_wait<0>();
        __syncthreads();  // the rows are in; the last tile's sums are done
        p.run<kCe>(ARows{s_src, kLdC}, BNK{s_wte, kLdC});
        p.store_relu(s_act, kLdH);
      }
      if (more && warp < 2)
        tile128::tile_indices<kTE, true>(s_rcv + nxt * kTE,
                                         s_snd + nxt * kTE, senders, rowptr,
                                         n_nodes, n_edges, tile + 1,
                                         rcv[n_valid - 1]);
      __syncthreads();  // h_0 written, the staging rows free
      if (more) {
        stage_e0(s_src, src, n_edges, tile + 1, kThreads);
        tf32x3::cp_async_commit();
      }
    }

    // h_k = bf16(relu(h_{k-1} . W_k + b_k))
    for (int k = 0; k < l1; ++k) {
      Prod<kTE, kH, kWarps> p;
      const float* b = s_br + k * kH;
      p.init([&](int, int n) { return b[n]; });
      p.run<kH>(ARows{s_act, kLdH}, BNK{s_wtr + k * kH * kLdH, kLdH});
      __syncthreads();  // every warp has read h_{k-1}
      p.store_relu(s_act, kLdH);
      __syncthreads();
    }
    // y = h_L1 . W_out + b_out, then LayerNorm, rounded to bf16
    {
      Prod<kTE, kC, kWarps> p;
      p.init([&](int, int c) { return s_bo[c]; });
      p.run<kH>(ARows{s_act, kLdH}, BNK{s_wto, kLdH});
      p.store(s_y, kLdCf);
    }
    __syncthreads();
    layer_norm_bf16(s_y, ln_s, ln_b);
    __syncthreads();
    csr_tile::receiver_sums<kTE, kC>(
        [&](int e, int c) -> float& { return s_y[e * kLdCf + c]; }, rcv,
        rowptr, n_edges, tile, n_valid, out, part);
  }
}

template <Entry E>
int launch(const bf16* src, const bf16* we, const bf16* be, const bf16* pxj,
           const bf16* pxi, const int* senders, const int* rowptr,
           const bf16* w_rest, const bf16* b_rest, const bf16* w_out,
           const bf16* b_out, const float* ln_s, const float* ln_b, float* out,
           float* part, int n_nodes, int n_edges, int l1,
           cudaStream_t stream) {
  static std::atomic<int> cache[kMaxDevices];
  const size_t smem = Layout::bytes(kMaxL1);  // one opt-in for every l1
  int cap = 0;
  cudaError_t err =
      grid_cap(edge_tail_kernel<E>, kThreads, smem, cache, &cap);
  if (err != cudaSuccess) return (int)err;
  if (n_nodes == 0 || n_edges <= 0) return (int)cudaSuccess;
  const int n_tiles = (n_edges + kTE - 1) / kTE;
  const int blocks = n_tiles < cap ? n_tiles : cap;
  edge_tail_kernel<E><<<blocks, kThreads, Layout::bytes(l1), stream>>>(
      src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
      ln_s, ln_b, out, part, n_nodes, n_edges, l1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n_tiles > 1)
    csr_tile::cross_tile_sum_kernel<kTE, kC>
        <<<n_tiles - 1, kC, 0, stream>>>(rowptr, part, out, n_nodes, n_edges);
  return (int)cudaGetLastError();
}

}  // namespace fwd

// ---- backward --------------------------------------------------------------

namespace bwd {

constexpr int kThreads = 512;  // 16 warps, one block an SM
constexpr int kWarps = kThreads / 32;

// Offsets, in bytes, into dynamic shared memory, and, in floats, into the
// packed weight-gradient buffer; the fold's W_e, e0 tiles, dW_e and db_e
// take no room in the pregathered and pe entries'.
template <int L1, Entry E>
struct Layout {
  static constexpr int F = E == kFold ? 1 : 0;     // the fold's parts
  static constexpr int plane = kTE * kLdH * 2;     // a bf16 (kTE, kLdH) tile
  static constexpr int gplane = kTE * kLdHf * 4;   // an f32 (kTE, kLdHf) tile
  static constexpr int wte = 0;                    // W_e^T (kH, kLdC)
  static constexpr int we = wte + F * kH * kLdC * 2;   // W_e (kCe, kLdH)
  static constexpr int wtr = we + F * kCe * kLdH * 2;  // L1 x W_k^T
  static constexpr int wr = wtr + L1 * plane;      // L1 x W_k (kH, kLdH)
  static constexpr int wto = wr + L1 * plane;      // W_out^T (kC, kLdH)
  static constexpr int wo = wto + kC * kLdH * 2;   // W_out (kH, kLdC)
  static constexpr int be = wo + kH * kLdC * 2;    // f32 (kH)
  static constexpr int br = be + F * kH * 4;       // f32 (L1, kH)
  static constexpr int bo = br + L1 * kH * 4;      // f32 (kC)
  static constexpr int ls = bo + kC * 4;           // f32 (kC)
  static constexpr int act = ls + kC * 4;          // L1 + 1 bf16 planes
  static constexpr int grad = act + (L1 + 1) * plane;  // 2 f32 planes
  static constexpr int y = grad + 2 * gplane;      // f32 (kTE, kLdCf): y, dy
  static constexpr int src = y + kTE * kLdCf * 4;  // 2 x bf16 (kTE, kLdC)
  static constexpr int ln = src + F * 2 * kTE * kLdC * 2;  // kWarps x 2 kC
  static constexpr int rcv = ln + kWarps * 2 * kC * 4;  // 2 x (kTE) int
  static constexpr int snd = rcv + 2 * kTE * 4;    // 2 x (kTE) int
  static constexpr int bytes = snd + 2 * kTE * 4;

  static constexpr int g_we = 0;
  static constexpr int g_be = g_we + F * kCe * kH;
  static constexpr int g_wr = g_be + F * kH;
  static constexpr int g_br = g_wr + L1 * kH * kH;
  static constexpr int g_wo = g_br + L1 * kH;
  static constexpr int g_bo = g_wo + kH * kC;
  static constexpr int g_ls = g_bo + kC;
  static constexpr int g_lb = g_ls + kC;
  static constexpr int g_total = g_lb + kC;
};

// The thread's column sum over its part of an f32 (kTE, W) tile of rows of
// ld: column tid % W, rows (tid / W) R .. + R - 1, R = kTE W / kThreads.
template <int W>
__device__ __forceinline__ float column_part(const float* t, int ld) {
  constexpr int R = kTE * W / kThreads;
  const int c = threadIdx.x % W, r0 = (threadIdx.x / W) * R;
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) s += t[(r0 + r) * ld + c];
  return s;
}

// The sum, in row-part order, of column c's parts that column_part<W> left
// at sums[tid].
template <int W>
__device__ __forceinline__ float column_total(const float* sums, int c) {
  float s = 0.f;
  for (int q = 0; q < kThreads / W; ++q) s += sums[q * W + c];
  return s;
}

// LayerNorm's backward over the tile's y (rows of kLdCf), in place: dy =
// rstd (dx - mean(dx) - xhat mean(dx xhat)), dx = bf16(g) ln_s, the row's
// mean and rstd recomputed (two-pass variance).  Eight threads an edge,
// thread q of edge e holding columns q + 8 j; gv holds bf16(g[i]) on them
// (zero past the tile's edges).  The tile's g xhat and g, summed over each
// warp's four edges, are added to the warp's row of s_ln.
__device__ __forceinline__ void layer_norm_bwd(float* s_y, const float* s_ls,
                                               const float (&gv)[kC / 8],
                                               float* s_ln) {
  constexpr int CP = kC / 8;
  const int e = threadIdx.x >> 3, q = threadIdx.x & 7;
  float* row = s_y + e * kLdCf;
  float v[CP];
  float mu = 0.f;
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    v[j] = row[q + 8 * j];
    mu += v[j];
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) mu += __shfl_xor_sync(0xffffffffu, mu, o);
  mu *= 1.f / kC;
  float var = 0.f;
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const float d = v[j] - mu;
    var = fmaf(d, d, var);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
  var *= 1.f / kC;
  const float rstd = rsqrtf(var + kLnEps);
  float m1 = 0.f, m2 = 0.f, dx[CP], gx[CP], gs[CP];
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    v[j] = (v[j] - mu) * rstd;  // xhat
    dx[j] = gv[j] * s_ls[q + 8 * j];
    m1 += dx[j];
    m2 = fmaf(dx[j], v[j], m2);
    gx[j] = gv[j] * v[j];
    gs[j] = gv[j];
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    m1 += __shfl_xor_sync(0xffffffffu, m1, o);
    m2 += __shfl_xor_sync(0xffffffffu, m2, o);
  }
  m1 *= 1.f / kC;
  m2 *= 1.f / kC;
#pragma unroll
  for (int j = 0; j < CP; ++j) row[q + 8 * j] = rstd * (dx[j] - m1 - v[j] * m2);
#pragma unroll
  for (int j = 0; j < CP; ++j)
#pragma unroll
    for (int o = 8; o < 32; o <<= 1) {
      gx[j] += __shfl_xor_sync(0xffffffffu, gx[j], o);
      gs[j] += __shfl_xor_sync(0xffffffffu, gs[j], o);
    }
  if ((threadIdx.x & 31) < 8) {
    float* part = s_ln + (threadIdx.x >> 5) * 2 * kC;
#pragma unroll
    for (int j = 0; j < CP; ++j) {
      part[q + 8 * j] += gx[j];
      part[kC + q + 8 * j] += gs[j];
    }
  }
}

// E: the fold entry (src is e0, d_src d_e0), the pregathered entry (src is
// h0, d_src d_h0 (E, kH); we, be, pxj, senders, d_pxj are null) or the pe
// entry (src is pe, d_src d_pe (E, kH) and dz_out dz (E, kH) f32; we, be,
// d_pxj are null).  dz_out is null but for pe.
template <int L1, Entry E>
__global__ void __launch_bounds__(kThreads, 1)
edge_tail_bwd_kernel(const bf16* __restrict__ src, const bf16* __restrict__ we,
                     const bf16* __restrict__ be, const bf16* __restrict__ pxj,
                     const bf16* __restrict__ pxi,
                     const int* __restrict__ senders,
                     const int* __restrict__ rowptr,
                     const bf16* __restrict__ w_rest,
                     const bf16* __restrict__ b_rest,
                     const bf16* __restrict__ w_out,
                     const bf16* __restrict__ b_out,
                     const float* __restrict__ ln_s,
                     const float* __restrict__ g, bf16* __restrict__ d_src,
                     float* __restrict__ dz_out, float* __restrict__ d_pxj,
                     float* __restrict__ d_pxi, float* __restrict__ partial,
                     int n_nodes, int n_edges) {
  using L = Layout<L1, E>;
  constexpr bool FOLD = E == kFold, GATHERS = E != kPregathered;
  constexpr int NL = L1 > 0 ? L1 : 1;
  extern __shared__ __align__(16) unsigned char bf16_bwd_smem[];
  unsigned char* sm = bf16_bwd_smem;
  bf16* s_wte = reinterpret_cast<bf16*>(sm + L::wte);
  bf16* s_we = reinterpret_cast<bf16*>(sm + L::we);
  bf16* s_wtr = reinterpret_cast<bf16*>(sm + L::wtr);
  bf16* s_wr = reinterpret_cast<bf16*>(sm + L::wr);
  bf16* s_wto = reinterpret_cast<bf16*>(sm + L::wto);
  bf16* s_wo = reinterpret_cast<bf16*>(sm + L::wo);
  float* s_be = reinterpret_cast<float*>(sm + L::be);
  float* s_br = reinterpret_cast<float*>(sm + L::br);
  float* s_bo = reinterpret_cast<float*>(sm + L::bo);
  float* s_ls = reinterpret_cast<float*>(sm + L::ls);
  float* s_y = reinterpret_cast<float*>(sm + L::y);
  float* s_ln = reinterpret_cast<float*>(sm + L::ln);
  int* s_rcv = reinterpret_cast<int*>(sm + L::rcv);
  int* s_snd = reinterpret_cast<int*>(sm + L::snd);
  // plane k: h_k (bf16); grad(a): a data gradient (f32)
  auto plane = [&](int k) {
    return reinterpret_cast<bf16*>(sm + L::act + k * L::plane);
  };
  auto grad = [&](int a) {
    return reinterpret_cast<float*>(sm + L::grad + a * L::gplane);
  };
  auto staged = [&](int buf) {
    return reinterpret_cast<bf16*>(sm + L::src + buf * kTE * kLdC * 2);
  };
  const int tid = threadIdx.x, warp = tid >> 5;

  if constexpr (FOLD) {
    load_weights<kCe, kH, true>(s_wte, we, 1, kLdC, 0, kThreads);
    load_weights<kCe, kH, false>(s_we, we, 1, kLdH, 0, kThreads);
    load_f32(s_be, be, kH, kThreads);
  }
  load_weights<kH, kH, true>(s_wtr, w_rest, L1, kLdH, kH * kLdH, kThreads);
  load_weights<kH, kH, false>(s_wr, w_rest, L1, kLdH, kH * kLdH, kThreads);
  load_weights<kH, kC, true>(s_wto, w_out, 1, kLdH, 0, kThreads);
  load_weights<kH, kC, false>(s_wo, w_out, 1, kLdC, 0, kThreads);
  load_f32(s_br, b_rest, L1 * kH, kThreads);
  load_f32(s_bo, b_out, kC, kThreads);
  for (int k = tid; k < kC; k += kThreads) s_ls[k] = __ldg(ln_s + k);
  for (int k = tid; k < kWarps * 2 * kC; k += kThreads) s_ln[k] = 0.f;

  // the thread's parts of the weight gradients, summed over its tiles in
  // f32 (Prod's places), and of the bias gradients (column_part's)
  float run_wr[NL][Prod<kH, kH, kWarps>::NI][4] = {};
  float run_wo[Prod<kH, kC, kWarps>::NI][4] = {};
  float run_we[Prod<kCe, kH, kWarps>::NI][4] = {};
  float run_br[NL] = {}, run_bo = 0.f, run_be = 0.f;

  int t_beg, t_end;
  tile128::block_tiles<kTE>(n_edges, &t_beg, &t_end);
  if (t_beg < t_end) {
    if (warp < 2)
      tile128::tile_indices<kTE, GATHERS>(s_rcv, s_snd, senders, rowptr,
                                          n_nodes, n_edges, t_beg, -1);
    if constexpr (FOLD) {
      stage_e0(staged(0), src, n_edges, t_beg, kThreads);
      tf32x3::cp_async_commit();
    }
  }
  __syncthreads();  // the weights and the first tile's indices

  for (int tile = t_beg, it = 0; tile < t_end; ++tile, ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const int base = tile * kTE, n_valid = min(kTE, n_edges - base);
    const int* rcv = s_rcv + cur * kTE;
    const int* snd = s_snd + cur * kTE;
    const bool more = tile + 1 < t_end;

    if constexpr (!FOLD) {
      // h_0 = bf16(relu(h0 + pxi[i])) or bf16(relu((pe + pxj[s]) + pxi[i]))
      first_h0<kThreads, E == kPe>(plane(0), src, pxj, pxi, snd, rcv,
                                   n_valid, base);
      __syncthreads();  // h_0 written; the last tile is done
      if (more && warp < 2)
        tile128::tile_indices<kTE, GATHERS>(
            s_rcv + nxt * kTE, s_snd + nxt * kTE, senders, rowptr, n_nodes,
            n_edges, tile + 1, rcv[n_valid - 1]);
    } else {
      // h_0 = bf16(relu(e0 . W_e + z)), z loaded while the rows arrive
      {
        Prod<kTE, kH, kWarps> p;
        p.init([&](int e, int n) {
          return fold_z(s_be, pxj, pxi, snd, rcv, n_valid, e, n);
        });
        tf32x3::cp_async_wait<0>();
        __syncthreads();  // the rows are in; the last tile is done
        if (more && warp < 2)
          tile128::tile_indices<kTE, true>(
              s_rcv + nxt * kTE, s_snd + nxt * kTE, senders, rowptr, n_nodes,
              n_edges, tile + 1, rcv[n_valid - 1]);
        if (more) {  // into the buffer the last tile's dW_e read
          stage_e0(staged(nxt), src, n_edges, tile + 1, kThreads);
          tf32x3::cp_async_commit();
        }
        p.template run<kCe>(ARows{staged(cur), kLdC}, BNK{s_wte, kLdC});
        p.store_relu(plane(0), kLdH);
      }
      __syncthreads();
    }

    // h_1 .. h_L1
#pragma unroll
    for (int k = 1; k <= L1; ++k) {
      Prod<kTE, kH, kWarps> p;
      const float* b = s_br + (k - 1) * kH;
      p.init([&](int, int n) { return b[n]; });
      p.template run<kH>(ARows{plane(k - 1), kLdH},
                         BNK{s_wtr + (k - 1) * kH * kLdH, kLdH});
      p.store_relu(plane(k), kLdH);
      __syncthreads();
    }

    // y = h_L1 . W_out + b_out; bf16(g[i]) for LayerNorm's backward, loaded
    // before the product
    float gv[kC / 8];
    {
      const int e = tid >> 3, q = tid & 7;
#pragma unroll
      for (int j = 0; j < kC / 8; ++j)
        gv[j] = e < n_valid
                    ? round_bf16(__ldg(g + (size_t)rcv[e] * kC + q + 8 * j))
                    : 0.f;
      Prod<kTE, kC, kWarps> p;
      p.init([&](int, int c) { return s_bo[c]; });
      p.template run<kH>(ARows{plane(L1), kLdH}, BNK{s_wto, kLdH});
      p.store(s_y, kLdCf);
    }
    __syncthreads();
    layer_norm_bwd(s_y, s_ls, gv, s_ln);  // dy over y
    __syncthreads();

    // the output layer: dW_out += h_L1^T . bf16(dy), db_out += sum dy, and
    // da_L1 = (bf16(dy) . W_out^T) where h_L1 > 0, into grad(0)
    {
      Prod<kH, kC, kWarps> w;
      w.template run<kTE>(ACols{plane(L1), kLdH}, BKNF{s_y, kLdCf});
      w.add_to(run_wo);
      run_bo += column_part<kC>(s_y, kLdCf);
      Prod<kTE, kH, kWarps> d;
      d.template run<kC>(ARowsF{s_y, kLdCf}, BNK{s_wo, kLdC});
      d.store(grad(0), kLdHf, plane(L1), kLdH);
    }
    __syncthreads();

    // the tail layers, last to first: dW_k += h_{k-1}^T . bf16(da_k), db_k
    // += sum da_k, and da_{k-1} = (bf16(da_k) . W_k^T) where h_{k-1} > 0
#pragma unroll
    for (int k = L1; k >= 1; --k) {
      const int a = (L1 - k) & 1;  // da_k is in grad(a)
      Prod<kH, kH, kWarps> w;
      w.template run<kTE>(ACols{plane(k - 1), kLdH}, BKNF{grad(a), kLdHf});
      w.add_to(run_wr[k - 1]);
      run_br[k - 1] += column_part<kH>(grad(a), kLdHf);
      Prod<kTE, kH, kWarps> d;
      d.template run<kH>(ARowsF{grad(a), kLdHf},
                         BNK{s_wr + (k - 1) * kH * kLdH, kLdH});
      d.store(grad(a ^ 1), kLdHf, plane(k - 1), kLdH);
      __syncthreads();
    }

    const float* dz = grad(L1 & 1);
    if constexpr (!FOLD) {
      // dz = da_0: d_h0 / d_pe = bf16(dz), and (pe) dz itself, a pair of
      // columns a thread per step
      for (int k = tid; k < n_valid * (kH / 2); k += kThreads) {
        const int e = k / (kH / 2), n = 2 * (k % (kH / 2));
        const float2 v = *reinterpret_cast<const float2*>(dz + e * kLdHf + n);
        *reinterpret_cast<uint32_t*>(d_src + (size_t)(base + e) * kH + n) =
            pack_rn(v.x, v.y);
        if constexpr (E == kPe)
          *reinterpret_cast<float2*>(dz_out + (size_t)(base + e) * kH + n) = v;
      }
    } else {
      // dz = da_0: dW_e += e0^T . bf16(dz), db_e += sum dz, d_e0 =
      // bf16(bf16(dz) . W_e^T), d_pxj[s] += bf16(dz)
      {
        Prod<kCe, kH, kWarps> w;
        w.template run<kTE>(ACols{staged(cur), kLdC}, BKNF{dz, kLdHf});
        w.add_to(run_we);
        run_be += column_part<kH>(dz, kLdHf);
        Prod<kTE, kCe, kWarps> d;
        d.template run<kH>(ARowsF{dz, kLdHf}, BNK{s_we, kLdH});
        d.pairs([&](int e, int c, float v0, float v1) {
          if (e < n_valid)
            *reinterpret_cast<uint32_t*>(d_src + (size_t)(base + e) * kCe +
                                         c) = pack_rn(v0, v1);
        });
      }
      for (int k = tid; k < n_valid * kH; k += kThreads) {
        const int e = k >> 6, n = k & (kH - 1);
        atomicAdd(d_pxj + (size_t)snd[e] * kH + n,
                  round_bf16(dz[e * kLdHf + n]));
      }
    }
    {  // d_pxi[i] += bf16(dz), a sum a run of equal receivers
      constexpr int kPart = kTE * kH / kThreads;  // edges of an eighth
      const int n = tid & (kH - 1);
      const int e_beg = (tid / kH) * kPart;
      const int e_end = min(e_beg + kPart, n_valid);
      if (e_beg < e_end) {
        int at = rcv[e_beg];
        float s = 0.f;
        for (int e = e_beg; e < e_end; ++e) {
          if (rcv[e] != at) {
            atomicAdd(d_pxi + (size_t)at * kH + n, s);
            s = 0.f;
            at = rcv[e];
          }
          s += round_bf16(dz[e * kLdHf + n]);
        }
        atomicAdd(d_pxi + (size_t)at * kH + n, s);
      }
    }
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();  // every tile is done: the bias parts go through grad(0)

  // this block's partial gradients, in the packed layout
  float* p = partial + (size_t)blockIdx.x * L::g_total;
  float* sums = grad(0);  // one row of kThreads parts a bias gradient
#pragma unroll
  for (int k = 0; k < L1; ++k) {
    Prod<kH, kH, kWarps>().write(p + L::g_wr + k * kH * kH, run_wr[k]);
    sums[k * kThreads + tid] = run_br[k];
  }
  Prod<kH, kC, kWarps>().write(p + L::g_wo, run_wo);
  sums[L1 * kThreads + tid] = run_bo;
  if constexpr (FOLD) {
    Prod<kCe, kH, kWarps>().write(p + L::g_we, run_we);
    sums[(L1 + 1) * kThreads + tid] = run_be;
  }
  __syncthreads();
  if (tid < L1 * kH) {
    p[L::g_br + tid] =
        column_total<kH>(sums + (tid / kH) * kThreads, tid % kH);
  } else if (tid < L1 * kH + kC) {
    p[L::g_bo + tid - L1 * kH] =
        column_total<kC>(sums + L1 * kThreads, tid - L1 * kH);
  } else if (tid < L1 * kH + 3 * kC) {  // d_ln_s, then d_ln_b
    const int c = tid - L1 * kH - kC;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += s_ln[w * 2 * kC + c];
    p[L::g_ls + c] = s;
  } else if (FOLD && tid < L1 * kH + 3 * kC + kH) {
    const int c = tid - L1 * kH - 3 * kC;
    p[L::g_be + c] = column_total<kH>(sums + (L1 + 1) * kThreads, c);
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

// The kernel on a persistent grid of at most scratch_blocks blocks, each a
// run of consecutive tiles (every block at least one), then the
// fixed-order sum of the blocks' partials.
template <int L1, Entry E>
int launch(const bf16* src, const bf16* we, const bf16* be, const bf16* pxj,
           const bf16* pxi, const int* senders, const int* rowptr,
           const bf16* w_rest, const bf16* b_rest, const bf16* w_out,
           const bf16* b_out, const float* ln_s, const float* g, bf16* d_src,
           float* dz_out, float* d_pxj, float* d_pxi, float* wgrad,
           float* partial, int n_nodes, int n_edges, int scratch_blocks,
           cudaStream_t stream) {
  using L = Layout<L1, E>;
  static std::atomic<int> cache[kMaxDevices];
  int cap = 0;
  const cudaError_t err = grid_cap(edge_tail_bwd_kernel<L1, E>, kThreads,
                                   (size_t)L::bytes, cache, &cap);
  if (err != cudaSuccess) return (int)err;
  if (cap > scratch_blocks) cap = scratch_blocks;
  const int n_tiles = n_nodes > 0 ? (n_edges + kTE - 1) / kTE : 0;
  if (n_tiles > 0 && cap < 1) return (int)cudaErrorInvalidValue;
  const int per_block = n_tiles > 0 ? (n_tiles + cap - 1) / cap : 1;
  const int blocks = (n_tiles + per_block - 1) / per_block;
  if (blocks > 0) {
    edge_tail_bwd_kernel<L1, E><<<blocks, kThreads, L::bytes, stream>>>(
        src, we, be, pxj, pxi, senders, rowptr, w_rest, b_rest, w_out, b_out,
        ln_s, g, d_src, dz_out, d_pxj, d_pxi, partial, n_nodes, n_edges);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return (int)launched;
  }
  reduce_partials_kernel<<<(L::g_total + 255) / 256, 256, 0, stream>>>(
      partial, wgrad, blocks, L::g_total);
  return (int)cudaGetLastError();
}

// launch<L1, E> at a run-time l1 in 0..kMaxL1
template <Entry E>
int launch_l1(int l1, const bf16* src, const bf16* we, const bf16* be,
              const bf16* pxj, const bf16* pxi, const int* senders,
              const int* rowptr, const bf16* w_rest, const bf16* b_rest,
              const bf16* w_out, const bf16* b_out, const float* ln_s,
              const float* g, bf16* d_src, float* dz_out, float* d_pxj,
              float* d_pxi, float* wgrad, float* partial, int n_nodes,
              int n_edges, int scratch_blocks, cudaStream_t stream) {
#define MAGNET_BF16_BWD_CASE(L1V)                                            \
  case L1V:                                                                  \
    return launch<L1V, E>(src, we, be, pxj, pxi, senders, rowptr, w_rest,    \
                          b_rest, w_out, b_out, ln_s, g, d_src, dz_out,      \
                          d_pxj, d_pxi, wgrad, partial, n_nodes, n_edges,    \
                          scratch_blocks, stream)
  switch (l1) {
    MAGNET_BF16_BWD_CASE(0);
    MAGNET_BF16_BWD_CASE(1);
    MAGNET_BF16_BWD_CASE(2);
    MAGNET_BF16_BWD_CASE(3);
  }
#undef MAGNET_BF16_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory of launch<l1, E>'s kernel
template <Entry E>
int smem_bytes(int l1) {
  switch (l1) {
    case 0: return Layout<0, E>::bytes;
    case 1: return Layout<1, E>::bytes;
    case 2: return Layout<2, E>::bytes;
    default: return Layout<3, E>::bytes;
  }
}

}  // namespace bwd

bool built(int ce, int h, int c, int l1) {
  return ce == kCe && h == kH && c == kC && l1 >= 0 && l1 <= kMaxL1;
}

}  // namespace

extern "C" {

// The fold forward.  Returns a cudaError_t; 0 is success.  Launches on
// `stream` and does not synchronise.  e0 (n_edges, ce), pxj and pxi
// (n_nodes, h) are 16-byte aligned bf16; we, be, w_rest, b_rest, w_out,
// b_out bf16; ln_s, ln_b f32; out (n_nodes, c) f32 must arrive zeroed;
// part is f32 scratch of 2 * ceil(n_edges / 64) rows of c.  Built for (ce,
// h, c) = (32, 64, 32) and l1 in 0..3; others return
// cudaErrorInvalidValue.
int fused_edge_tail_agg_bf16_fwd(const bf16* e0, const bf16* we,
                                 const bf16* be, const bf16* pxj,
                                 const bf16* pxi, const int* senders,
                                 const int* rowptr, const bf16* w_rest,
                                 const bf16* b_rest, const bf16* w_out,
                                 const bf16* b_out, const float* ln_s,
                                 const float* ln_b, float* out, float* part,
                                 int n_nodes, int n_edges, int ce, int h,
                                 int c, int l1, void* stream) {
  if (!built(ce, h, c, l1) || part == nullptr)
    return (int)cudaErrorInvalidValue;
  return fwd::launch<kFold>(e0, we, be, pxj, pxi, senders, rowptr, w_rest,
                            b_rest, w_out, b_out, ln_s, ln_b, out, part,
                            n_nodes, n_edges, l1,
                            static_cast<cudaStream_t>(stream));
}

// The fold backward, its operands as the forward's, and g (n_nodes, c)
// f32.  Writes d_e0 (n_edges, ce) bf16; adds into d_pxj and d_pxi
// (n_nodes, h) f32, which must arrive zeroed; wgrad (f32) holds, packed,
// dW_e (ce, h), db_e (h), dW_rest (l1, h, h), db_rest (l1, h), dW_out (h,
// c), db_out (c), d_ln_s (c), d_ln_b (c); partial is f32 scratch for
// scratch_blocks x that many floats.
int fused_edge_tail_agg_bf16_bwd(
    const bf16* e0, const bf16* we, const bf16* be, const bf16* pxj,
    const bf16* pxi, const int* senders, const int* rowptr,
    const bf16* w_rest, const bf16* b_rest, const bf16* w_out,
    const bf16* b_out, const float* ln_s, const float* g, bf16* d_e0,
    float* d_pxj, float* d_pxi, float* wgrad, float* partial, int n_nodes,
    int n_edges, int ce, int h, int c, int l1, int scratch_blocks,
    void* stream) {
  if (!built(ce, h, c, l1)) return (int)cudaErrorInvalidValue;
  return bwd::launch_l1<kFold>(l1, e0, we, be, pxj, pxi, senders, rowptr,
                               w_rest, b_rest, w_out, b_out, ln_s, g, d_e0,
                               nullptr, d_pxj, d_pxi, wgrad, partial, n_nodes,
                               n_edges, scratch_blocks,
                               static_cast<cudaStream_t>(stream));
}

// The pregathered forward: h0 (n_edges, h) and pxi (n_nodes, h) 16-byte
// aligned bf16, the rest as the fold forward's.  Built for (h, c) = (64,
// 32) and l1 in 0..3.
int fused_edge_tail_agg_bf16_pregathered_fwd(
    const bf16* h0, const bf16* pxi, const int* rowptr, const bf16* w_rest,
    const bf16* b_rest, const bf16* w_out, const bf16* b_out,
    const float* ln_s, const float* ln_b, float* out, float* part,
    int n_nodes, int n_edges, int h, int c, int l1, void* stream) {
  if (!built(kCe, h, c, l1) || part == nullptr)
    return (int)cudaErrorInvalidValue;
  return fwd::launch<kPregathered>(h0, nullptr, nullptr, nullptr, pxi, nullptr,
                           rowptr, w_rest, b_rest, w_out, b_out, ln_s, ln_b,
                           out, part, n_nodes, n_edges, l1,
                           static_cast<cudaStream_t>(stream));
}

// The pregathered backward, its operands as its forward's, and g (n_nodes,
// c) f32.  Writes d_h0 (n_edges, h) bf16; adds into d_pxi (n_nodes, h)
// f32, which must arrive zeroed; wgrad (f32) holds, packed, dW_rest (l1,
// h, h), db_rest (l1, h), dW_out (h, c), db_out (c), d_ln_s (c), d_ln_b
// (c); partial is f32 scratch for scratch_blocks x that many floats.
int fused_edge_tail_agg_bf16_pregathered_bwd(
    const bf16* h0, const bf16* pxi, const int* rowptr, const bf16* w_rest,
    const bf16* b_rest, const bf16* w_out, const bf16* b_out,
    const float* ln_s, const float* g, bf16* d_h0, float* d_pxi,
    float* wgrad, float* partial, int n_nodes, int n_edges, int h, int c,
    int l1, int scratch_blocks, void* stream) {
  if (!built(kCe, h, c, l1)) return (int)cudaErrorInvalidValue;
  return bwd::launch_l1<kPregathered>(
      l1, h0, nullptr, nullptr, nullptr, pxi, nullptr, rowptr, w_rest, b_rest,
      w_out, b_out, ln_s, g, d_h0, nullptr, nullptr, d_pxi, wgrad, partial,
      n_nodes, n_edges, scratch_blocks, static_cast<cudaStream_t>(stream));
}

// The pe forward: pe (n_edges, h), pxj and pxi (n_nodes, h) 16-byte aligned
// bf16, senders the sender of each edge, the rest as the fold forward's.
// Built for (h, c) = (64, 32) and l1 in 0..3.
int fused_edge_tail_agg_bf16_pe_fwd(
    const bf16* pe, const bf16* pxj, const bf16* pxi, const int* senders,
    const int* rowptr, const bf16* w_rest, const bf16* b_rest,
    const bf16* w_out, const bf16* b_out, const float* ln_s,
    const float* ln_b, float* out, float* part, int n_nodes, int n_edges,
    int h, int c, int l1, void* stream) {
  if (!built(kCe, h, c, l1) || part == nullptr)
    return (int)cudaErrorInvalidValue;
  return fwd::launch<kPe>(pe, nullptr, nullptr, pxj, pxi, senders, rowptr,
                          w_rest, b_rest, w_out, b_out, ln_s, ln_b, out, part,
                          n_nodes, n_edges, l1,
                          static_cast<cudaStream_t>(stream));
}

// The pe backward, its operands as its forward's, and g (n_nodes, c) f32.
// Writes d_pe (n_edges, h) bf16 and dz (n_edges, h) f32, the unrounded
// first pre-activation's gradient, from which the caller sums d_pxj over
// the sender CSR; adds into d_pxi (n_nodes, h) f32, which must arrive
// zeroed; wgrad (f32) holds, packed, dW_rest (l1, h, h), db_rest (l1, h),
// dW_out (h, c), db_out (c), d_ln_s (c), d_ln_b (c); partial is f32
// scratch for scratch_blocks x that many floats.
int fused_edge_tail_agg_bf16_pe_bwd(
    const bf16* pe, const bf16* pxj, const bf16* pxi, const int* senders,
    const int* rowptr, const bf16* w_rest, const bf16* b_rest,
    const bf16* w_out, const bf16* b_out, const float* ln_s, const float* g,
    bf16* d_pe, float* dz, float* d_pxi, float* wgrad, float* partial,
    int n_nodes, int n_edges, int h, int c, int l1, int scratch_blocks,
    void* stream) {
  if (!built(kCe, h, c, l1)) return (int)cudaErrorInvalidValue;
  return bwd::launch_l1<kPe>(l1, pe, nullptr, nullptr, pxj, pxi, senders,
                             rowptr, w_rest, b_rest, w_out, b_out, ln_s, g,
                             d_pe, dz, nullptr, d_pxi, wgrad, partial,
                             n_nodes, n_edges, scratch_blocks,
                             static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a block takes at l1 tail layers: the fold forward
// (which = 0), the fold backward (1), the pregathered forward (2) and
// backward (3), the pe forward (4) and backward (5); -1 for an l1 not
// built.
int fused_edge_tail_agg_bf16_smem(int which, int l1) {
  if (l1 < 0 || l1 > kMaxL1 || which < 0 || which > 5) return -1;
  if (which % 2 == 0) return (int)fwd::Layout::bytes(l1);
  return which == 1   ? bwd::smem_bytes<kFold>(l1)
         : which == 3 ? bwd::smem_bytes<kPregathered>(l1)
                      : bwd::smem_bytes<kPe>(l1);
}

}  // extern "C"
