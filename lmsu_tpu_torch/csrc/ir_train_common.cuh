// Pieces shared by the six kernels of the fused InvertedResidual training
// path (ir_train_*.cu) and the fusion gate (fusion_gate.cu), for Hopper
// (sm_90a). Each .cu file includes this header and builds into its own
// library.
//
// - element conversions and the input-dtype rounding the TPU kernels apply;
// - expand_step: the expand 1x1 (e = x . W1) on the tensor cores, one
//   device function for K8, K9, K12 and K13 (and mma_step, the
//   split-operand product step under it, which K13 also uses for dW1 and
//   dx, K10 and K11 for the projection, and the fusion gate K2,
//   fusion_gate.cu, for its 1x1 product);
// - smem_b, ldmatrix and cp.async helpers;
// - sum_rows: the fixed-order reduction of per-block partials (no float
//   atomics, so every cross-block sum is deterministic).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace irt {

constexpr int kThreads = 256;  // every kernel of the path: 8 warps, 16 x 16
constexpr int kT = 8;          // spatial kernels: output tile side
constexpr int kKC = 32;        // spatial kernels: hidden channels per block
constexpr int kSmemBlock = 232448;                 // shared memory a block may opt in to
constexpr int kSmemTwoBlocks = 233472 / 2 - 1024;  // a block's share when two share an SM

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and widened back (the TPU kernels' `.astype(x.dtype)`).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// NaN-propagating max and min (PTX max.NaN / min.NaN, sm_80 and up): NaN
// where either operand is NaN, else what max.f32 / min.f32 give. fmaxf and
// fminf return the other operand, dropping a NaN that the reference keeps.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float fmin_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// ReLU6 that keeps NaN, as the reference's clip does.
__device__ __forceinline__ float relu6(float v) { return fmin_nan(fmax_nan(v, 0.f), 6.f); }

// The fused path's ReLU6 derivative: 1 strictly inside (0, 6), 0 at the ties.
__device__ __forceinline__ float relu6_mask(float v) { return (v > 0.f && v < 6.f) ? 1.f : 0.f; }

// The elementwise BN expressions that feed a ReLU6 mask or a rounding, with
// each operation rounded as the plain version rounds it (no FMA
// contraction), so that a kernel and its plain version take the same mask
// and rounding decisions on the same inputs.
// v * s + b:
__device__ __forceinline__ float scale_shift(float v, float s, float b) {
  return __fadd_rn(__fmul_rn(v, s), b);
}
// (v - m) * inv:
__device__ __forceinline__ float normalize(float v, float m, float inv) {
  return __fmul_rn(__fsub_rn(v, m), inv);
}
// u * g - p - q * n (the BN backward of _ir_train_backward's glue vectors):
__device__ __forceinline__ float bn_backward(float u, float g, float p, float q, float n) {
  return __fsub_rn(__fsub_rn(__fmul_rn(u, g), p), __fmul_rn(q, n));
}

// Four consecutive elements (16-byte aligned f32, 8-byte aligned bf16) as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// -- the shared expand on the tensor cores ------------------------------------
//
// K8, K9, K12 and K13 compute e = x . W1 (rounded to the input dtype) with
// one device function, expand_step, on warp-level mma.sync.m16n8k16 (bf16
// in, f32 accumulate): one call adds one k-step (16 input channels) of a
// 16-pixel x 8-channel tile. The ReLU6 mask of K12's backward must equal the
// activation K9 took in the forward, and BN1's statistics (K8) describe the
// e that K9 normalises, so e must not depend on the caller's tiling: given
// the same x row and W1 column, the products, their order and the
// accumulator schedule below are fixed, and a caller walks the k-steps in
// increasing order from acc = 0.
//
// f32 operands are split into kTerms bf16 terms (split3, as K7's
// kd_feature_mse.cu; ops/kd_loss.py::split_bf16), each the bf16 rounding of
// what the earlier terms left; bf16 products are exact in f32, and the
// products a_i . b_j with i + j < kTerms give f32-level sums
// (ops/ir_fused.py::expand_e_emulated repeats this arithmetic on the CPU and
// chose three terms: two leave more than the limit of e at the main path's
// widths, tests/test_torch_ir_expand_split.py). bf16 operands are one exact
// term each. The tensor cores' f32 sums drift toward zero over many steps
// (as K7 found), so each k-step's products go to a fresh accumulator
// that is added to the running sum once, rounded to nearest (__fadd_rn).
//
// Fragments (PTX ISA, mma.m16n8k16 .bf16): lane = 4 g + t holds A at rows
// g, g + 8 and k 2t, 2t + 1 (+ 8), B at column g and k 2t, 2t + 1 (+ 8), and
// the sum at rows g, g + 8 and columns 2t, 2t + 1. B operands come
// pre-split from the wrapper (ops/ir_fused.py::mma_fragments): for n-tile j
// and k-step s, term i of lane l is the uint2 at ((j * ksteps + s) * terms
// + i) * 32 + l.

constexpr int kTerms = 3;

template <typename T> struct Mma;
template <> struct Mma<float> {
  using Pair = float2;                // two consecutive-k values of one operand
  static constexpr int terms = kTerms;  // bf16 terms of an operand
};
template <> struct Mma<__nv_bfloat16> {
  using Pair = uint32_t;              // a bf16x2, lower k in the low half
  static constexpr int terms = 1;
};

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> kTerms bf16x2 terms, x0 in the low half; each term the bf16
// rounding of what the earlier ones left (the differences are exact in f32).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&o)[kTerms]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(x0, hf.x), r1 = __fsub_rn(x1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  o[0] = bf2_bits(h);
  o[1] = bf2_bits(m);
  o[2] = bf2_bits(__floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y)));
}

// A thread's four A pairs (rows g, g + 8 at k 2t; then at k 2t + 8) or two
// B pairs (k 2t; k 2t + 8) as bf16 terms.
template <int N>
__device__ __forceinline__ void terms_of(uint32_t (&o)[kTerms][N], const float2 (&v)[N]) {
#pragma unroll
  for (int f = 0; f < N; ++f) {
    uint32_t q[kTerms];
    split3(v[f].x, v[f].y, q);
#pragma unroll
    for (int i = 0; i < kTerms; ++i) o[i][f] = q[i];
  }
}
template <int N>
__device__ __forceinline__ void terms_of(uint32_t (&o)[1][N], const uint32_t (&v)[N]) {
#pragma unroll
  for (int f = 0; f < N; ++f) o[0][f] = v[f];
}

// d += a . b over one m16n8k16 step.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step with split operands: acc += (sum of a_i . b_j over i + j <
// kTerms, smallest first, from a fresh zero accumulator), rounded to nearest.
template <int AT, int BT>
__device__ __forceinline__ void mma_step(float (&acc)[4], const uint32_t (&a)[AT][4],
                                         const uint32_t (&b)[BT][2]) {
  float tmp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = kTerms - 1; s >= 0; --s)
#pragma unroll
    for (int i = kTerms - 1; i >= 0; --i) {
      const int j = s - i;
      if (j >= 0 && i < AT && j < BT) mma_bf16(tmp, a[i], b[j][0], b[j][1]);
    }
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = __fadd_rn(acc[r], tmp[r]);
}

// mma_step on each tile of a warp's NM x NN block of tiles: tile (m, n) gets
// exactly mma_step's products, in mma_step's order, into its own fresh
// accumulator,
// so its sum is mma_step's bit for bit; but each product is issued for
// every tile before the next product, so the tensor pipe always has
// NM * NN independent products in flight instead of waiting on one tile's
// chain of six dependent ones.
template <int AT, int BT, int NM, int NN>
__device__ __forceinline__ void mma_step_tiles(float (&acc)[NM][NN][4],
                                               const uint32_t (&a)[NM][AT][4],
                                               const uint32_t (&b)[NN][BT][2]) {
  float tmp[NM][NN][4];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) tmp[m][n][r] = 0.f;
#pragma unroll
  for (int s = kTerms - 1; s >= 0; --s)
#pragma unroll
    for (int i = kTerms - 1; i >= 0; --i) {
      const int j = s - i;
      if (j >= 0 && i < AT && j < BT) {
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int m = 0; m < NM; ++m) mma_bf16(tmp[m][n], a[m][i], b[n][j][0], b[n][j][1]);
      }
    }
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] = __fadd_rn(acc[m][n][r], tmp[m][n][r]);
}

// This lane's pre-split B fragment of one (n-tile, k-step): `f` points at
// term 0 of lane 0 (terms 32 uint2 apart).
template <typename T>
__device__ __forceinline__ void load_b(uint32_t (&b)[Mma<T>::terms][2],
                                       const uint2* __restrict__ f, int lane) {
#pragma unroll
  for (int i = 0; i < Mma<T>::terms; ++i) {
    const uint2 v = __ldg(f + 32 * i + lane);
    b[i][0] = v.x;
    b[i][1] = v.y;
  }
}

// The same fragment from a block's copy of the fragment array in shared
// memory (K10 and K11 stage W2's there).
template <typename T>
__device__ __forceinline__ void smem_b(uint32_t (&b)[Mma<T>::terms][2], const uint2* f, int lane) {
#pragma unroll
  for (int i = 0; i < Mma<T>::terms; ++i) {
    const uint2 v = f[32 * i + lane];
    b[i][0] = v.x;
    b[i][1] = v.y;
  }
}

// The shared expand: one k-step of e = x . W1 for a 16 x 8 tile, from the
// thread's x terms (terms_of the four pairs the caller read from its own
// staging; split once and used for every n-tile of the k-step) and its W1
// fragment (load_b). e = round_to<T>(acc) after the last k-step.
template <typename T>
__device__ __forceinline__ void expand_step(float (&acc)[4], const uint32_t (&a)[Mma<T>::terms][4],
                                            const uint32_t (&w)[Mma<T>::terms][2]) {
  mma_step<Mma<T>::terms, Mma<T>::terms>(acc, a, w);
}

// How K9 and K12 share a halo's 16-pixel m-tiles and a 32-channel chunk's
// four 8-channel n-tiles among a block's 8 warps: warp w takes all four
// n-tiles of m-tiles w + 8 u, so each x fragment is split once and serves
// four n-tiles, and each W1 fragment all the warp's m-tiles. Which
// warp computes a tile does not change e: a pixel and a channel land in the
// same fragment position (16-pixel m-tiles of the same halo, 8-channel
// n-tiles of the same chunk) in both kernels.
template <int PIN>
struct HaloTiling {
  static constexpr int MT = (PIN + 15) / 16;
  static constexpr int NPW = 4;                   // n-tiles a warp
  static constexpr int UPW = (MT + 7) / 8;        // m-tiles a warp
  __device__ static int m0(int warp) { return warp; }
  __device__ static int n0(int) { return 0; }
};

// A warp's W1 fragments of one k-step (HaloTiling): w_at(j) points at
// n-tile j's. Loaded ahead of a barrier, they arrive while it waits.
template <typename T, typename HT, typename WAt>
__device__ __forceinline__ void halo_load_w(uint32_t (&w)[HT::NPW][Mma<T>::terms][2], int lane,
                                            WAt w_at) {
#pragma unroll
  for (int j = 0; j < HT::NPW; ++j) load_b<T>(w[j], w_at(j), lane);
}

// One k-step of a warp's share of a halo expand: acc[u][j] (m-tile m0 + 8 u,
// n-tile n0 + j) += this k-step of e, from x_at(r, k), the x pair of halo
// row r at the k-step's columns k, k + 1 in the caller's staging (zero past
// the halo), and the warp's W1 fragments w. Every (m-tile, n-tile) gets the
// same expand_step.
template <typename T, typename HT, typename XAt>
__device__ __forceinline__ void halo_expand_step(float (&acc)[HT::UPW][HT::NPW][4], int m0,
                                                 int lane,
                                                 const uint32_t (&w)[HT::NPW][Mma<T>::terms][2],
                                                 XAt x_at) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < HT::UPW; ++u) {
    const int mt = m0 + 8 * u;
    if (mt < HT::MT) {
      typename Mma<T>::Pair xa[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) xa[f] = x_at(16 * mt + g + 8 * (f & 1), 2 * t + 8 * (f >> 1));
      uint32_t a[Mma<T>::terms][4];
      terms_of(a, xa);
#pragma unroll
      for (int j = 0; j < HT::NPW; ++j) expand_step<T>(acc[u][j], a, w[j]);
    }
  }
}

// One pair of row r, columns c and c + 1, of a row-major shared-memory
// matrix of T with row stride ld (elements).
__device__ __forceinline__ float2 pair_at(const float* m, int r, int c, int ld) {
  return *reinterpret_cast<const float2*>(m + r * ld + c);
}
__device__ __forceinline__ uint32_t pair_at(const __nv_bfloat16* m, int r, int c, int ld) {
  return *reinterpret_cast<const uint32_t*>(m + r * ld + c);
}
template <typename T> __device__ __forceinline__ typename Mma<T>::Pair zero_pair();
template <> __device__ __forceinline__ float2 zero_pair<float>() { return make_float2(0.f, 0.f); }
template <> __device__ __forceinline__ uint32_t zero_pair<__nv_bfloat16>() { return 0u; }

// Row width (elements) of a staged tile of c channels of T: c padded to 16
// (a k-step), then to at least 128 bytes, which x_chunk's swizzle needs.
__host__ __device__ inline int row_ld(int c, int es) {
  const int per = 128 / es;
  return ((c + 15) / 16 * 16 + per - 1) / per * per;
}

// Physical 16-byte chunk of logical chunk c of staged row r (rows of
// row_ld): for f32 a half-warp's float2 fragment reads of rows g..g+3 land
// on four 8-bank groups, for bf16 a warp's 32-bit reads (or one ldmatrix
// phase) of rows g..g+7 on eight 4-bank groups.
template <typename T> __device__ __forceinline__ int x_chunk(int r, int c) {
  return sizeof(T) == 4 ? c ^ ((r & 3) << 1) : c ^ (r & 7);
}

// Two values (rounded to T) to consecutive elements of shared memory.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// cp.async helpers (16-byte copies; zero-filled when !valid).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ldmatrix: lane l gives the row address of row (l & 7) of matrix l >> 3;
// .trans hands each lane the transposed fragment (a pixel-major tile read as
// the K operand of a product over pixels).
__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&d)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(d[0]), "=r"(d[1]) : "r"(smem_u32(p)));
}

// out[g][c] = sum of in[r][c] over rows r of group g ([g * rpg, (g+1) * rpg)
// clipped to nrow). Block: 32 columns x 8 row lanes; lane l adds rows
// r = l (mod 8) in increasing order, then the 8 lane sums are added in
// order. The order depends on the sizes only.
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const float* __restrict__ in, float* __restrict__ out, long long nrow,
              long long ncol, long long rpg) {
  __shared__ float sh[8][33];
  const int cx = threadIdx.x & 31, ly = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * 32 + cx;
  const long long r0 = (long long)blockIdx.y * rpg;
  const long long r1 = r0 + rpg < nrow ? r0 + rpg : nrow;
  float s = 0.f;
  if (c < ncol)
    for (long long r = r0 + ly; r < r1; r += 8) s += in[r * ncol + c];
  sh[ly][cx] = s;
  __syncthreads();
  if (ly == 0 && c < ncol) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < 8; ++l) t += sh[l][cx];
    out[(long long)blockIdx.y * ncol + c] = t;
  }
}

// Sums the rows of in [nrow][ncol] into out [ncol]. With nrow > rpg the
// rows are first summed in groups of rpg into scratch [ceil(nrow/rpg)][ncol]
// (which the caller allocates), then those group sums are added.
inline cudaError_t sum_rows(const float* in, long long nrow, long long ncol, int rpg,
                            float* scratch, float* out, cudaStream_t s) {
  if (nrow <= 0 || ncol <= 0 || rpg <= 0) return cudaErrorInvalidValue;
  const long long gx = (ncol + 31) / 32;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (nrow > rpg) {
    const long long g = (nrow + rpg - 1) / rpg;
    if (!scratch || g > 65535) return cudaErrorInvalidValue;
    colsum_kernel<<<dim3((unsigned)gx, (unsigned)g), kThreads, 0, s>>>(in, scratch, nrow, ncol,
                                                                       rpg);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    in = scratch;
    nrow = g;
  }
  colsum_kernel<<<dim3((unsigned)gx, 1), kThreads, 0, s>>>(in, out, nrow, ncol, nrow);
  return cudaGetLastError();
}

}  // namespace irt
