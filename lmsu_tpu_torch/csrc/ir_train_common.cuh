// Pieces shared by the six kernels of the fused InvertedResidual training
// path (ir_train_*.cu), for Hopper (sm_90a). Each .cu file includes this
// header and builds into its own library.
//
// - element conversions and the input-dtype rounding the TPU kernels apply;
// - tile_mma: a 16 x 16-thread register-tile product over shared memory,
//   the body of every GEMM in these kernels (f32 on CUDA cores);
// - stage_x_halo / expand_halo: the input halo tile of one image and its
//   expand 1x1 (e = x . W1, rounded to the input dtype) for one chunk of 32
//   hidden channels, as ir_fused_infer.cu stages them;
// - sum_rows: the fixed-order reduction of per-block partials (no float
//   atomics, so every cross-block sum is deterministic).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace irt {

constexpr int kThreads = 256;  // every kernel of the path: 8 warps, 16 x 16
constexpr int kT = 8;          // spatial kernels: output tile side
constexpr int kKC = 32;        // spatial kernels: hidden channels per block

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

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

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

// acc[i][j] += sum_k A(k, ty + 16 i) * B(k, tx + 16 j), with A(k, m) =
// A[k * a_k + m * a_m] and B(k, n) = B[k * b_k + n * b_n] in shared memory.
// A warp spans two ty and sixteen tx: its A reads are broadcasts and its B
// reads hit consecutive words when b_n == 1 (or an odd stride).
template <int TM, int TN>
__device__ __forceinline__ void tile_mma(float (&acc)[TM][TN], const float* A, int a_k, int a_m,
                                         const float* B, int b_k, int b_n, int K, int tx,
                                         int ty) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[k * a_k + (ty + 16 * i) * a_m];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = B[k * b_k + (tx + 16 * j) * b_n];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Row stride of the transposed halo tile: a multiple of 4 (16-byte loads)
// with ppad % 32 == 4, which spreads the transposing stores over banks.
__host__ __device__ inline int halo_ppad(int pin) {
  int ppad = (pin + 3) / 4 * 4;
  while (ppad % 32 != 4) ppad += 4;
  return ppad;
}

// Stages image b's halo tile (tin x tin pixels from (iy0, ix0), all Cin
// channels; zero outside the image) transposed into xs [Cin][ppad], and the
// W1 columns [k0, k0 + kKC) into w1s [Cin][kKC] (zero past Ce). Cin % 4 == 0.
template <typename T>
__device__ __forceinline__ void stage_x_halo(const T* __restrict__ xb, const float* __restrict__ w1,
                                             float* xs, float* w1s, int H, int W, int Cin, int Ce,
                                             int iy0, int ix0, int tin, int ppad, int k0) {
  const int tid = threadIdx.x;
  const int pin = tin * tin;
  const int c4 = Cin / 4;
  for (int i0 = tid; i0 < pin * c4; i0 += 4 * kThreads) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < pin * c4) {
        const int p = i / c4, q = i - p * c4;
        const int iy = iy0 + p / tin, ix = ix0 + p % tin;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W)
          v[u] = load4(xb + ((size_t)iy * W + ix) * Cin + 4 * q);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      if (i < pin * c4) {
        const int p = i / c4, q = i - p * c4;
        float* d = xs + 4 * q * ppad + p;
        d[0] = v[u].x; d[ppad] = v[u].y; d[2 * ppad] = v[u].z; d[3 * ppad] = v[u].w;
      }
    }
  }
  for (int i = tid; i < Cin * kKC; i += kThreads) {
    const int ci = i / kKC, k = i - ci * kKC;
    w1s[i] = k0 + k < Ce ? w1[(size_t)ci * Ce + k0 + k] : 0.f;
  }
}

// Expands the staged halo tile for one chunk: e = x . W1 rounded to T, then
// e_act = relu6(e * s1 + b1) rounded to T (ir_fused.py:352-359). Writes
// e_act to ea [pin][kKC] (zero outside the image and past Ce: the depthwise
// conv pads e_act with zeros) and, when e_raw is not null, e to e_raw
// [pin][kKC]. Each thread computes a 4-pixel x 2-channel register tile.
template <typename T>
__device__ __forceinline__ void expand_halo(const float* xs, const float* w1s,
                                            const float* __restrict__ s1,
                                            const float* __restrict__ b1, float* ea, float* e_raw,
                                            int H, int W, int Cin, int Ce, int iy0, int ix0,
                                            int tin, int ppad, int k0) {
  const int tid = threadIdx.x;
  const int pin = tin * tin;
  const int kl = tid & 15;  // channel pair 2*kl, 2*kl+1
  const int pg = tid >> 4;  // pixel group (4 pixels)
  const int c0 = k0 + 2 * kl;
  const float sc0 = c0 < Ce ? s1[c0] : 0.f, bc0 = c0 < Ce ? b1[c0] : 0.f;
  const float sc1 = c0 + 1 < Ce ? s1[c0 + 1] : 0.f, bc1 = c0 + 1 < Ce ? b1[c0 + 1] : 0.f;
  for (int p0 = pg * 4; p0 < pin; p0 += 64) {
    float a[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
    for (int ci = 0; ci < Cin; ++ci) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + ci * ppad + p0);
      const float2 wv = *reinterpret_cast<const float2*>(w1s + ci * kKC + 2 * kl);
      a[0][0] = fmaf(xv.x, wv.x, a[0][0]); a[0][1] = fmaf(xv.x, wv.y, a[0][1]);
      a[1][0] = fmaf(xv.y, wv.x, a[1][0]); a[1][1] = fmaf(xv.y, wv.y, a[1][1]);
      a[2][0] = fmaf(xv.z, wv.x, a[2][0]); a[2][1] = fmaf(xv.z, wv.y, a[2][1]);
      a[3][0] = fmaf(xv.w, wv.x, a[3][0]); a[3][1] = fmaf(xv.w, wv.y, a[3][1]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = p0 + r;
      if (p >= pin) break;
      const int iy = iy0 + p / tin, ix = ix0 + p % tin;
      const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const float e0 = round_to<T>(a[r][0]), e1 = round_to<T>(a[r][1]);
      float2 v;
      v.x = (inside && c0 < Ce) ? round_to<T>(relu6(scale_shift(e0, sc0, bc0))) : 0.f;
      v.y = (inside && c0 + 1 < Ce) ? round_to<T>(relu6(scale_shift(e1, sc1, bc1))) : 0.f;
      *reinterpret_cast<float2*>(ea + p * kKC + 2 * kl) = v;
      if (e_raw) *reinterpret_cast<float2*>(e_raw + p * kKC + 2 * kl) = make_float2(e0, e1);
    }
  }
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
