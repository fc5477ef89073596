// Fused InvertedResidual training backward, pass 1: through the project 1x1
// and ReLU6 of BN2, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/ir_fused.py::_proj_bwd_kernel
// (launched from _ir_train_backward once per 128-lane hidden chunk, grid
// (B,), dW2 and the sums carried in VMEM scratch across the grid):
//
//   d_act = relu6(d * s2 + b2) rounded,  dn = (d - m2) * inv2
//   dW2   = d_act^T . dy                                   [Ce, Cout] f32
//   dv2   = relu6'(d * s2 + b2) * (dy . W2^T)              stored rounded
//   ra[c] = sum_p dv2[p, c],  rb[c] = sum_p dv2[p, c] * dn[p, c]   (f32 dv2)
//
// relu6' is 1 strictly inside (0, 6) and 0 at the ties, as the TPU kernel's
// mask (:449). d, dy [M, Ce] / [M, Cout] (M = B*Ho*Wo) in f32 or bf16, the
// vectors [Ce] f32, W2 [Ce, Cout] as f32 holding input-dtype values.
//
// Design: two SIMT GEMMs in one entry point, each with its own tiling.
//  - dv2 (M x Ce, depth Cout): a block owns 128 pixels x 64 hidden channels
//    (8 x 4 register tile per thread); the epilogue reads d, masks, stores
//    dv2 and reduces the block's rows per channel to one partial of each sum.
//  - dW2 (Ce x Cout, depth M): split over the pixels; block z owns a span of
//    `split_rows` pixels and a 64 x 64 tile of dW2 (4 x 4 per thread), with
//    the BN2 + ReLU6 prologue in the staging of d; it writes one partial
//    dW2 tile.
// sum_rows adds the partials in a fixed order. No float atomics.
//
// Bound on the H100: operations, 4*M*Ce*Cout multiply-adds on CUDA cores
// (two GEMMs, f32): twice the forward project's, against reading d and dy
// and writing dv2.

#include "ir_train_common.cuh"

namespace {

using namespace irt;

constexpr int kBM = 128, kBN = 64, kBK = 32;  // dv2
constexpr int kWM = 64, kWN = 64;              // dW2 tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
dv2_kernel(const T* __restrict__ d, const T* __restrict__ dy, const float* __restrict__ s2,
           const float* __restrict__ b2, const float* __restrict__ m2,
           const float* __restrict__ inv2, const float* __restrict__ w2, T* __restrict__ dv2,
           float* __restrict__ part_a, float* __restrict__ part_b, long long M, int Ce,
           int Cout) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN + 1];
  __shared__ float red[2][16][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Cout; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      As[k][r] = (m0 + r < M && k0 + k < Cout) ? to_f(dy[(m0 + r) * Cout + k0 + k]) : 0.f;
    }
    // B(k = co, n = c) = W2[c, co]: consecutive threads read one row of W2.
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int n = e / kBK, k = e % kBK;
      Bs[k][n] = (k0 + k < Cout && n0 + n < Ce) ? w2[(size_t)(n0 + n) * Cout + k0 + k] : 0.f;
    }
    __syncthreads();
    tile_mma<8, 4>(acc, &As[0][0], kBM + 1, 1, &Bs[0][0], kBN + 1, 1, kBK, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + tx + 16 * j;
    float sa = 0.f, sb = 0.f;
    if (c < Ce) {
      const float sc = s2[c], bc = b2[c], mc = m2[c], ic = inv2[c];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long r = m0 + ty + 16 * i;
        if (r >= M) continue;
        const float dd = to_f(d[r * Ce + c]);
        const float v = acc[i][j] * relu6_mask(scale_shift(dd, sc, bc));
        dv2[r * Ce + c] = from_f<T>(v);
        sa += v;
        sb = fmaf(v, normalize(dd, mc, ic), sb);
      }
    }
    red[0][ty][tx + 16 * j] = sa;
    red[1][ty][tx + 16 * j] = sb;
  }
  __syncthreads();
  if (tid < 2 * kBN) {
    const int which = tid / kBN, n = tid % kBN;
    if (n0 + n < Ce) {
      float t = 0.f;
      for (int g = 0; g < 16; ++g) t += red[which][g][n];
      (which ? part_b : part_a)[(size_t)blockIdx.x * Ce + n0 + n] = t;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dw2_kernel(const T* __restrict__ d, const T* __restrict__ dy, const float* __restrict__ s2,
           const float* __restrict__ b2, float* __restrict__ part_w, long long M, int Ce,
           int Cout, int split_rows) {
  __shared__ float As[kBK][kWM];
  __shared__ float Bs[kBK][kWN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * kWM, n0 = blockIdx.y * kWN;
  const long long r_begin = (long long)blockIdx.z * split_rows;
  const long long r_end = r_begin + split_rows < M ? r_begin + split_rows : M;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kBK) {
    // A(k = pixel, m = c) = d_act: consecutive threads read consecutive c.
    for (int e = tid; e < kBK * kWM; e += kThreads) {
      const int k = e / kWM, m = e % kWM;
      const int c = c0 + m;
      float v = 0.f;
      if (r0 + k < r_end && c < Ce)
        v = round_to<T>(relu6(scale_shift(to_f(d[(r0 + k) * Ce + c]), s2[c], b2[c])));
      As[k][m] = v;
    }
    for (int e = tid; e < kBK * kWN; e += kThreads) {
      const int k = e / kWN, n = e % kWN;
      Bs[k][n] = (r0 + k < r_end && n0 + n < Cout) ? to_f(dy[(r0 + k) * Cout + n0 + n]) : 0.f;
    }
    __syncthreads();
    tile_mma<4, 4>(acc, &As[0][0], kWM, 1, &Bs[0][0], kWN, 1, kBK, tx, ty);
    __syncthreads();
  }

  float* pw = part_w + (size_t)blockIdx.z * Ce * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= Ce) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) pw[(size_t)c * Cout + n] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* d, const void* dy, const float* s2, const float* b2, const float* m2,
           const float* inv2, const float* w2, void* dv2, float* part_a, float* part_b,
           float* part_w, float* scratch, float* dw2, float* ra, float* rb, long long M, int Ce,
           int Cout, int split_rows, int rpg, cudaStream_t s) {
  const T* dp = static_cast<const T*>(d);
  const T* dyp = static_cast<const T*>(dy);
  const long long gx = (M + kBM - 1) / kBM;
  dv2_kernel<T><<<dim3((unsigned)gx, (Ce + kBN - 1) / kBN), kThreads, 0, s>>>(
      dp, dyp, s2, b2, m2, inv2, w2, static_cast<T*>(dv2), part_a, part_b, M, Ce, Cout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long nsplit = (M + split_rows - 1) / split_rows;
  dw2_kernel<T><<<dim3((Ce + kWM - 1) / kWM, (Cout + kWN - 1) / kWN, (unsigned)nsplit),
                  kThreads, 0, s>>>(dp, dyp, s2, b2, part_w, M, Ce, Cout, split_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = sum_rows(part_a, gx, Ce, rpg, scratch, ra, s);
  if (e != cudaSuccess) return (int)e;
  e = sum_rows(part_b, gx, Ce, rpg, scratch, rb, s);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(part_w, nsplit, (long long)Ce * Cout, rpg, scratch, dw2, s);
}

}  // namespace

// Number of per-block partial rows of ra/rb (part_a/part_b are [rows][Ce]).
extern "C" int ir_train_proj_bwd_rows(long long M) { return (int)((M + kBM - 1) / kBM); }

// d [M, Ce], dy [M, Cout], dv2 [M, Ce] out (dtype 0 = f32, 1 = bf16, all
// three the same); s2/b2/m2/inv2 [Ce] f32; w2 [Ce, Cout] f32; part_a/part_b
// [rows][Ce] f32; part_w [ceil(M/split_rows)][Ce*Cout] f32; scratch f32 of
// at least ceil(n/rpg) rows of each reduction's width (n its row count; may
// be null when every n <= rpg); dw2 [Ce, Cout], ra/rb [Ce] f32 out.
extern "C" int ir_train_proj_bwd(const void* d, const void* dy, const void* s2, const void* b2,
                                 const void* m2, const void* inv2, const void* w2, void* dv2,
                                 void* part_a, void* part_b, void* part_w, void* scratch,
                                 void* dw2, void* ra, void* rb, long long M, int Ce, int Cout,
                                 int split_rows, int rpg, int dtype, void* stream) {
  if (M <= 0 || Ce <= 0 || Cout <= 0 || split_rows <= 0 || (M + kBM - 1) / kBM > 0x7fffffffLL ||
      (M + split_rows - 1) / split_rows > 65535 || (Ce + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(s2), static_cast<const float*>(b2),
                      static_cast<const float*>(m2), static_cast<const float*>(inv2),
                      static_cast<const float*>(w2)};
  float* o[] = {static_cast<float*>(part_a), static_cast<float*>(part_b),
                static_cast<float*>(part_w), static_cast<float*>(scratch),
                static_cast<float*>(dw2), static_cast<float*>(ra), static_cast<float*>(rb)};
  if (dtype == 0)
    return launch<float>(d, dy, f[0], f[1], f[2], f[3], f[4], dv2, o[0], o[1], o[2], o[3], o[4],
                         o[5], o[6], M, Ce, Cout, split_rows, rpg, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(d, dy, f[0], f[1], f[2], f[3], f[4], dv2, o[0], o[1], o[2],
                                 o[3], o[4], o[5], o[6], M, Ce, Cout, split_rows, rpg, s);
  return (int)cudaErrorInvalidValue;
}
