// Fused InvertedResidual training backward, pass 3: through BN1 and the
// expand 1x1, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/ir_fused.py::_expand_bwd_kernel
// (launched from _ir_train_backward once per 128-lane hidden chunk, grid
// (B,), dW1 carried in VMEM scratch across the grid, the chunks' dx
// partials added in XLA):
//
//   e   = x . W1 rounded to the input dtype          (recomputed, not stored)
//   de  = (u1 * dv1 - p1 - q1 * (e - m1) * inv1) rounded       (BN1 backward)
//   dW1 = x^T . de                                   [Cin, Ce] f32
//   dx  = de . W1^T                                  [M, Cin] f32
//
// x [M, Cin] and dv1 [M, Ce] (M = B*H*W) in f32 or bf16, W1 [Cin, Ce] as f32
// holding input-dtype values, the vectors [Ce] f32.
//
// Design: one block per (span of `strip_rows` pixels, 64 hidden channels),
// walking its span 64 pixels at a time. For each 64-pixel tile it stages x
// transposed in shared memory, recomputes e for its 64 channels (a 4 x 4
// register tile per thread), forms de in shared memory, adds x^T . de to the
// block's dW1 tile (kept in registers across the span) and writes
// de . W1^T for its channels to its share of dx. Cross-block sums go to
// per-block partials: dW1 per span, dx per 64-channel block (as the TPU
// path adds per-chunk dx partials); sum_rows adds them in a fixed order.
// No float atomics.
//
// Bound on the H100: operations, 6*M*Cin*Ce multiply-adds on CUDA cores
// (the expand recompute, dW1 and dx; f32): 77.3 GFLOP at B=128 for each of
// the student's stages 2-5, against reading x and dv1 and writing dx (plus
// the dx partials: ceil(Ce/64) f32 copies of dx, written and read once).

#include "ir_train_common.cuh"

namespace {

using namespace irt;

constexpr int kRows = 64;  // pixels per tile
constexpr int kCB = 64;    // hidden channels per block
constexpr int kLd = kCB + 1;

// CJ = ceil(Cin / 16): x and W1 rows past Cin are zero in shared memory.
template <typename T, int CJ>
__global__ void __launch_bounds__(kThreads)
expand_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ m1, const float* __restrict__ inv1,
                  const float* __restrict__ u1, const float* __restrict__ p1,
                  const float* __restrict__ q1, const T* __restrict__ dv1,
                  float* __restrict__ dxp, float* __restrict__ dw1p, long long M, int Cin,
                  int Ce, int strip_rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kCin = 16 * CJ;
  float* xs = smem;                  // [kCin][kRows + 1]  x^T of the tile
  float* w1s = xs + kCin * (kRows + 1);  // [kCin][kLd]     W1 columns of the block
  float* des = w1s + kCin * kLd;     // [kRows][kLd]       de of the tile
  float* vec = des + kRows * kLd;    // [5][kCB]           m1, inv1, u1, p1, q1

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.y * kCB;
  const long long r_begin = (long long)blockIdx.x * strip_rows;
  const long long r_end = r_begin + strip_rows < M ? r_begin + strip_rows : M;

  for (int i = tid; i < kCin * kCB; i += kThreads) {
    const int ci = i / kCB, k = i % kCB;
    w1s[ci * kLd + k] = (ci < Cin && c0 + k < Ce) ? w1[(size_t)ci * Ce + c0 + k] : 0.f;
  }
  for (int i = tid; i < 5 * kCB; i += kThreads) {
    const int v = i / kCB, k = i % kCB;
    const float* src = v == 0 ? m1 : v == 1 ? inv1 : v == 2 ? u1 : v == 3 ? p1 : q1;
    vec[i] = c0 + k < Ce ? src[c0 + k] : 0.f;
  }

  float gw[CJ][4];  // dW1[ci = ty + 16 i][c0 + tx + 16 j] over the span
#pragma unroll
  for (int i = 0; i < CJ; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gw[i][j] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kRows) {
    __syncthreads();  // w1s/vec staged; the previous tile's xs and des consumed
    for (int i = tid; i < kRows * kCin; i += kThreads) {
      const int r = i / kCin, ci = i % kCin;
      xs[ci * (kRows + 1) + r] =
          (r0 + r < r_end && ci < Cin) ? to_f(x[(r0 + r) * Cin + ci]) : 0.f;
    }
    __syncthreads();

    // e for the tile: rows ty + 16 i, channels tx + 16 j.
    float ea[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ea[i][j] = 0.f;
    tile_mma<4, 4>(ea, xs, kRows + 1, 1, w1s, kLd, 1, kCin, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = tx + 16 * j;
        float de = 0.f;
        if (r0 + r < r_end && c0 + k < Ce) {
          const float en = normalize(round_to<T>(ea[i][j]), vec[k], vec[kCB + k]);
          const float g = to_f(dv1[(r0 + r) * Ce + c0 + k]);
          de = round_to<T>(
              bn_backward(vec[2 * kCB + k], g, vec[3 * kCB + k], vec[4 * kCB + k], en));
        }
        des[r * kLd + k] = de;
      }
    }
    __syncthreads();

    // dW1 += x^T . de: A(k = pixel, m = ci) = xs[ci][pixel], B(k, n) = des.
    tile_mma<CJ, 4>(gw, xs, 1, kRows + 1, des, kLd, 1, kRows, tx, ty);

    // This block's share of dx: A(k = c, m = pixel) = des[pixel][c],
    // B(k = c, n = ci) = w1s[ci][c].
    float dx[4][CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) dx[i][j] = 0.f;
    tile_mma<4, CJ>(dx, des, 1, kLd, w1s, 1, kLd, kCB, tx, ty);
    float* out = dxp + (size_t)blockIdx.y * M * Cin;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long r = r0 + ty + 16 * i;
      if (r >= r_end) continue;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int ci = tx + 16 * j;
        if (ci < Cin) out[r * Cin + ci] = dx[i][j];
      }
    }
  }

  float* pw = dw1p + (size_t)blockIdx.x * Cin * Ce;
#pragma unroll
  for (int i = 0; i < CJ; ++i) {
    const int ci = ty + 16 * i;
    if (ci >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = c0 + tx + 16 * j;
      if (k < Ce) pw[(size_t)ci * Ce + k] = gw[i][j];
    }
  }
}

size_t smem_bytes(int cj) {
  return sizeof(float) * ((size_t)16 * cj * (kRows + 1) + (size_t)16 * cj * kLd +
                          (size_t)kRows * kLd + 5 * kCB);
}

template <typename T, int CJ>
int launch_cj(const void* x, const float* const* f, const void* dv1, float* dxp, float* dw1p,
              float* scratch, float* dx, float* dw1, long long M, int Cin, int Ce,
              int strip_rows, int rpg, cudaStream_t s) {
  const size_t smem = smem_bytes(CJ);
  cudaError_t e = cudaFuncSetAttribute(expand_bwd_kernel<T, CJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nstrip = (M + strip_rows - 1) / strip_rows;
  const int ncb = (Ce + kCB - 1) / kCB;
  expand_bwd_kernel<T, CJ><<<dim3((unsigned)nstrip, ncb), kThreads, smem, s>>>(
      static_cast<const T*>(x), f[0], f[1], f[2], f[3], f[4], f[5], static_cast<const T*>(dv1),
      dxp, dw1p, M, Cin, Ce, strip_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = sum_rows(dxp, ncb, M * Cin, rpg, scratch, dx, s);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(dw1p, nstrip, (long long)Cin * Ce, rpg, scratch, dw1, s);
}

template <typename T>
int launch(const void* x, const float* const* f, const void* dv1, float* dxp, float* dw1p,
           float* scratch, float* dx, float* dw1, long long M, int Cin, int Ce, int strip_rows,
           int rpg, cudaStream_t s) {
#define EB_LAUNCH(J) launch_cj<T, J>(x, f, dv1, dxp, dw1p, scratch, dx, dw1, M, Cin, Ce, \
                                     strip_rows, rpg, s)
  if (Cin <= 16) return EB_LAUNCH(1);
  if (Cin <= 32) return EB_LAUNCH(2);
  if (Cin <= 64) return EB_LAUNCH(4);
  return EB_LAUNCH(8);
#undef EB_LAUNCH
}

}  // namespace

// Number of 64-channel blocks (the rows of the dx partials).
extern "C" int ir_train_expand_bwd_cblocks(int Ce) { return (Ce + kCB - 1) / kCB; }

// x [M, Cin], dv1 [M, Ce] (dtype 0 = f32, 1 = bf16, both the same); w1
// [Cin, Ce] f32 holding input-dtype values; m1/inv1/u1/p1/q1 [Ce] f32;
// dxp [ceil(Ce/64)][M][Cin] and dw1p [ceil(M/strip_rows)][Cin*Ce] f32
// partials; scratch f32 of at least ceil(n/rpg) rows of each reduction's
// width (n its row count; may be null when every n <= rpg); dx [M, Cin] and
// dw1 [Cin, Ce] f32 out. Cin <= 128; strip_rows a multiple of 64.
extern "C" int ir_train_expand_bwd(const void* x, const void* w1, const void* m1,
                                   const void* inv1, const void* u1, const void* p1,
                                   const void* q1, const void* dv1, void* dxp, void* dw1p,
                                   void* scratch, void* dx, void* dw1, long long M, int Cin,
                                   int Ce, int strip_rows, int rpg, int dtype, void* stream) {
  if (M <= 0 || Cin <= 0 || Cin > 128 || Ce <= 0 || strip_rows <= 0 || strip_rows % kRows ||
      (M + strip_rows - 1) / strip_rows > 0x7fffffffLL || (Ce + kCB - 1) / kCB > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(w1), static_cast<const float*>(m1),
                      static_cast<const float*>(inv1), static_cast<const float*>(u1),
                      static_cast<const float*>(p1), static_cast<const float*>(q1)};
  float* o[] = {static_cast<float*>(dxp), static_cast<float*>(dw1p), static_cast<float*>(scratch),
                static_cast<float*>(dx), static_cast<float*>(dw1)};
  if (dtype == 0)
    return launch<float>(x, f, dv1, o[0], o[1], o[2], o[3], o[4], M, Cin, Ce, strip_rows, rpg, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, f, dv1, o[0], o[1], o[2], o[3], o[4], M, Cin, Ce, strip_rows,
                                 rpg, s);
  return (int)cudaErrorInvalidValue;
}
