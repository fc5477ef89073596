// Fused InvertedResidual training, pass 1: the batch statistics of the
// expand 1x1 output, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/ir_fused.py::_stats1_kernel
// (launched from _ir_train_forward once per 128-lane chunk of the hidden
// dim, grid (B,), sums carried in VMEM scratch across the grid):
//
//   e = (x . W1) rounded to the input dtype   (never stored)
//   sum[c] = sum_p e[p, c],  sq[c] = sum_p e[p, c]^2   (f32)
//
// x [M, Cin] (M = B*H*W pixels, NHWC) in f32 or bf16, W1 [Cin, Ce] as f32
// holding input-dtype values. One launch covers every hidden channel.
//
// Design: a tiled SIMT GEMM. A block owns 128 pixels x 64 hidden channels
// and walks Cin in chunks of 32, x's chunk staged transposed in shared
// memory; each thread keeps an 8-pixel x 4-channel register tile. The
// epilogue rounds e, squares it and reduces the block's 128 rows per
// channel (threads, then the 16 row groups in order) to one partial per
// block; sum_rows adds the partials in a fixed order. No float atomics.
//
// Bound on the H100: operations, 2*M*Cin*Ce multiply-adds on CUDA cores
// (f32; TF32 would change the numerics): 25.8 GFLOP at B=128 for each of
// the student's stages 2-5, 0.39 ms at 67 TFLOP/s, against M*Cin reads.

#include "ir_train_common.cuh"

namespace {

using namespace irt;

constexpr int kBM = 128, kBN = 64, kBK = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
stats1_kernel(const T* __restrict__ x, const float* __restrict__ w1, float* __restrict__ part_s,
              float* __restrict__ part_q, long long M, int Cin, int Ce) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];
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

  for (int k0 = 0; k0 < Cin; k0 += kBK) {
    // x chunk [kBM rows][kBK] -> As[k][m]: consecutive threads read
    // consecutive channels of one pixel.
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      As[k][r] = (m0 + r < M && k0 + k < Cin) ? to_f(x[(m0 + r) * Cin + k0 + k]) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, n = e % kBN;
      Bs[k][n] = (k0 + k < Cin && n0 + n < Ce) ? w1[(size_t)(k0 + k) * Ce + n0 + n] : 0.f;
    }
    __syncthreads();
    tile_mma<8, 4>(acc, &As[0][0], kBM + 1, 1, &Bs[0][0], kBN, 1, kBK, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (m0 + ty + 16 * i < M) {
        const float e = round_to<T>(acc[i][j]);
        s += e;
        q = fmaf(e, e, q);
      }
    }
    red[0][ty][tx + 16 * j] = s;
    red[1][ty][tx + 16 * j] = q;
  }
  __syncthreads();
  if (tid < 2 * kBN) {
    const int which = tid / kBN, n = tid % kBN;
    if (n0 + n < Ce) {
      float t = 0.f;
      for (int g = 0; g < 16; ++g) t += red[which][g][n];
      (which ? part_q : part_s)[(size_t)blockIdx.x * Ce + n0 + n] = t;
    }
  }
}

template <typename T>
int launch(const void* x, const float* w1, float* part_s, float* part_q, float* scratch,
           float* sum, float* sq, long long M, int Cin, int Ce, int rpg, cudaStream_t s) {
  const long long gx = (M + kBM - 1) / kBM;
  const dim3 grid((unsigned)gx, (Ce + kBN - 1) / kBN);
  stats1_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), w1, part_s, part_q, M,
                                             Cin, Ce);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = sum_rows(part_s, gx, Ce, rpg, scratch, sum, s);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(part_q, gx, Ce, rpg, scratch, sq, s);
}

}  // namespace

// Number of per-block partial rows (the wrapper sizes part_s/part_q
// [rows][Ce] and the reduction scratch with it).
extern "C" int ir_train_stats1_rows(long long M) { return (int)((M + kBM - 1) / kBM); }

// x [M, Cin] (dtype 0 = f32, 1 = bf16), w1 [Cin, Ce] f32; part_s/part_q
// [rows][Ce] f32 scratch, scratch [ceil(rows/rpg)][Ce] f32 (may be null
// when rows <= rpg); sum/sq [Ce] f32 out.
extern "C" int ir_train_stats1(const void* x, const void* w1, void* part_s, void* part_q,
                               void* scratch, void* sum, void* sq, long long M, int Cin, int Ce,
                               int rpg, int dtype, void* stream) {
  if (M <= 0 || Cin <= 0 || Ce <= 0 || (M + kBM - 1) / kBM > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(w1);
  float* f[] = {static_cast<float*>(part_s), static_cast<float*>(part_q),
                static_cast<float*>(scratch), static_cast<float*>(sum), static_cast<float*>(sq)};
  if (dtype == 0) return launch<float>(x, w, f[0], f[1], f[2], f[3], f[4], M, Cin, Ce, rpg, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, f[0], f[1], f[2], f[3], f[4], M, Cin, Ce, rpg, s);
  return (int)cudaErrorInvalidValue;
}
