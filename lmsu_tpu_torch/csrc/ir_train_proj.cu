// Fused InvertedResidual training, pass 3: BN2 + ReLU6 + project 1x1, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/ir_fused.py::_proj_kernel (launched
// from _ir_train_forward once per 128-lane hidden chunk, grid (B,), the
// chunks' partial products added in XLA):
//
//   d_act = relu6(d * s2 + b2) rounded to the input dtype
//   y     = d_act . W2                       (f32 out)
//
// d [M, Ce] (M = B*Ho*Wo, NHWC) in f32 or bf16, s2/b2 [Ce] f32 (BN2 folded
// with the batch statistics), W2 [Ce, Cout] as f32 holding input-dtype
// values. One launch covers every hidden channel: the sum over Ce is one
// f32 accumulation in registers.
//
// Design: a tiled SIMT GEMM whose A-operand staging is the BN2 + ReLU6
// prologue. A block owns 128 pixels x 64 output channels and walks Ce in
// chunks of 32 (d's chunk transposed in shared memory); each thread keeps an
// 8-pixel x 4-channel register tile.
//
// Bound on the H100: operations, 2*M*Ce*Cout multiply-adds on CUDA cores
// (f32): 12.9 / 25.8 / 12.9 / 25.8 GFLOP for the student's stages 2-5 at
// B=128 and 4.3 GFLOP for stage 1, against reading d and writing y.

#include "ir_train_common.cuh"

namespace {

using namespace irt;

constexpr int kBM = 128, kBN = 64, kBK = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
proj_kernel(const T* __restrict__ d, const float* __restrict__ s2, const float* __restrict__ b2,
            const float* __restrict__ w2, float* __restrict__ y, long long M, int Ce, int Cout) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Ce; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      const int c = k0 + k;
      float v = 0.f;
      if (m0 + r < M && c < Ce)
        v = round_to<T>(relu6(scale_shift(to_f(d[(m0 + r) * Ce + c]), s2[c], b2[c])));
      As[k][r] = v;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, n = e % kBN;
      Bs[k][n] = (k0 + k < Ce && n0 + n < Cout) ? w2[(size_t)(k0 + k) * Cout + n0 + n] : 0.f;
    }
    __syncthreads();
    tile_mma<8, 4>(acc, &As[0][0], kBM + 1, 1, &Bs[0][0], kBN, 1, kBK, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) y[r * Cout + n] = acc[i][j];
    }
  }
}

}  // namespace

// d [M, Ce] (dtype 0 = f32, 1 = bf16), s2/b2 [Ce] f32, w2 [Ce, Cout] f32,
// y [M, Cout] f32 out.
extern "C" int ir_train_proj(const void* d, const void* s2, const void* b2, const void* w2,
                             void* y, long long M, int Ce, int Cout, int dtype, void* stream) {
  if (M <= 0 || Ce <= 0 || Cout <= 0 || (M + kBM - 1) / kBM > 0x7fffffffLL ||
      (Cout + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (Cout + kBN - 1) / kBN);
  const float* f[] = {static_cast<const float*>(s2), static_cast<const float*>(b2),
                      static_cast<const float*>(w2)};
  float* out = static_cast<float*>(y);
  if (dtype == 0)
    proj_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(d), f[0], f[1], f[2],
                                                 out, M, Ce, Cout);
  else if (dtype == 1)
    proj_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(d), f[0], f[1], f[2], out, M, Ce, Cout);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
