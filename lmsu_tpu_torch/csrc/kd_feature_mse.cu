// KD feature-matching MSE partials, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/kd_loss_pallas.py::_feature_mse_kernel
// (launched from _mse_partials): per sample b,
//
//   part[b] = sum_{m, j} (S[b, m, j] - sum_k T[b, m, k] P[k, j])^2
//
// S [B, M, Cs] and T [B, M, Ct] in f32 or bf16 (widened in registers, as
// _mse_partials upcasts them), P [Ct, Cs] f32, all arithmetic f32. The
// projected teacher T.P never leaves the chip: it is a GEMM whose epilogue
// squares the difference with S and reduces it.
//
// Design: a tiled SIMT GEMM. A block owns kBM = 64 rows x kBN = 128 columns
// of one sample and walks Ct in kBK = 32 chunks: T's chunk is staged in
// shared memory transposed (so a thread's 4 rows are broadcast reads) and
// P's chunk as it is; each of the 256 threads keeps a 4-row x 8-column
// register tile (32 accumulators; columns tx + 16 j, so a warp's P reads
// hit 16 consecutive words). The epilogue reads S, squares the difference
// and reduces the block's 8192 terms (warp shuffles, then the 8 warp sums
// in order) to one partial in a buffer; a second kernel sums each sample's
// partials in a fixed order. No float atomics: the loss is deterministic.
//
// Bound on the H100: operations. 2 M Ct Cs multiply-adds per sample on
// CUDA cores (f32, no tensor cores): at B=8, M=4096, Ct=256, Cs=128 that is
// 2.15 GFLOP, 32 us at 67 TFLOP/s, against 50 MB read (15 us). The register
// tile issues one shared load per 2.7 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kThreads = 256;      // 16 x 16
constexpr int kTM = 4, kTN = 8;    // register tile per thread
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
kd_mse_tiles(const T* __restrict__ S, const T* __restrict__ Tt, const float* __restrict__ P,
             float* __restrict__ partials, int M, int Cs, int Ct) {
  __shared__ float Ts[kBK][kBM + 1];
  __shared__ float Ps[kBK][kBN];
  __shared__ float warp_sums[kThreads / 32];
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.z * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* Sb = S + (size_t)b * M * Cs;
  const T* Tb = Tt + (size_t)b * M * Ct;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Ct; k0 += kBK) {
    // T chunk [kBM rows][kBK] -> Ts[k][m]; consecutive threads take
    // consecutive k of one row (coalesced reads, conflict-free stores).
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      const int gm = m0 + r, gk = k0 + k;
      Ts[k][r] = (gm < M && gk < Ct) ? to_f(Tb[(size_t)gm * Ct + gk]) : 0.f;
    }
    // P chunk [kBK][kBN].
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, n = e % kBN;
      const int gk = k0 + k, gn = n0 + n;
      Ps[k][n] = (gk < Ct && gn < Cs) ? P[(size_t)gk * Cs + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], p[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = Ts[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) p[j] = Ps[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], p[j], acc[i][j]);
    }
    __syncthreads();
  }

  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < Cs) {
        const float diff = to_f(Sb[(size_t)gm * Cs + gn]) - acc[i][j];
        sum = fmaf(diff, diff, sum);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (tid % 32 == 0) warp_sums[tid / 32] = sum;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    partials[(size_t)b * gridDim.x * gridDim.z + blockIdx.z * gridDim.x + blockIdx.x] = s;
  }
}

// out[b] = sum of sample b's n partials, in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
kd_mse_reduce(const float* __restrict__ partials, float* __restrict__ out, int n) {
  __shared__ float warp_sums[kReduceThreads / 32];
  const float* pb = partials + (size_t)blockIdx.x * n;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) s += pb[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kReduceThreads / 32; ++w) t += warp_sums[w];
    out[blockIdx.x] = t;
  }
}

}  // namespace

// Number of per-block partials of one sample (the wrapper sizes the
// scratch buffer [B, n] with it).
extern "C" int kd_feature_mse_partials_per_sample(int M, int Cs) {
  return ((M + kBM - 1) / kBM) * ((Cs + kBN - 1) / kBN);
}

// S [B, M, Cs], T [B, M, Ct] (dtype 0 = f32, 1 = bf16, both the same),
// P [Ct, Cs] f32, scratch [B, partials_per_sample] f32, out [B] f32.
extern "C" int kd_feature_mse(const void* S, const void* T, const void* P, void* scratch,
                              void* out, int B, int M, int Cs, int Ct, int dtype,
                              void* stream) {
  if (B <= 0 || M <= 0 || Cs <= 0 || Ct <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kBM - 1) / kBM, B, (Cs + kBN - 1) / kBN);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  if (dtype == 0) {
    kd_mse_tiles<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(S), static_cast<const float*>(T),
        static_cast<const float*>(P), part, M, Cs, Ct);
  } else if (dtype == 1) {
    kd_mse_tiles<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(S), static_cast<const __nv_bfloat16*>(T),
        static_cast<const float*>(P), part, M, Cs, Ct);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kd_mse_reduce<<<B, kReduceThreads, 0, s>>>(part, static_cast<float*>(out),
                                             (int)(grid.x * grid.z));
  return (int)cudaGetLastError();
}
