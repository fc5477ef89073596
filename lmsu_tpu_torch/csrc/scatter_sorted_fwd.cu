// BEV scatter-max over CELL-SORTED points, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/scatter_sorted_pallas.py::_fwd_kernel
// (launched from _forward). The TPU design scans each chunk with circular
// roll-max passes and places segment maxima with one-hot matrix products,
// because the TPU has no cheap dynamic addressing. A GPU addresses memory
// freely, so this kernel is a plain segmented reduction:
//
//   grid (cell tiles, B); a block owns kCells consecutive BEV cells of one
//   batch row. Threads 0..kCells binary-search the sorted keys for the
//   span starts [lower_bound(c), lower_bound(c+1)); then the threads run
//   over channels and take the max over each cell's span. An empty span
//   writes exactly 0 (include_self=False semantics: the zero init never
//   enters a max, so all-negative points still land).
//
// No atomics: every output element has one writer, so the result is
// deterministic and exact (max only moves values; bf16 is widened to f32
// and narrowed back, which is exact).
//
// Bound on the H100: bytes. Each feature row is read once (the spans
// partition the points) and each output row written once; the work is one
// compare per feature element. At B=8, N=5000, C=128, f32: 20.5 MB read +
// 16.8 MB written over 3.35 TB/s. Rows of C channels are read by
// consecutive threads, so loads coalesce.
//
// Input contract: keys[b, :] = where(valid, flat_idx, H*W) is
// non-decreasing. Unsorted keys give wrong spans (silently, as on the TPU).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCells = 16;    // BEV cells per block
constexpr int kThreads = 128; // threads per block, striding over channels

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ int lower_bound(const int* __restrict__ keys, int n, int value) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < value) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_sorted_fwd_kernel(const T* __restrict__ feats, const int* __restrict__ keys,
                          T* __restrict__ out, int N, int C, int HW) {
  __shared__ int bounds[kCells + 1];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCells;
  const int* kb = keys + (size_t)b * N;
  if (threadIdx.x <= kCells) {
    bounds[threadIdx.x] = lower_bound(kb, N, min(c0 + (int)threadIdx.x, HW));
  }
  __syncthreads();
  const T* fb = feats + (size_t)b * N * C;
  T* ob = out + (size_t)b * HW * C;
  const int ncell = min(kCells, HW - c0);
  for (int i = 0; i < ncell; ++i) {
    const int lo = bounds[i], hi = bounds[i + 1];
    for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
      float m = 0.f;
      if (lo < hi) {
        m = to_f(fb[(size_t)lo * C + ch]);
        for (int p = lo + 1; p < hi; ++p) m = fmaxf(m, to_f(fb[(size_t)p * C + ch]));
      }
      ob[(size_t)(c0 + i) * C + ch] = from_f<T>(m);
    }
  }
}

}  // namespace

// feats [B, N, C] (dtype 0 = f32, 1 = bf16), keys [B, N] int32 sorted per
// row (sentinel HW for invalid points), out [B, HW, C] of the feature dtype.
extern "C" int scatter_sorted_fwd(const void* feats, const void* keys, void* out,
                                  int B, int N, int C, int HW, int dtype,
                                  void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || HW <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((HW + kCells - 1) / kCells, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    scatter_sorted_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(feats), static_cast<const int*>(keys),
        static_cast<float*>(out), N, C, HW);
  } else if (dtype == 1) {
    scatter_sorted_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), static_cast<const int*>(keys),
        static_cast<__nv_bfloat16*>(out), N, C, HW);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
