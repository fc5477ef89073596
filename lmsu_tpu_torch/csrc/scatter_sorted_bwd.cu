// BEV scatter-max over CELL-SORTED points, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/scatter_sorted_pallas.py::_bwd_kernel
// (launched from _backward). It computes the VJP of the segmented max with
// the gradient split evenly over tied winners:
//
//   d[p, c] = [feat[p, c] == out[cell(p), c]] * g[cell(p), c] / max(ties, 1)
//   ties[cell, c] = #{p in cell : feat[p, c] == out[cell, c]}
//
// and d = 0 for invalid points (key == HW). The TPU kernel gathers out and g
// per point and counts ties with one-hot placement matmuls, and splits the
// counts into two bf16-exact parts because its matrix unit rounds f32
// operands; here the counts are plain integers, exact at any size.
//
//   grid (cell tiles + tail blocks, B). A cell-tile block owns kCells
//   consecutive cells of one batch row: threads 0..kCells binary-search the
//   sorted keys for the span starts, then per cell the threads run over
//   channels, count the winners over the cell's span (first pass over the
//   span), and write d for the span (second pass). Tail blocks zero the
//   rows of invalid points, which sort past every cell's span, kTail points
//   each.
//
// No atomics: every d element has one writer, so the result is exact and
// deterministic. f32 division, result cast to the feature dtype; g arrives
// in the output's dtype (the JAX side casts it so at :466-468).
//
// Bound on the H100: bytes. Features, keys, out and g are read once and d
// written once (the second pass over a span hits L1/L2); one compare per
// element and a division per written winner. At B=8, N=5000, C=128, f32:
// 20.5 MB of features + 2 x 16.8 MB of out and g + 20.5 MB of d.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCells = 16;    // BEV cells per block
constexpr int kThreads = 128; // threads per block, striding over channels
constexpr int kTail = 64;     // invalid points zeroed per tail block

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
scatter_sorted_bwd_kernel(const T* __restrict__ feats, const int* __restrict__ keys,
                          const T* __restrict__ out, const T* __restrict__ g,
                          T* __restrict__ d, int N, int C, int HW, int ntiles) {
  __shared__ int bounds[kCells + 1];
  const int b = blockIdx.y;
  const int* kb = keys + (size_t)b * N;
  const T* fb = feats + (size_t)b * N * C;
  T* db = d + (size_t)b * N * C;

  if ((int)blockIdx.x >= ntiles) {  // tail block: zero rows of invalid points
    if (threadIdx.x == 0) bounds[0] = lower_bound(kb, N, HW);
    __syncthreads();
    const int p0 = max(bounds[0], ((int)blockIdx.x - ntiles) * kTail);
    const int p1 = min(N, ((int)blockIdx.x - ntiles + 1) * kTail);
    for (int p = p0; p < p1; ++p)
      for (int ch = threadIdx.x; ch < C; ch += blockDim.x)
        db[(size_t)p * C + ch] = from_f<T>(0.f);
    return;
  }

  const int c0 = blockIdx.x * kCells;
  if (threadIdx.x <= kCells) {
    bounds[threadIdx.x] = lower_bound(kb, N, min(c0 + (int)threadIdx.x, HW));
  }
  __syncthreads();
  const T* ob = out + (size_t)b * HW * C;
  const T* gb = g + (size_t)b * HW * C;
  const int ncell = min(kCells, HW - c0);
  for (int i = 0; i < ncell; ++i) {
    const int lo = bounds[i], hi = bounds[i + 1];
    if (lo >= hi) continue;
    const size_t cell = (size_t)(c0 + i) * C;
    for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
      const float m = to_f(ob[cell + ch]);
      int ties = 0;
      for (int p = lo; p < hi; ++p) ties += to_f(fb[(size_t)p * C + ch]) == m;
      const float share = to_f(gb[cell + ch]) / (float)max(ties, 1);
      for (int p = lo; p < hi; ++p) {
        const size_t k = (size_t)p * C + ch;
        db[k] = from_f<T>(to_f(fb[k]) == m ? share : 0.f);
      }
    }
  }
}

}  // namespace

// feats [B, N, C] (dtype 0 = f32, 1 = bf16), keys [B, N] int32 sorted per
// row (sentinel HW for invalid points), out and g [B, HW, C] and d [B, N, C]
// of the feature dtype.
extern "C" int scatter_sorted_bwd(const void* feats, const void* keys, const void* out,
                                  const void* g, void* d, int B, int N, int C, int HW,
                                  int dtype, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || HW <= 0) return (int)cudaErrorInvalidValue;
  const int ntiles = (HW + kCells - 1) / kCells;
  const dim3 grid(ntiles + (N + kTail - 1) / kTail, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    scatter_sorted_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(feats), static_cast<const int*>(keys),
        static_cast<const float*>(out), static_cast<const float*>(g),
        static_cast<float*>(d), N, C, HW, ntiles);
  } else if (dtype == 1) {
    scatter_sorted_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), static_cast<const int*>(keys),
        static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(d), N, C, HW, ntiles);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
