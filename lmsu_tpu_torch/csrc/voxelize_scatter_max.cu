// BEV scatter-max over UNSORTED points, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/voxelize_pallas.py::_scatter_max_kernel
// (launched from _forward). The TPU kernel keeps one image's whole
// [HW, C] grid in VMEM (2 MB at 64x64 cells, C=128, f32) and updates one
// row per point in a serial loop. A Hopper block has at most 227 KB of
// shared memory, so this kernel cuts the grid by channels instead:
//
//   grid (C / kSlice, B); a block owns kSlice consecutive channels of one
//   image and keeps an f32 [HW, kSlice] accumulator in shared memory
//   (128 KB at HW=4096, kSlice=8), set to -inf. Its threads stream every
//   point of the image: kSlice lanes per point, one channel each, and take
//   a shared-memory atomic max at the point's cell. Invalid points
//   (index HW) are skipped. Then the block writes its slice of every cell
//   once, -inf (no point) as exactly 0: include_self=False semantics, so
//   all-negative points still land.
//
// The float atomic max is an integer atomicMax on non-negative bit patterns
// and an unsigned atomicMin on negative ones (the sign bit decides, so -0.0
// takes the unsigned path). From -inf that orders every finite value as
// floats do, with -0.0 below +0.0, which compare equal. A max takes no
// rounding, so any order of the atomics gives the same bits: the result is
// deterministic and exact. bf16 is widened to f32 and narrowed back, which
// is exact. NaN features are outside the contract, as on the TPU.
//
// Bound on the H100: bytes. Each valid point's feature row is read once (by
// C / kSlice blocks, kSlice channels each), the indices once per block (L2
// serves the repeats) and the output written once. At B=8, N=5000, C=128,
// f32: 20.5 MB + 16.8 MB over 3.35 TB/s. One cell that takes many points
// (zero-padded frames put them all in the centre cell) serialises its
// atomics, which the skewed cloud of chip_smoke.py times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSlice = 8;  // channels per block; 4 * HW * kSlice bytes of shared memory

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
voxelize_scatter_max_kernel(const T* __restrict__ feats, const int* __restrict__ idx,
                            T* __restrict__ out, int N, int C, int HW, int slice) {
  extern __shared__ float acc[];  // [HW, slice]
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * slice;
  const int nch = min(slice, C - c0);
  const int total = HW * slice;
  for (int i = threadIdx.x; i < total; i += blockDim.x) acc[i] = neg_inf();
  __syncthreads();

  const int* ib = idx + (size_t)b * N;
  const T* fb = feats + (size_t)b * N * C + c0;
  const int lane = threadIdx.x % slice;
  const int per_pass = blockDim.x / slice;
  if (lane < nch) {
    for (int p = threadIdx.x / slice; p < N; p += per_pass) {
      const int cell = __ldg(ib + p);
      if (cell < 0 || cell >= HW) continue;  // invalid point (index HW)
      atomic_max_f32(&acc[cell * slice + lane], to_f(fb[(size_t)p * C + lane]));
    }
  }
  __syncthreads();

  T* ob = out + (size_t)b * HW * C + c0;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int cell = i / slice, ch = i % slice;
    if (ch >= nch) continue;
    const float v = acc[i];
    ob[(size_t)cell * C + ch] = from_f<T>(v == neg_inf() ? 0.f : v);
  }
}

template <typename T>
int launch(const void* feats, const void* idx, void* out, int B, int N, int C, int HW,
           cudaStream_t s) {
  // The widest slice whose accumulator fits the block's shared memory.
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int slice = kMaxSlice;
  while (slice > 1 && (size_t)HW * slice * sizeof(float) > (size_t)max_smem) slice /= 2;
  const size_t smem = (size_t)HW * slice * sizeof(float);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(voxelize_scatter_max_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + slice - 1) / slice, B);
  voxelize_scatter_max_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(feats), static_cast<const int*>(idx), static_cast<T*>(out),
      N, C, HW, slice);
  return (int)cudaGetLastError();
}

}  // namespace

// feats [B, N, C] (dtype 0 = f32, 1 = bf16), idx [B, N] int32 in [0, HW]
// (HW for invalid points), out [B, HW, C] of the feature dtype.
extern "C" int voxelize_scatter_max(const void* feats, const void* idx, void* out, int B,
                                    int N, int C, int HW, int dtype, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || HW <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(feats, idx, out, B, N, C, HW, s);
  if (dtype == 1) return launch<__nv_bfloat16>(feats, idx, out, B, N, C, HW, s);
  return (int)cudaErrorInvalidValue;
}
