// BEV scatter-max over CELL-SORTED points, the flat chunk-table forward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/scatter_sorted_pallas.py::
// _fwd_kernel_flat (launched from _forward when _FWD_FLAT is set). It
// computes what scatter_sorted_fwd.cu (K1) computes, split by points
// instead of by cells: the wrapper builds the TPU kernel's static chunk
// table (ops/scatter_sorted.py::chunk_table), one (point offset, 128-cell
// tile) pair per slot, S slots per image, each slot a window of cw sorted
// points. Here
//
//   grid (S, B); a block takes one slot. It stages the window's cell keys in
//   shared memory (points past N read as the sentinel HW), then its threads
//   run over channels and walk the window once, keeping the running max of
//   the current run of equal keys. Only the slot's own tile counts: keys
//   outside [tile * 128, min(tile * 128 + 128, HW)) are points of other
//   tiles (pulled in by the aligned-down start or the window's tail) or
//   sentinels, and are neither read nor placed.
//
// A run that touches neither end of the window lies wholly inside it, so
// its cell has one writer: a plain store. A run at the window's first or
// last point may continue in the neighbouring slot of the same tile, so it
// goes in with an atomic max, into an output that a first pass set to -inf;
// a last pass turns -inf (no point) into exactly 0 (include_self=False:
// all-negative points still land), as the TPU kernel's init and cleanup
// passes do. A max takes no rounding, so the atomics' order does not
// change the bits: deterministic and exact. f32 uses an integer atomicMax on
// non-negative bit patterns and an unsigned atomicMin on negative ones;
// bf16 a compare-and-swap on the aligned 32-bit word. Padding slots point at
// the all-sentinel tail and place nothing.
//
// Bound on the H100: bytes, as K1's (each valid point's row read once, the
// output written once); this kernel also writes the output in the -inf
// pass and reads and writes it in the cleanup pass. What it does that K1
// does not: a cell that takes thousands of points (zero-padded frames put
// them in the centre cell) is spread over many blocks, where K1 gives the
// whole run to one block's threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per block, one channel each
constexpr int kBatch = 8;         // points loaded ahead of the running max

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

__device__ __forceinline__ void atomic_max(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// v is a bf16 value widened to f32, so narrowing it back is exact.
__device__ __forceinline__ void atomic_max(__nv_bfloat16* addr, float v) {
  const size_t a = reinterpret_cast<size_t>(addr);
  unsigned int* word = reinterpret_cast<unsigned int*>(a & ~static_cast<size_t>(3));
  const unsigned int shift = (a & 2) ? 16u : 0u;
  const unsigned int bits = __bfloat16_as_ushort(__float2bfloat16(v));
  unsigned int old = *reinterpret_cast<volatile unsigned int*>(word);
  while (true) {
    const float cur = __uint_as_float(((old >> shift) & 0xffffu) << 16);
    if (!(v > cur)) return;
    const unsigned int next = (old & ~(0xffffu << shift)) | (bits << shift);
    const unsigned int seen = atomicCAS(word, old, next);
    if (seen == old) return;
    old = seen;
  }
}

template <typename T>
__global__ void fill_neg_inf(T* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    out[i] = from_f<T>(neg_inf());
  }
}

template <typename T>
__global__ void neg_inf_to_zero(T* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    if (to_f(out[i]) == neg_inf()) out[i] = from_f<T>(0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
scatter_sorted_fwd_flat_kernel(const T* __restrict__ feats, const int* __restrict__ keys,
                               const int* __restrict__ off, const int* __restrict__ tile,
                               T* __restrict__ out, int N, int C, int HW, int S, int cw,
                               int tile_w) {
  extern __shared__ int skeys[];  // [cw]
  const int b = blockIdx.y;
  const int o = off[(size_t)b * S + blockIdx.x];
  const int lo = tile[(size_t)b * S + blockIdx.x] * tile_w;
  const int hi = min(lo + tile_w, HW);
  const int* kb = keys + (size_t)b * N;
  for (int i = threadIdx.x; i < cw; i += blockDim.x) {
    const int p = o + i;
    skeys[i] = p < N ? kb[p] : HW;
  }
  __syncthreads();

  const T* fb = feats + (size_t)b * N * C;
  T* ob = out + (size_t)b * HW * C;
  for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
    int cur = skeys[0];
    float m = neg_inf();
    bool first = true;  // the current run starts at the window's first point
    for (int i0 = 0; i0 < cw; i0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int k = skeys[i0 + j];
        v[j] = (k >= lo && k < hi) ? to_f(fb[(size_t)(o + i0 + j) * C + ch]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int k = skeys[i0 + j];
        if (k != cur) {
          if (cur >= lo && cur < hi) {
            T* dst = ob + (size_t)cur * C + ch;
            if (first) atomic_max(dst, m); else *dst = from_f<T>(m);
          }
          cur = k;
          first = false;
          m = v[j];
        } else {
          m = fmaxf(m, v[j]);
        }
      }
    }
    if (cur >= lo && cur < hi) atomic_max(ob + (size_t)cur * C + ch, m);  // at the window's end
  }
}

template <typename T>
int launch(const void* feats, const void* keys, const void* off, const void* tile, void* out,
           int B, int N, int C, int HW, int S, int cw, int tile_w, cudaStream_t s) {
  T* o = static_cast<T*>(out);
  const size_t n = (size_t)B * HW * C;
  const size_t want_blocks = (n + 255) / 256;
  const int fill_blocks = want_blocks < 4096 ? (int)want_blocks : 4096;
  fill_neg_inf<T><<<fill_blocks, 256, 0, s>>>(o, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = C < kMaxThreads ? (C + 31) / 32 * 32 : kMaxThreads;
  scatter_sorted_fwd_flat_kernel<T><<<dim3(S, B), threads, cw * sizeof(int), s>>>(
      static_cast<const T*>(feats), static_cast<const int*>(keys),
      static_cast<const int*>(off), static_cast<const int*>(tile), o, N, C, HW, S, cw, tile_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  neg_inf_to_zero<T><<<fill_blocks, 256, 0, s>>>(o, n);
  return (int)cudaGetLastError();
}

}  // namespace

// feats [B, N, C] (dtype 0 = f32, 1 = bf16), keys [B, N] int32 sorted per
// row (sentinel HW for invalid points), off / tile [B, S] int32 (the chunk
// table: window start and tile of each slot), out [B, HW, C] of the feature
// dtype. cw is the window length (a multiple of 8), tile_w the cells per tile.
extern "C" int scatter_sorted_fwd_flat(const void* feats, const void* keys, const void* off,
                                       const void* tile, void* out, int B, int N, int C,
                                       int HW, int S, int cw, int tile_w, int dtype,
                                       void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || HW <= 0 || S <= 0 || tile_w <= 0 || cw <= 0 ||
      cw % kBatch != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(feats, keys, off, tile, out, B, N, C, HW, S, cw, tile_w, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(feats, keys, off, tile, out, B, N, C, HW, S, cw, tile_w, s);
  }
  return (int)cudaErrorInvalidValue;
}
