// Weighted-fusion gate, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/fusion_pallas.py::_gate_kernel
// (launched from _gate_forward). Per BEV row (one pixel, C channels):
//
//   a   = [cam | lid] . W1^T + b1      (the concat 1x1 conv, W1 [C, 2C])
//   h   = relu(a)
//   d   = h . (w2[0] - w2[1]) + (b2[0] - b2[1])
//   g   = sigmoid(d)                   (2-way softmax == sigmoid of the
//                                       logit difference)
//   out = g * cam + (1 - g) * lid
//
// Design: one block per tile of 64 rows, 8 warps. The tile's [cam | lid]
// rows are staged in shared memory as f32 once, transposed; W1 streams
// through shared memory in K-chunks of 32 input channels (row stride C+1,
// so both the transposing store and the per-lane load are free of bank
// conflicts). Warp w owns rows 8w..8w+7 and lane l the output channels
// l, l+32, ...: per input channel a thread makes two 16-byte broadcast
// loads of its 8 rows and one load of W1 per 8 FMAs, and a row's h . w2d
// reduces with warp shuffles without leaving registers.
// The products run on CUDA cores in f32, as the TPU kernel accumulates in
// f32; the output is written in the input dtype.
//
// Bound on the H100: operations in f32 (2 * M * 2C * C for the product,
// M = B*H*W rows): at B=8, C=128, 2.15 GFLOP over 67 TFLOP/s against
// 50.5 MB of traffic over 3.35 TB/s. In bf16 the inputs halve and the
// type's peak is the tensor cores', so the bound becomes bytes; this
// kernel still computes on CUDA cores (tensor-core tiles are later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;       // rows per block: 8 per warp
constexpr int kRowPad = kRows + 4;  // row stride of the transposed tile (bank spread)
constexpr int kThreads = 256;   // 8 warps
constexpr int kK = 32;          // W1 input channels staged per chunk

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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

// Shared memory (floats): xs [2C][kRowPad] = the tile's [cam | lid] rows,
// transposed so one warp's 8 rows of an input channel are two 16-byte
// broadcast loads; ws [kK][C + 1] = a K-chunk of W1^T.
// CJ = C / 32 output channels per lane.
template <typename T, int CJ>
__global__ void __launch_bounds__(kThreads)
fusion_gate_kernel(const T* __restrict__ cam, const T* __restrict__ lid,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   T* __restrict__ out, int M) {
  constexpr int C = 32 * CJ;
  constexpr int twoC = 2 * C;
  constexpr int ws_stride = C + 1;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + twoC * kRowPad;
  const int row0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Stage the rows, four channels per load, four loads in flight per thread.
  constexpr int n4 = kRows * twoC / 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += 4 * kThreads) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / (twoC / 4), k = 4 * (i - r * (twoC / 4));
      const int row = row0 + r;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n4 && row < M)
        v[u] = k < C ? load4(cam + (size_t)row * C + k) : load4(lid + (size_t)row * C + k - C);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n4) {
        const int r = i / (twoC / 4), k = 4 * (i - r * (twoC / 4));
        float* d = xs + k * kRowPad + r;
        d[0] = v[u].x; d[kRowPad] = v[u].y; d[2 * kRowPad] = v[u].z; d[3 * kRowPad] = v[u].w;
      }
    }
  }

  float acc[8][CJ];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < twoC; k0 += kK) {
    __syncthreads();  // xs staged; the previous chunk of ws consumed
    // W1 rows j, input channels k0..k0+31: 16-byte loads, four in flight.
    for (int i0 = threadIdx.x; i0 < C * (kK / 4); i0 += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        const int j = i / (kK / 4), kk = 4 * (i - j * (kK / 4));
        v[u] = i < C * (kK / 4) ? load4(w1 + (size_t)j * twoC + k0 + kk)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        if (i < C * (kK / 4)) {
          const int j = i / (kK / 4), kk = 4 * (i - j * (kK / 4));
          float* d = ws + kk * ws_stride + j;
          d[0] = v[u].x; d[ws_stride] = v[u].y; d[2 * ws_stride] = v[u].z;
          d[3 * ws_stride] = v[u].w;
        }
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kK; ++kk) {
      const float4 x0 = *reinterpret_cast<const float4*>(xs + (k0 + kk) * kRowPad + warp * 8);
      const float4 x1 = *reinterpret_cast<const float4*>(xs + (k0 + kk) * kRowPad + warp * 8 + 4);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float w = ws[kk * ws_stride + lane + 32 * j];
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r][j] = fmaf(xv[r], w, acc[r][j]);
      }
    }
  }

  const float b2d = b2[0] - b2[1];
  float bias[CJ], w2d[CJ];
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int col = lane + 32 * j;
    bias[j] = b1[col];
    w2d[j] = w2[col] - w2[C + col];
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) part = fmaf(fmaxf(acc[r][j] + bias[j], 0.f), w2d[j], part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    const float g = 1.f / (1.f + expf(-(part + b2d)));
    const int rl = warp * 8 + r;
    const int row = row0 + rl;
    if (row < M) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = lane + 32 * j;
        const float c = xs[col * kRowPad + rl];
        const float l = xs[(C + col) * kRowPad + rl];
        out[(size_t)row * C + col] = from_f<T>(g * c + (1.f - g) * l);
      }
    }
  }
}

template <typename T, int CJ>
int launch(const void* cam, const void* lid, const float* w1, const float* b1,
           const float* w2, const float* b2, void* out, int M, cudaStream_t s) {
  constexpr int C = 32 * CJ;
  const size_t smem = sizeof(float) * ((size_t)2 * C * kRowPad + (size_t)kK * (C + 1));
  cudaError_t e = cudaFuncSetAttribute(fusion_gate_kernel<T, CJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (M + kRows - 1) / kRows;
  fusion_gate_kernel<T, CJ><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(cam), static_cast<const T*>(lid), w1, b1, w2, b2,
      static_cast<T*>(out), M);
  return (int)cudaGetLastError();
}

// Any other C: the same product, with the output channels in tiles of 128
// (4 a lane) and the 2C input channels in chunks of kK staged per tile (the
// rows' chunk transposed, W1's chunk for the tile), element loads, masked
// past C; each row's gate logit summed over the tiles in registers, then
// the blend reads cam and lid again. Off the main path (the student's and
// the 2x teacher's C are templated above); it lifts the channel limit, e.g.
// for a 4x teacher (C = 512).
constexpr int kNTile = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fusion_gate_any_c(const T* __restrict__ cam, const T* __restrict__ lid,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  T* __restrict__ out, int M, int C) {
  __shared__ float xs[kK][kRowPad];
  __shared__ float ws[kK][kNTile + 1];
  const int row0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int twoC = 2 * C;
  float dsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < C; n0 += kNTile) {
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    for (int k0 = 0; k0 < twoC; k0 += kK) {
      __syncthreads();  // the previous chunk consumed
      for (int i = threadIdx.x; i < kRows * kK; i += kThreads) {
        const int r = i / kK, kk = i - r * kK, k = k0 + kk, row = row0 + r;
        float v = 0.f;
        if (row < M && k < twoC)
          v = to_float(k < C ? cam[(size_t)row * C + k] : lid[(size_t)row * C + k - C]);
        xs[kk][r] = v;
      }
      for (int i = threadIdx.x; i < kNTile * kK; i += kThreads) {
        const int j = i / kK, kk = i - j * kK;
        ws[kk][j] = (n0 + j < C && k0 + kk < twoC) ? w1[(size_t)(n0 + j) * twoC + k0 + kk] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float w = ws[kk][lane + 32 * j];
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r][j] = fmaf(xs[kk][warp * 8 + r], w, acc[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + lane + 32 * j;
        if (col < C) part = fmaf(fmaxf(acc[r][j] + b1[col], 0.f), w2[col] - w2[C + col], part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      dsum[r] += part;
    }
  }
  const float b2d = b2[0] - b2[1];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = row0 + warp * 8 + r;
    if (row >= M) continue;
    const float g = 1.f / (1.f + expf(-(dsum[r] + b2d)));
    for (int col = lane; col < C; col += 32) {
      const float c = to_float(cam[(size_t)row * C + col]);
      const float l = to_float(lid[(size_t)row * C + col]);
      out[(size_t)row * C + col] = from_f<T>(g * c + (1.f - g) * l);
    }
  }
}

template <typename T>
int launch_c(const void* cam, const void* lid, const float* w1, const float* b1,
             const float* w2, const float* b2, void* out, int M, int C, cudaStream_t s) {
  switch (C) {
    case 32: return launch<T, 1>(cam, lid, w1, b1, w2, b2, out, M, s);
    case 64: return launch<T, 2>(cam, lid, w1, b1, w2, b2, out, M, s);
    case 128: return launch<T, 4>(cam, lid, w1, b1, w2, b2, out, M, s);
    case 256: return launch<T, 8>(cam, lid, w1, b1, w2, b2, out, M, s);
    default:
      fusion_gate_any_c<T><<<(M + kRows - 1) / kRows, kThreads, 0, s>>>(
          static_cast<const T*>(cam), static_cast<const T*>(lid), w1, b1, w2, b2,
          static_cast<T*>(out), M, C);
      return (int)cudaGetLastError();
  }
}

}  // namespace

// cam, lid, out [M, C] (dtype 0 = f32, 1 = bf16); w1 [C, 2C], b1 [C],
// w2 [2, C], b2 [2] f32 (the torch layouts of attention.0 and attention.2).
// Any C >= 1 (32, 64, 128 and 256 take the templated kernel).
extern "C" int fusion_gate_fwd(const void* cam, const void* lid, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               void* out, int M, int C, int dtype, void* stream) {
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fw1 = static_cast<const float*>(w1);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fw2 = static_cast<const float*>(w2);
  const float* fb2 = static_cast<const float*>(b2);
  if (dtype == 0) return launch_c<float>(cam, lid, fw1, fb1, fw2, fb2, out, M, C, s);
  if (dtype == 1) return launch_c<__nv_bfloat16>(cam, lid, fw1, fb1, fw2, fb2, out, M, C, s);
  return (int)cudaErrorInvalidValue;
}
