// Fused InvertedResidual block, inference, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/ir_fused.py::_ir_infer_kernel
// (launched from fused_ir_infer, which also splits the hidden channels into
// 128-lane chunks, one launch each, and adds the scale/bias/residual glue
// in XLA). Here the whole block is ONE launch:
//
//   e   = relu6((x . W1) * s1 + b1)        expand 1x1 + folded BN1
//   d   = relu6(dw3x3(e, stride) * s2 + b2) depthwise + folded BN2
//   y   = d . W2                            project 1x1
//   out = y * s3 + b3 (+ x if residual)     folded BN3, in-kernel epilogue
//
// Design: one block per (image, 8x8 output tile), 8 warps. The input tile
// plus its halo ((stride*7+3)^2 pixels, all Cin channels) is staged in
// shared memory once, transposed. The hidden channels are walked in chunks
// of 32: for each chunk the block computes e on the whole halo tile into
// shared memory (each thread a 4-pixel x 2-channel register tile: one
// 16-byte and one 8-byte shared load per 8 FMAs), the depthwise output d
// for the 64 output pixels (lane = channel, taps in registers), and
// accumulates the projection into registers (warp w owns output row w,
// lane l the output channels l, l+32, ...; two 16-byte broadcast loads of
// d per 8*COJ FMAs). The 6x-expanded hidden tensor never touches device
// memory; the block's only traffic is x (with a halo re-read), the weights
// and the output.
//
// Numerics follow the TPU kernel so bf16 compares tightly: f32 accumulation
// everywhere; e rounded to the input dtype after relu6 (ir_fused.py:231),
// the weights and depthwise taps rounded to the input dtype by the wrapper
// (:234, and the casts at :316-335, passed here as f32 values), d
// rounded to the input dtype before the projection (:239), the BN3 result
// rounded to the input dtype and the residual added in the input dtype
// (:340-344).
//
// Bound on the H100: f32 operations on CUDA cores for stages 2-5
// (2*(B*H*W*Cin*Ce + 9*B*Ho*Wo*Ce + B*Ho*Wo*Ce*Cout) over 67 TFLOP/s;
// TF32 would change the numerics) and bytes for the expansion-1 stage; in
// bf16 the type's tensor-core peak makes every stage bytes-bound. This
// kernel computes on CUDA cores in both dtypes; tensor-core tiles are
// later work. Staging loads are 16 bytes wide with four in flight per
// thread. The 32x32 stages give only 128 tiles at B=8; where shared memory
// lets two blocks share an SM, the wrapper splits each tile's hidden chunks
// over blocks (grid z) and a second small kernel sums the shares.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 8;          // output tile side
constexpr int kThreads = 256;  // 8 warps
constexpr int kKC = 32;        // hidden channels per chunk
constexpr int kDS = kT * kT + 4;  // row stride of the transposed d tile (bank spread)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

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

// Shared memory (floats), in order:
//   xs  [Cin][ppad]   input halo tile, transposed: 4 neighbouring pixels of
//                     one channel are one 16-byte load (ppad % 32 == 4
//                     spreads the transposing stores over banks)
//   es  [pin][kKC]    expanded chunk over the halo tile
//   w1s [Cin][kKC]    expand weights of the chunk
//   ds  [kKC][kDS]    depthwise output of the chunk, transposed
//   w2s [kKC][Cout]   project weights of the chunk
// COJ = output channels per lane / 32 (Cout <= 32 * COJ).
template <typename T, int COJ>
__global__ void __launch_bounds__(kThreads)
ir_infer_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ s1, const float* __restrict__ b1,
                const float* __restrict__ dw, const float* __restrict__ s2,
                const float* __restrict__ b2, const float* __restrict__ w2,
                const float* __restrict__ s3, const float* __restrict__ b3,
                T* __restrict__ out, float* __restrict__ partial, int H, int W,
                int Ho, int Wo, int Cin, int Ce, int Cout, int stride,
                int has_expand, int residual, int ppad) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tin = stride * (kT - 1) + 3;
  const int pin = tin * tin;
  float* xs = smem;
  float* es = xs + Cin * ppad;
  float* w1s = es + pin * kKC;
  float* ds = w1s + Cin * kKC;
  float* w2s = ds + kKC * kDS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles_x = (Wo + kT - 1) / kT;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * kT;
  const int ox0 = (blockIdx.x % tiles_x) * kT;
  const int iy0 = oy0 * stride - 1;
  const int ix0 = ox0 * stride - 1;
  const T* xb = x + (size_t)b * H * W * Cin;

  // Stage the halo tile once (zero outside the image), four channels per
  // load and four loads in flight per thread.
  {
    const int c4 = Cin / 4;
    for (int i0 = tid; i0 < pin * c4; i0 += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < pin * c4) {
          const int p = i / c4, q = i - p * c4;
          const int iy = iy0 + p / tin, ix = ix0 + p % tin;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W)
            v[u] = load4(xb + ((size_t)iy * W + ix) * Cin + 4 * q);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        if (i < pin * c4) {
          const int p = i / c4, q = i - p * c4;
          float* d = xs + 4 * q * ppad + p;
          d[0] = v[u].x; d[ppad] = v[u].y; d[2 * ppad] = v[u].z; d[3 * ppad] = v[u].w;
        }
      }
    }
  }

  float acc[kT][COJ];
#pragma unroll
  for (int r = 0; r < kT; ++r)
#pragma unroll
    for (int j = 0; j < COJ; ++j) acc[r][j] = 0.f;

  const int kl = tid & 15;  // expand: channel pair 2*kl, 2*kl+1
  const int pg = tid >> 4;  // expand: pixel group (4 pixels)

  // With gridDim.z > 1 the block takes one share of the hidden chunks and
  // writes its raw projection sum to `partial`; ir_finalize_kernel adds the
  // shares and applies the epilogue.
  const int nchunks = (Ce + kKC - 1) / kKC;
  const int per = (nchunks + gridDim.z - 1) / gridDim.z;
  const int k_end = min(Ce, (int)(blockIdx.z + 1) * per * kKC);
  for (int k0 = blockIdx.z * per * kKC; k0 < k_end; k0 += kKC) {
    __syncthreads();  // xs staged; the previous chunk's es, ds and w2s consumed
    // Stage this chunk's weights: 16-byte loads, four in flight per thread
    // (rows past Ce are zero).
    if (has_expand) {
      for (int i0 = tid; i0 < Cin * (kKC / 4); i0 += 4 * kThreads) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kThreads;
          const int ci = i / (kKC / 4), k = 4 * (i - ci * (kKC / 4));
          v[u] = (i < Cin * (kKC / 4) && k0 + k < Ce)
                     ? load4(w1 + (size_t)ci * Ce + k0 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kThreads;
          if (i < Cin * (kKC / 4)) reinterpret_cast<float4*>(w1s)[i] = v[u];
        }
      }
    }
    for (int i0 = tid; i0 < kKC * Cout / 4; i0 += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = (i < kKC * Cout / 4 && k0 + (4 * i) / Cout < Ce)
                   ? load4(w2 + (size_t)k0 * Cout + 4 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        if (i < kKC * Cout / 4) reinterpret_cast<float4*>(w2s)[i] = v[u];
      }
    }
    __syncthreads();

    // Expand the halo tile: a 4-pixel x 2-channel register tile per thread,
    // e = relu6(x.W1 * s1 + b1) rounded to T, zero outside the image (the
    // depthwise conv pads its input, which is e).
    if (has_expand) {
      const int c0 = k0 + 2 * kl;
      const float sc0 = c0 < Ce ? s1[c0] : 0.f, bc0 = c0 < Ce ? b1[c0] : 0.f;
      const float sc1 = c0 + 1 < Ce ? s1[c0 + 1] : 0.f, bc1 = c0 + 1 < Ce ? b1[c0 + 1] : 0.f;
      for (int p0 = pg * 4; p0 < pin; p0 += 64) {
        float a[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
        for (int ci = 0; ci < Cin; ++ci) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + ci * ppad + p0);
          const float2 wv = *reinterpret_cast<const float2*>(w1s + ci * kKC + 2 * kl);
          a[0][0] = fmaf(xv.x, wv.x, a[0][0]); a[0][1] = fmaf(xv.x, wv.y, a[0][1]);
          a[1][0] = fmaf(xv.y, wv.x, a[1][0]); a[1][1] = fmaf(xv.y, wv.y, a[1][1]);
          a[2][0] = fmaf(xv.z, wv.x, a[2][0]); a[2][1] = fmaf(xv.z, wv.y, a[2][1]);
          a[3][0] = fmaf(xv.w, wv.x, a[3][0]); a[3][1] = fmaf(xv.w, wv.y, a[3][1]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = p0 + r;
          if (p >= pin) break;
          const int iy = iy0 + p / tin, ix = ix0 + p % tin;
          const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
          float2 v;
          v.x = (inside && c0 < Ce) ? round_to<T>(relu6(a[r][0] * sc0 + bc0)) : 0.f;
          v.y = (inside && c0 + 1 < Ce) ? round_to<T>(relu6(a[r][1] * sc1 + bc1)) : 0.f;
          *reinterpret_cast<float2*>(es + p * kKC + 2 * kl) = v;
        }
      }
    } else {
      for (int i = tid; i < pin * kKC; i += kThreads) {
        const int p = i / kKC, k = i - p * kKC;
        es[i] = (k0 + k < Cin) ? xs[(k0 + k) * ppad + p] : 0.f;
      }
    }
    __syncthreads();

    // Depthwise 3x3 (+ folded BN2, relu6, rounding): lane = channel, so the
    // nine taps and the BN2 pair stay in registers.
    {
      const int c = k0 + lane;
      float tap[9];
      float sc = 0.f, bc = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) tap[t] = c < Ce ? dw[t * Ce + c] : 0.f;
      if (c < Ce) { sc = s2[c]; bc = b2[c]; }
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        const int qy = i, qx = warp;  // output row i of the tile, column warp
        float a = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            a = fmaf(es[((qy * stride + ky) * tin + qx * stride + kx) * kKC + lane],
                     tap[ky * 3 + kx], a);
        ds[lane * kDS + qy * kT + qx] = c < Ce ? round_to<T>(relu6(a * sc + bc)) : 0.f;
      }
    }
    __syncthreads();

    // Project: warp w owns output row w of the tile (8 pixels), lane l the
    // output channels l + 32 j; the 8 pixels' d values are two 16-byte
    // broadcast loads per hidden channel.
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 d0 = *reinterpret_cast<const float4*>(ds + kk * kDS + warp * kT);
      const float4 d1 = *reinterpret_cast<const float4*>(ds + kk * kDS + warp * kT + 4);
      const float dv[kT] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int j = 0; j < COJ; ++j) {
        const int co = lane + 32 * j;
        const float w = co < Cout ? w2s[kk * Cout + co] : 0.f;
#pragma unroll
        for (int r = 0; r < kT; ++r) acc[r][j] = fmaf(dv[r], w, acc[r][j]);
      }
    }
  }

  const int oy = oy0 + warp;
  if (gridDim.z > 1) {
    float* pb = partial + ((size_t)blockIdx.z * gridDim.y + b) * Ho * Wo * Cout;
    if (oy < Ho) {
#pragma unroll
      for (int r = 0; r < kT; ++r) {
        const int ox = ox0 + r;
        if (ox >= Wo) continue;
#pragma unroll
        for (int j = 0; j < COJ; ++j) {
          const int co = lane + 32 * j;
          if (co < Cout) pb[((size_t)oy * Wo + ox) * Cout + co] = acc[r][j];
        }
      }
    }
    return;
  }
  T* ob = out + (size_t)b * Ho * Wo * Cout;
  if (oy < Ho) {
#pragma unroll
    for (int r = 0; r < kT; ++r) {
      const int ox = ox0 + r;
      if (ox >= Wo) continue;
#pragma unroll
      for (int j = 0; j < COJ; ++j) {
        const int co = lane + 32 * j;
        if (co < Cout) {
          T o = from_f<T>(acc[r][j] * s3[co] + b3[co]);
          if (residual) o = from_f<T>(to_f(xb[((size_t)oy * W + ox) * Cin + co]) + to_f(o));
          ob[((size_t)oy * Wo + ox) * Cout + co] = o;
        }
      }
    }
  }
}

// Sum of the hidden-chunk shares, then the epilogue: n = B*Ho*Wo*Cout.
template <typename T>
__global__ void ir_finalize_kernel(const float* __restrict__ partial, const T* __restrict__ x,
                                   const float* __restrict__ s3, const float* __restrict__ b3,
                                   T* __restrict__ out, long long n, int Cout, int nsplit,
                                   int residual) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float y = 0.f;
    for (int z = 0; z < nsplit; ++z) y += partial[z * n + i];
    const int co = (int)(i % Cout);
    T o = from_f<T>(y * s3[co] + b3[co]);
    if (residual) o = from_f<T>(to_f(x[i]) + to_f(o));  // same layout: stride 1, Cin == Cout
    out[i] = o;
  }
}

template <typename T, int COJ>
int launch_coj(const void* x, const float* w1, const float* s1, const float* b1,
               const float* dw, const float* s2, const float* b2, const float* w2,
               const float* s3, const float* b3, void* out, int B, int H, int W,
               int Ho, int Wo, int Cin, int Ce, int Cout, int stride, int has_expand,
               int residual, int ppad, size_t smem, float* partial, int nsplit,
               cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(ir_infer_kernel<T, COJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((Ho + kT - 1) / kT) * ((Wo + kT - 1) / kT), B, nsplit);
  ir_infer_kernel<T, COJ><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), w1, s1, b1, dw, s2, b2, w2, s3, b3,
      static_cast<T*>(out), partial, H, W, Ho, Wo, Cin,
      Ce, Cout, stride, has_expand, residual, ppad);
  if (nsplit > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long n = (long long)B * Ho * Wo * Cout;
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    ir_finalize_kernel<T><<<blocks, 256, 0, s>>>(partial, static_cast<const T*>(x), s3, b3,
                                                  static_cast<T*>(out), n, Cout, nsplit,
                                                  residual);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const float* w1, const float* s1, const float* b1,
           const float* dw, const float* s2, const float* b2, const float* w2,
           const float* s3, const float* b3, void* out, int B, int H, int W,
           int Ho, int Wo, int Cin, int Ce, int Cout, int stride, int has_expand,
           int residual, float* partial, int nsplit, cudaStream_t s) {
  const int tin = stride * (kT - 1) + 3;
  const int pin = tin * tin;
  int ppad = (pin + 3) / 4 * 4;
  while (ppad % 32 != 4) ppad += 4;
  const size_t smem = sizeof(float) * ((size_t)Cin * ppad + (size_t)pin * kKC
                                       + (size_t)Cin * kKC + (size_t)kKC * kDS
                                       + (size_t)kKC * Cout);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
#define IR_LAUNCH(J) launch_coj<T, J>(x, w1, s1, b1, dw, s2, b2, w2, s3, b3, out, B, H, W, \
                                      Ho, Wo, Cin, Ce, Cout, stride, has_expand, residual, \
                                      ppad, smem, partial, nsplit, s)
  if (Cout <= 32) return IR_LAUNCH(1);
  if (Cout <= 64) return IR_LAUNCH(2);
  if (Cout <= 128) return IR_LAUNCH(4);
  return IR_LAUNCH(8);
#undef IR_LAUNCH
}

}  // namespace

// x [B, H, W, Cin] and out [B, Ho, Wo, Cout] NHWC (dtype 0 = f32, 1 = bf16);
// w1 [Cin, Ce] and w2 [Ce, Cout] in f32, holding values of the input dtype
// (w1 unused, may be null, when has_expand is 0, then Ce == Cin);
// s1/b1/s2/b2 [Ce], s3/b3 [Cout] and dw [9, Ce] in f32. stride is 1 or 2;
// Cin, Ce and Cout are multiples of 4 (16-byte staging loads); Cout <= 256.
// nsplit > 1 splits the hidden chunks over that many blocks per tile (for
// grids too small to fill the card) and needs `partial`, an f32 scratch of
// nsplit * B * Ho * Wo * Cout; a second kernel then sums the shares.
extern "C" int ir_fused_infer(const void* x, const void* w1, const void* s1,
                              const void* b1, const void* dw, const void* s2,
                              const void* b2, const void* w2, const void* s3,
                              const void* b3, void* out, void* partial, int B, int H,
                              int W, int Ho, int Wo, int Cin, int Ce, int Cout,
                              int stride, int has_expand, int residual, int nsplit,
                              int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ce <= 0 || Cout <= 0 || Cout > 256 ||
      Cin % 4 || Ce % 4 || Cout % 4 || (stride != 1 && stride != 2) ||
      (!has_expand && Ce != Cin) || nsplit < 1 || (nsplit > 1 && !partial))
    return (int)cudaErrorInvalidValue;
  float* fp = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(w1), static_cast<const float*>(s1),
                      static_cast<const float*>(b1), static_cast<const float*>(dw),
                      static_cast<const float*>(s2), static_cast<const float*>(b2),
                      static_cast<const float*>(w2), static_cast<const float*>(s3),
                      static_cast<const float*>(b3)};
  if (dtype == 0)
    return launch<float>(x, f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], out, B, H,
                         W, Ho, Wo, Cin, Ce, Cout, stride, has_expand, residual, fp, nsplit,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], out,
                                 B, H, W, Ho, Wo, Cin, Ce, Cout, stride, has_expand,
                                 residual, fp, nsplit, s);
  return (int)cudaErrorInvalidValue;
}
