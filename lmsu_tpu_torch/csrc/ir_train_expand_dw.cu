// Fused InvertedResidual training, pass 2: expand + BN1 + ReLU6 + depthwise
// 3x3, with the batch statistics of the depthwise output, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/ir_fused.py::_expand_dw_kernel
// (launched from _ir_train_forward once per 128-lane hidden chunk, grid (B,),
// sums carried in VMEM scratch across the grid):
//
//   e_act = relu6(round(x . W1) * s1 + b1), rounded  (x itself at expansion 1)
//   d     = dw3x3(e_act, stride), padding 1, taps rounded to the input dtype
//   store d rounded to the input dtype; sum[c], sq[c] over the stored d
//
// Design: one block per (image, 8x8 output tile, 32 hidden channels), so
// one launch covers every channel. As in ir_fused_infer.cu, the input halo
// tile ((7*stride+3)^2 pixels, all Cin channels) is staged transposed in
// shared memory and expanded there (e never touches device memory); then
// lane = channel and warp = output column for the depthwise taps, which
// stay in registers. Each block reduces its 64 outputs per channel (per
// thread, then the 8 warps in order) to one partial; sum_rows adds the
// partials in a fixed order. No float atomics.
//
// Bound on the H100: operations for stages 2-5, 2*B*H*W*Cin*Ce (the expand
// recompute) + 18*B*Ho*Wo*Ce multiply-adds on CUDA cores (f32), against
// reading x and writing d; bytes for the expansion-1 stage. The halo
// recompute adds (7s+3)^2/(8s)^2 - 1 of the expand work (56% at stride 1,
// 13% at stride 2), and x's halo tile is staged once per 32 channels.

#include "ir_train_common.cuh"

namespace {

using namespace irt;

template <typename T>
__global__ void __launch_bounds__(kThreads)
expand_dw_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ s1, const float* __restrict__ b1,
                 const float* __restrict__ dw, T* __restrict__ d, float* __restrict__ part_s,
                 float* __restrict__ part_q, int H, int W, int Ho, int Wo, int Cin, int Ce,
                 int stride, int has_expand, int ppad) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tin = stride * (kT - 1) + 3;
  const int pin = tin * tin;
  float* ea = smem;                                  // [pin][kKC]
  float* red = ea + pin * kKC;                       // [2][8][kKC]
  float* xs = red + 2 * 8 * kKC;                     // [Cin][ppad]  (has_expand)
  float* w1s = xs + Cin * ppad;                      // [Cin][kKC]   (has_expand)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (Wo + kT - 1) / kT;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * kT;
  const int ox0 = (blockIdx.x % tiles_x) * kT;
  const int iy0 = oy0 * stride - 1;
  const int ix0 = ox0 * stride - 1;
  const int k0 = blockIdx.z * kKC;
  const T* xb = x + (size_t)b * H * W * Cin;

  if (has_expand) {
    stage_x_halo<T>(xb, w1, xs, w1s, H, W, Cin, Ce, iy0, ix0, tin, ppad, k0);
    __syncthreads();
    expand_halo<T>(xs, w1s, s1, b1, ea, nullptr, H, W, Cin, Ce, iy0, ix0, tin, ppad, k0);
  } else {
    for (int i = tid; i < pin * kKC; i += kThreads) {  // Ce == Cin
      const int p = i / kKC, k = i - p * kKC;
      const int iy = iy0 + p / tin, ix = ix0 + p % tin;
      ea[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W && k0 + k < Ce)
                  ? to_f(xb[((size_t)iy * W + ix) * Cin + k0 + k]) : 0.f;
    }
  }
  __syncthreads();

  const int c = k0 + lane;
  float tap[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) tap[t] = c < Ce ? dw[t * Ce + c] : 0.f;
  float s = 0.f, q = 0.f;
  const int ox = ox0 + warp;
#pragma unroll
  for (int qy = 0; qy < kT; ++qy) {
    float a = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        a = fmaf(ea[((qy * stride + ky) * tin + warp * stride + kx) * kKC + lane],
                 tap[ky * 3 + kx], a);
    const int oy = oy0 + qy;
    if (oy < Ho && ox < Wo && c < Ce) {
      const T v = from_f<T>(a);
      d[(((size_t)b * Ho + oy) * Wo + ox) * Ce + c] = v;
      const float dv = to_f(v);
      s += dv;
      q = fmaf(dv, dv, q);
    }
  }
  red[warp * kKC + lane] = s;
  red[(8 + warp) * kKC + lane] = q;
  __syncthreads();
  if (tid < 2 * kKC && k0 + (tid % kKC) < Ce) {
    const int which = tid / kKC, l = tid % kKC;
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += red[(which * 8 + w) * kKC + l];
    const size_t row = (size_t)b * gridDim.x + blockIdx.x;
    (which ? part_q : part_s)[row * Ce + k0 + l] = t;
  }
}

size_t smem_bytes(int Cin, int stride, int has_expand) {
  const int tin = stride * (kT - 1) + 3;
  const int pin = tin * tin;
  size_t n = (size_t)pin * kKC + 2 * 8 * kKC;
  if (has_expand) n += (size_t)Cin * halo_ppad(pin) + (size_t)Cin * kKC;
  return n * sizeof(float);
}

template <typename T>
int launch(const void* x, const float* w1, const float* s1, const float* b1, const float* dw,
           void* d, float* part_s, float* part_q, float* scratch, float* sum, float* sq, int B,
           int H, int W, int Ho, int Wo, int Cin, int Ce, int stride, int has_expand, int rpg,
           cudaStream_t s) {
  const size_t smem = smem_bytes(Cin, stride, has_expand);
  cudaError_t e = cudaFuncSetAttribute(expand_dw_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((Ho + kT - 1) / kT) * ((Wo + kT - 1) / kT);
  const dim3 grid(tiles, B, (Ce + kKC - 1) / kKC);
  const int ppad = halo_ppad((stride * (kT - 1) + 3) * (stride * (kT - 1) + 3));
  expand_dw_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), w1, s1, b1, dw, static_cast<T*>(d), part_s, part_q, H, W, Ho,
      Wo, Cin, Ce, stride, has_expand, ppad);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)B * tiles;
  e = sum_rows(part_s, rows, Ce, rpg, scratch, sum, s);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(part_q, rows, Ce, rpg, scratch, sq, s);
}

}  // namespace

// Shared memory one block needs (the wrapper refuses blocks too wide).
extern "C" int ir_train_expand_dw_smem(int Cin, int stride, int has_expand) {
  return (int)smem_bytes(Cin, stride, has_expand);
}

// Number of per-block partial rows (B * output tiles).
extern "C" int ir_train_expand_dw_rows(int B, int Ho, int Wo) {
  return B * ((Ho + kT - 1) / kT) * ((Wo + kT - 1) / kT);
}

// x [B, H, W, Cin] and d [B, Ho, Wo, Ce] NHWC (dtype 0 = f32, 1 = bf16);
// w1 [Cin, Ce] f32 holding input-dtype values (unused, may be null, when
// has_expand is 0; then Ce == Cin); s1/b1 [Ce] f32 (may be null likewise);
// dw [9, Ce] f32 holding input-dtype values; part_s/part_q [B*tiles][Ce]
// f32 (tiles = ceil(Ho/8)*ceil(Wo/8)), scratch [ceil(B*tiles/rpg)][Ce] f32;
// sum/sq [Ce] f32 out. Cin % 4 == 0; stride 1 or 2.
extern "C" int ir_train_expand_dw(const void* x, const void* w1, const void* s1, const void* b1,
                                  const void* dw, void* d, void* part_s, void* part_q,
                                  void* scratch, void* sum, void* sq, int B, int H, int W, int Ho,
                                  int Wo, int Cin, int Ce, int stride, int has_expand, int rpg,
                                  int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ce <= 0 || Cin % 4 || B > 65535 ||
      (stride != 1 && stride != 2) || (!has_expand && Ce != Cin) ||
      smem_bytes(Cin, stride, has_expand) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(w1), static_cast<const float*>(s1),
                      static_cast<const float*>(b1), static_cast<const float*>(dw)};
  float* o[] = {static_cast<float*>(part_s), static_cast<float*>(part_q),
                static_cast<float*>(scratch), static_cast<float*>(sum), static_cast<float*>(sq)};
  if (dtype == 0)
    return launch<float>(x, f[0], f[1], f[2], f[3], d, o[0], o[1], o[2], o[3], o[4], B, H, W, Ho,
                         Wo, Cin, Ce, stride, has_expand, rpg, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, f[0], f[1], f[2], f[3], d, o[0], o[1], o[2], o[3], o[4], B,
                                 H, W, Ho, Wo, Cin, Ce, stride, has_expand, rpg, s);
  return (int)cudaErrorInvalidValue;
}
