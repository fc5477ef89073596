// Fused InvertedResidual training backward, pass 2: through BN2, the
// depthwise 3x3 and ReLU6 of BN1, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/ir_fused.py::_dw_bwd_kernel
// (launched from _ir_train_backward once per 128-lane hidden chunk, grid
// (B,), dDW and the sums carried in VMEM scratch across the grid):
//
//   dd     = (u2 * dv2 - p2 - q2 * (d - m2) * inv2) rounded    (BN2 backward)
//   e_act  = relu6(round(x . W1) * s1 + b1) rounded     (x at expansion 1)
//   dDW[t] = sum_o e_act_pad[s*o + t] * dd[o]           (tap-gradient sums)
//   de_act = conv_transpose(dd, DW, stride)             (dilated for stride 2)
//   dv1    = relu6'(v1) * de_act, v1 = e * s1 + b1      (de_act at expansion 1)
//   store dv1 rounded; ra = sum dv1, rb = sum dv1 * (e - m1) * inv1  (f32 dv1)
//
// relu6' is 1 strictly inside (0, 6) and 0 at the ties (the TPU kernel's
// mask at :501). At expansion 1 the sums are 0, as there.
//
// Design: one block per (image, 8x8 output tile, 32 hidden channels). The
// block stages x's halo tile ((7s+3)^2 input pixels) and recomputes e and
// e_act there in shared memory, as the forward pass does; it computes dd on
// the 10x10 output halo (rows and columns o0-1 .. o0+8) into shared memory.
// Then, with lane = channel: each warp takes one output column for the tap
// sums (nine accumulators per thread, the 8 warps added in order), and the
// block's 8s x 8s input pixels for de_act, which gathers dd at the taps that
// land on a stride-s grid point. dv1 goes to device memory once; e, e_act
// and dd never do. Per-block partials of dDW, ra and rb are added by
// sum_rows in a fixed order. No float atomics.
//
// Bound on the H100: operations for stages 2-5, 2*B*H*W*Cin*Ce (the expand
// recompute) + 36*B*Ho*Wo*Ce (tap sums and the transposed conv) multiply-adds
// on CUDA cores (f32), against reading x, d and dv2 and writing dv1; bytes
// for the expansion-1 stage.

#include "ir_train_common.cuh"

namespace {

using namespace irt;

constexpr int kDH = kT + 2;  // dd halo side: output rows/cols o0-1 .. o0+8

template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ s1, const float* __restrict__ b1,
              const float* __restrict__ m1, const float* __restrict__ inv1,
              const float* __restrict__ dw, const T* __restrict__ dv2,
              const float* __restrict__ u2, const float* __restrict__ p2,
              const float* __restrict__ q2, const T* __restrict__ d,
              const float* __restrict__ m2, const float* __restrict__ inv2,
              T* __restrict__ dv1, float* __restrict__ part_dw, float* __restrict__ part_a,
              float* __restrict__ part_b, int H, int W, int Ho, int Wo, int Cin, int Ce,
              int stride, int has_expand, int ppad) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tin = stride * (kT - 1) + 3;
  const int pin = tin * tin;
  float* ea = smem;                          // [pin][kKC] e_act, zero outside the image
  float* dds = ea + pin * kKC;               // [kDH*kDH][kKC] dd, zero outside the map
  float* red = dds + kDH * kDH * kKC;        // [8][9][kKC] per-warp partial sums
  float* er = red + 8 * 9 * kKC;             // [pin][kKC] e                 (has_expand)
  float* xs = er + pin * kKC;                // [Cin][ppad]                  (has_expand)
  float* w1s = xs + Cin * ppad;              // [Cin][kKC]                   (has_expand)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (Wo + kT - 1) / kT;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * kT;
  const int ox0 = (blockIdx.x % tiles_x) * kT;
  const int iy0 = oy0 * stride - 1;
  const int ix0 = ox0 * stride - 1;
  const int k0 = blockIdx.z * kKC;
  const int c = k0 + lane;
  const T* xb = x + (size_t)b * H * W * Cin;

  if (has_expand) {
    stage_x_halo<T>(xb, w1, xs, w1s, H, W, Cin, Ce, iy0, ix0, tin, ppad, k0);
    __syncthreads();
    expand_halo<T>(xs, w1s, s1, b1, ea, er, H, W, Cin, Ce, iy0, ix0, tin, ppad, k0);
  } else {
    for (int i = tid; i < pin * kKC; i += kThreads) {  // Ce == Cin
      const int p = i / kKC, k = i - p * kKC;
      const int iy = iy0 + p / tin, ix = ix0 + p % tin;
      ea[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W && k0 + k < Ce)
                  ? to_f(xb[((size_t)iy * W + ix) * Cin + k0 + k]) : 0.f;
    }
  }
  // dd on the output halo: warp w takes halo rows w, w+8.
  {
    float uc = 0.f, pc = 0.f, qc = 0.f, mc = 0.f, ic = 0.f;
    if (c < Ce) { uc = u2[c]; pc = p2[c]; qc = q2[c]; mc = m2[c]; ic = inv2[c]; }
    for (int hy = warp; hy < kDH; hy += 8) {
      const int oy = oy0 - 1 + hy;
      for (int hx = 0; hx < kDH; ++hx) {
        const int ox = ox0 - 1 + hx;
        float v = 0.f;
        if (oy >= 0 && oy < Ho && ox >= 0 && ox < Wo && c < Ce) {
          const size_t idx = (((size_t)b * Ho + oy) * Wo + ox) * Ce + c;
          const float dn = normalize(to_f(d[idx]), mc, ic);
          v = round_to<T>(bn_backward(uc, to_f(dv2[idx]), pc, qc, dn));
        }
        dds[(hy * kDH + hx) * kKC + lane] = v;
      }
    }
  }
  __syncthreads();

  // Tap-gradient sums: warp w takes output column w of the tile.
  {
    float g[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) g[t] = 0.f;
#pragma unroll
    for (int qy = 0; qy < kT; ++qy) {
      const float ddv = dds[((qy + 1) * kDH + warp + 1) * kKC + lane];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          g[ky * 3 + kx] = fmaf(ea[((qy * stride + ky) * tin + warp * stride + kx) * kKC + lane],
                                ddv, g[ky * 3 + kx]);
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) red[(warp * 9 + t) * kKC + lane] = g[t];
  }
  __syncthreads();
  const size_t row = (size_t)b * gridDim.x + blockIdx.x;
  for (int i = tid; i < 9 * kKC; i += kThreads) {
    const int t = i / kKC, l = i % kKC;
    if (k0 + l >= Ce) continue;
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[(w * 9 + t) * kKC + l];
    part_dw[row * 9 * Ce + (size_t)t * Ce + k0 + l] = s;
  }

  // de_act over the block's 8s x 8s input pixels, then the ReLU6 mask of
  // BN1's output and the BN1-backward sums.
  float tap[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) tap[t] = c < Ce ? dw[t * Ce + c] : 0.f;
  float sc = 0.f, bc = 0.f, mc = 0.f, ic = 0.f;
  if (has_expand && c < Ce) { sc = s1[c]; bc = b1[c]; mc = m1[c]; ic = inv1[c]; }
  const int side = kT * stride;
  float sa = 0.f, sb = 0.f;
  for (int pix = warp; pix < side * side; pix += 8) {
    const int ly = pix / side, lx = pix % side;
    const int iy = oy0 * stride + ly, ix = ox0 * stride + lx;
    if (iy >= H || ix >= W || c >= Ce) continue;
    // de_act[i] = sum_{ky,kx} dd_up[i + k - 1] * DW[2-ky, 2-kx] (ir_fused.py:140-151),
    // dd_up nonzero only on the stride grid.
    float a = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int jy = iy + ky - 1;
      if (jy % stride) continue;
      const int hy = jy / stride - (oy0 - 1);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int jx = ix + kx - 1;
        if (jx % stride) continue;
        const int hx = jx / stride - (ox0 - 1);
        a = fmaf(dds[(hy * kDH + hx) * kKC + lane], tap[(2 - ky) * 3 + (2 - kx)], a);
      }
    }
    float v = a;
    if (has_expand) {
      const float e = er[((ly + 1) * tin + lx + 1) * kKC + lane];
      v = a * relu6_mask(scale_shift(e, sc, bc));
      sa += v;
      sb = fmaf(v, normalize(e, mc, ic), sb);
    }
    dv1[(((size_t)b * H + iy) * W + ix) * Ce + c] = from_f<T>(v);
  }
  __syncthreads();  // red's tap sums consumed
  red[warp * kKC + lane] = sa;
  red[(8 + warp) * kKC + lane] = sb;
  __syncthreads();
  if (tid < 2 * kKC && k0 + (tid % kKC) < Ce) {
    const int which = tid / kKC, l = tid % kKC;
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += red[(which * 8 + w) * kKC + l];
    (which ? part_b : part_a)[row * Ce + k0 + l] = t;
  }
}

size_t smem_bytes(int Cin, int stride, int has_expand) {
  const int tin = stride * (kT - 1) + 3;
  const int pin = tin * tin;
  size_t n = (size_t)pin * kKC + (size_t)kDH * kDH * kKC + 8 * 9 * kKC;
  if (has_expand) n += (size_t)pin * kKC + (size_t)Cin * halo_ppad(pin) + (size_t)Cin * kKC;
  return n * sizeof(float);
}

template <typename T>
int launch(const void* x, const float* const* f, const void* dv2, const void* d, void* dv1,
           float* part_dw, float* part_a, float* part_b, float* scratch, float* ddw, float* ra,
           float* rb, int B, int H, int W, int Ho, int Wo, int Cin, int Ce, int stride,
           int has_expand, int rpg, cudaStream_t s) {
  const size_t smem = smem_bytes(Cin, stride, has_expand);
  cudaError_t e = cudaFuncSetAttribute(dw_bwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((Ho + kT - 1) / kT) * ((Wo + kT - 1) / kT);
  const int tin = stride * (kT - 1) + 3;
  dw_bwd_kernel<T><<<dim3(tiles, B, (Ce + kKC - 1) / kKC), kThreads, smem, s>>>(
      static_cast<const T*>(x), f[0], f[1], f[2], f[3], f[4], f[5], static_cast<const T*>(dv2),
      f[6], f[7], f[8], static_cast<const T*>(d), f[9], f[10], static_cast<T*>(dv1), part_dw,
      part_a, part_b, H, W, Ho, Wo, Cin, Ce, stride, has_expand, halo_ppad(tin * tin));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)B * tiles;
  e = sum_rows(part_dw, rows, 9LL * Ce, rpg, scratch, ddw, s);
  if (e != cudaSuccess) return (int)e;
  e = sum_rows(part_a, rows, Ce, rpg, scratch, ra, s);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(part_b, rows, Ce, rpg, scratch, rb, s);
}

}  // namespace

// Shared memory one block needs (the wrapper refuses blocks too wide).
extern "C" int ir_train_dw_bwd_smem(int Cin, int stride, int has_expand) {
  return (int)smem_bytes(Cin, stride, has_expand);
}

// Number of per-block partial rows (B * output tiles).
extern "C" int ir_train_dw_bwd_rows(int B, int Ho, int Wo) {
  return B * ((Ho + kT - 1) / kT) * ((Wo + kT - 1) / kT);
}

// x [B, H, W, Cin], dv2 and d [B, Ho, Wo, Ce], dv1 [B, H, W, Ce] out, NHWC
// (dtype 0 = f32, 1 = bf16, all the same); w1 [Cin, Ce] f32 holding
// input-dtype values and s1/b1/m1/inv1 [Ce] f32 (unused, may be null, when
// has_expand is 0; then Ce == Cin); dw [9, Ce] f32 holding input-dtype
// values; u2/p2/q2/m2/inv2 [Ce] f32; part_dw [B*tiles][9*Ce], part_a/part_b
// [B*tiles][Ce] f32 (tiles = ceil(Ho/8)*ceil(Wo/8)); scratch
// [ceil(B*tiles/rpg)][9*Ce] f32; ddw [9, Ce], ra/rb [Ce] f32 out. H and W
// even at stride 2 (Ho = H/2); Cin % 4 == 0.
extern "C" int ir_train_dw_bwd(const void* x, const void* w1, const void* s1, const void* b1,
                               const void* m1, const void* inv1, const void* dw, const void* dv2,
                               const void* u2, const void* p2, const void* q2, const void* d,
                               const void* m2, const void* inv2, void* dv1, void* part_dw,
                               void* part_a, void* part_b, void* scratch, void* ddw, void* ra,
                               void* rb, int B, int H, int W, int Ho, int Wo, int Cin, int Ce,
                               int stride, int has_expand, int rpg, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ce <= 0 || Cin % 4 || B > 65535 ||
      (stride != 1 && stride != 2) || Ho * stride != H || Wo * stride != W ||
      (!has_expand && Ce != Cin) || smem_bytes(Cin, stride, has_expand) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(w1), static_cast<const float*>(s1),
                      static_cast<const float*>(b1), static_cast<const float*>(m1),
                      static_cast<const float*>(inv1), static_cast<const float*>(dw),
                      static_cast<const float*>(u2), static_cast<const float*>(p2),
                      static_cast<const float*>(q2), static_cast<const float*>(m2),
                      static_cast<const float*>(inv2)};
  float* o[] = {static_cast<float*>(part_dw), static_cast<float*>(part_a),
                static_cast<float*>(part_b), static_cast<float*>(scratch),
                static_cast<float*>(ddw), static_cast<float*>(ra), static_cast<float*>(rb)};
  if (dtype == 0)
    return launch<float>(x, f, dv2, d, dv1, o[0], o[1], o[2], o[3], o[4], o[5], o[6], B, H, W,
                         Ho, Wo, Cin, Ce, stride, has_expand, rpg, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, f, dv2, d, dv1, o[0], o[1], o[2], o[3], o[4], o[5], o[6], B,
                                 H, W, Ho, Wo, Cin, Ce, stride, has_expand, rpg, s);
  return (int)cudaErrorInvalidValue;
}
