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
// e must equal K9's (ir_train_expand_dw.cu) bit for bit, or the backward's
// ReLU6 mask can disagree with the forward's activation: each element of e
// is one fmaf chain over ci = 0..Cin-1 from 0, rounded to the input dtype,
// as expand_halo (ir_train_common.cuh) computes it. Here the chain runs over
// Cin in chunks of 8, carried in registers, in the same order.
//
// Design. A work item is (image, 8x8 output tile, 32 hidden channels),
// ordered image, tile, channel chunk (fastest), so consecutive items of a
// block share the input halo and find it in L2. Persistent blocks, as many
// as the SMs hold (ir_train_dw_bwd_occupancy), each walk a contiguous range
// of items. Per item, with the next item's loads in flight (cp.async):
//   A  the expand: x's halo tile ((7s+3)^2 pixels) and W1's rows arrive in
//      Cin chunks of 8 through a two-slot ring, the next chunk (or the next
//      item's first) loading while this one is multiplied; each thread
//      carries a 4-channel x ceil(pin/32)-pixel register tile of e (8
//      loads per 32 fmaf per chunk row), and e is kept once, in the input
//      dtype; e_act = round(relu6(e * s1 + b1)) is recomputed where it is
//      read (zero outside the image);
//   B  dd on the 10x10 output halo, from d, dv2 and the item's 18 channel
//      vectors, which were staged during the previous item;
//   C  tap sums (warp = output column, lane = channel; each halo row's
//      three e_act values computed once and used for every tap that reads
//      them);
//   D  de_act and dv1 over the 8s x 8s input pixels, dv1 stored once.
// Then the eleven per-channel sums (dDW's nine taps, ra, rb) of the 8 warps
// are added in order and accumulated into the block's own partial row in
// device memory (read at the item's start, written at its end, by the
// same thread: no atomics), and the next item's d, dv2 and vectors start
// loading into the space those sums used. sum_rows adds the blocks' rows
// in a fixed order, so every sum is deterministic. Shared memory per block:
// 98.2 KB f32 / 57.7 KB bf16 at stride 2, 62.0 / 39.6 KB at stride 1
// (ir_train_dw_bwd_smem), against 34.0-174.8 KB in the first version: 2 or
// 3 resident blocks of 8 warps per SM at every stage, against 1 or 2 at
// stages 2-5.
//
// Bound on the H100: operations for stages 2-5, 2*B*H*W*Cin*Ce (the expand
// recompute) + 36*B*Ho*Wo*Ce (tap sums and the transposed conv) multiply-adds
// on CUDA cores (f32), against reading x, d and dv2 and writing dv1; bytes
// for the expansion-1 stage. The halo recompute adds (7s+3)^2/(8s)^2 - 1 of
// the expand work (56% at stride 1, 13% at stride 2).

#include "ir_train_common.cuh"

#include <stdint.h>

namespace {

using namespace irt;

constexpr int kCK = 8;            // input channels per ring chunk
constexpr int kDH = kT + 2;       // dd halo side: output rows/cols o0-1 .. o0+8
constexpr int kNDH = kDH * kDH;
constexpr int kNV = 18;           // channel vectors: 9 taps, s1 b1 m1 inv1, u2 p2 q2 m2 inv2
constexpr int kNS = 11;           // per-channel sums: 9 taps, ra, rb

template <typename T, int S, bool EXP>
struct Layout {
  static constexpr int TIN = S * (kT - 1) + 3;
  static constexpr int PIN = TIN * TIN;
  static constexpr int R = (PIN + 31) / 32;  // expand pixel rows per thread
  static constexpr int ES = (int)sizeof(T);
  static constexpr int RING_X = EXP ? PIN * kCK * ES : 0;  // one slot
  static constexpr int RING_W = EXP ? kCK * kKC * 4 : 0;
  static constexpr int STG_IN = 2 * kNDH * kKC * ES;
  static constexpr int RED = 8 * kNS * kKC * 4;
  static constexpr int STG = STG_IN > RED ? STG_IN : RED;
  static constexpr int O_RX = 0;
  static constexpr int O_RW = O_RX + 2 * RING_X;
  static constexpr int O_E = O_RW + 2 * RING_W;
  static constexpr int O_DD = O_E + PIN * kKC * ES;
  static constexpr int O_STG = O_DD + kNDH * kKC * 4;
  static constexpr int O_VEC = O_STG + STG;
  static constexpr int BYTES = O_VEC + kNV * kKC * 4;
  static_assert(RING_X % 16 == 0 && O_E % 16 == 0 && O_DD % 16 == 0 && O_STG % 16 == 0,
                "16-byte aligned regions");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Eight consecutive elements of one smem row as f32.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
// Four values (already rounded to T) to one smem row.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

struct Params {
  const void* x;
  const float* w1;
  const float* vec[kNV];  // dw rows 0-8 ([9][Ce]), s1, b1, m1, inv1, u2, p2, q2, m2, inv2
  const void* dv2;
  const void* d;
  void* dv1;
  float* part_dw;         // [grid][9 * Ce]
  float* part_a;          // [grid][Ce]
  float* part_b;          // [grid][Ce]
  int H, W, Ho, Wo, Cin, Ce, tiles_x, tiles, nch;
  long long items;
};

template <typename T, int S, bool EXP>
__global__ void __launch_bounds__(kThreads, S == 1 ? 3 : 2)
dw_bwd_kernel(const Params P) {
  using L = Layout<T, S, EXP>;
  constexpr int TIN = L::TIN, PIN = L::PIN, R = L::R;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* ring_x = reinterpret_cast<T*>(smem + L::O_RX);        // [2][PIN][kCK]
  float* ring_w = reinterpret_cast<float*>(smem + L::O_RW);  // [2][kCK][kKC]
  T* ebuf = reinterpret_cast<T*>(smem + L::O_E);             // [PIN][kKC] e (x at e1)
  float* ddb = reinterpret_cast<float*>(smem + L::O_DD);     // [kNDH][kKC] dd
  T* stg_d = reinterpret_cast<T*>(smem + L::O_STG);          // [kNDH][kKC] d
  T* stg_v = stg_d + kNDH * kKC;                             // [kNDH][kKC] dv2
  float* red = reinterpret_cast<float*>(smem + L::O_STG);    // [8][kNS][kKC], after B
  float* vec = reinterpret_cast<float*>(smem + L::O_VEC);    // [kNV][kKC]

  const T* __restrict__ x = static_cast<const T*>(P.x);
  const T* __restrict__ dv2 = static_cast<const T*>(P.dv2);
  const T* __restrict__ dg = static_cast<const T*>(P.d);
  T* __restrict__ dv1 = static_cast<T*>(P.dv1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = P.H, W = P.W, Ho = P.Ho, Wo = P.Wo, Cin = P.Cin, Ce = P.Ce;
  const int nc = EXP ? Cin / kCK : 0;
  const long long first = P.items * blockIdx.x / gridDim.x;
  const long long last = P.items * (blockIdx.x + 1) / gridDim.x;

  struct Item { int b, oy0, ox0, k0; };
  auto decode = [&](long long it) {
    Item r;
    const long long rest = it / P.nch;
    r.k0 = (int)(it - rest * P.nch) * kKC;
    const int tile = (int)(rest % P.tiles);
    r.b = (int)(rest / P.tiles);
    r.oy0 = (tile / P.tiles_x) * kT;
    r.ox0 = (tile % P.tiles_x) * kT;
    return r;
  };
  // x's halo, channels [cc * kCK, +kCK), and W1's rows for them.
  auto issue_x = [&](const Item& it, int cc, int slot) {
    constexpr int CPP = kCK * (int)sizeof(T) / 16;  // 16-byte copies per pixel
    T* dst = ring_x + (size_t)slot * PIN * kCK;
    for (int i = tid; i < PIN * CPP; i += kThreads) {
      const int p = i / CPP, c = i - p * CPP;
      const int iy = it.oy0 * S - 1 + p / TIN, ix = it.ox0 * S - 1 + p % TIN;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
      cp_async16(dst + p * kCK + c * (16 / (int)sizeof(T)),
                 ok ? (const void*)(x + (((size_t)it.b * H + iy) * W + ix) * Cin + cc * kCK +
                                    c * (16 / (int)sizeof(T)))
                    : P.x,
                 ok);
    }
    if (tid < kCK * kKC / 4) {
      const int ci = tid / (kKC / 4), c = tid % (kKC / 4);
      cp_async16(ring_w + (size_t)slot * kCK * kKC + ci * kKC + 4 * c,
                 P.w1 + (size_t)(cc * kCK + ci) * Ce + it.k0 + 4 * c, true);
    }
  };
  // d and dv2 on the output halo, the channel vectors, and (expansion 1) x's
  // halo itself as e.
  auto issue_stage = [&](const Item& it) {
    constexpr int CPP = kKC * (int)sizeof(T) / 16;
    for (int i = tid; i < 2 * kNDH * CPP; i += kThreads) {
      const int which = i / (kNDH * CPP), j = i - which * kNDH * CPP;
      const int hp = j / CPP, c = j - hp * CPP;
      const int oy = it.oy0 - 1 + hp / kDH, ox = it.ox0 - 1 + hp % kDH;
      const bool ok = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
      const T* src = which ? dv2 : dg;
      cp_async16((which ? stg_v : stg_d) + hp * kKC + c * (16 / (int)sizeof(T)),
                 ok ? (const void*)(src + (((size_t)it.b * Ho + oy) * Wo + ox) * Ce + it.k0 +
                                    c * (16 / (int)sizeof(T)))
                    : (const void*)src,
                 ok);
    }
    for (int i = tid; i < kNV * kKC / 4; i += kThreads) {
      const int r = i / (kKC / 4), c = i % (kKC / 4);
      if (P.vec[r]) cp_async16(vec + r * kKC + 4 * c, P.vec[r] + it.k0 + 4 * c, true);
    }
    if (!EXP) {
      for (int i = tid; i < PIN * CPP; i += kThreads) {
        const int p = i / CPP, c = i - p * CPP;
        const int iy = it.oy0 * S - 1 + p / TIN, ix = it.ox0 * S - 1 + p % TIN;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
        cp_async16(ebuf + p * kKC + c * (16 / (int)sizeof(T)),
                   ok ? (const void*)(x + (((size_t)it.b * H + iy) * W + ix) * Cin + it.k0 +
                                      c * (16 / (int)sizeof(T)))
                      : P.x,
                   ok);
      }
    }
  };

  // This block's partial row starts at zero.
  float* row_dw = P.part_dw + (size_t)blockIdx.x * 9 * Ce;
  float* row_a = P.part_a + (size_t)blockIdx.x * Ce;
  float* row_b = P.part_b + (size_t)blockIdx.x * Ce;
  for (int i = tid; i < 11 * Ce; i += kThreads)
    (i < 9 * Ce ? row_dw + i : i < 10 * Ce ? row_a + i - 9 * Ce : row_b + i - 10 * Ce)[0] = 0.f;
  __syncthreads();
  if (first >= last) return;

  {
    const Item it = decode(first);
    if (EXP) issue_x(it, 0, 0);
    cp_commit();
    issue_stage(it);
    cp_commit();
  }
  int q = 0;  // ring chunks consumed so far
  const int kq = tid & 7, pg = tid >> 3;
  for (long long item = first; item < last; ++item) {
    const Item it = decode(item);
    const bool has_next = item + 1 < last;
    // The sums this item adds to: thread i < kNS * kKC owns (tap, channel).
    float* sum_ptr[2];
    float old[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * kThreads;
      const int t = i / kKC, l = i % kKC;
      sum_ptr[u] = i >= kNS * kKC ? nullptr
                   : t < 9        ? row_dw + (size_t)t * Ce + it.k0 + l
                   : t == 9       ? row_a + it.k0 + l
                                  : row_b + it.k0 + l;
      old[u] = sum_ptr[u] ? *sum_ptr[u] : 0.f;
    }

    // A: the expand, e = round(x . W1), one fmaf chain per element.
    if (EXP) {
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int cc = 0; cc < nc; ++cc, ++q) {
        if (cc == 0) cp_wait<1>(); else cp_wait<0>();
        __syncthreads();
        if (cc + 1 < nc) issue_x(it, cc + 1, (q + 1) & 1);
        else if (has_next) issue_x(decode(item + 1), 0, (q + 1) & 1);
        cp_commit();
        const T* xs = ring_x + (size_t)(q & 1) * PIN * kCK;
        const float* ws = ring_w + (size_t)(q & 1) * kCK * kKC;
        float w[kCK][4];
#pragma unroll
        for (int ci = 0; ci < kCK; ++ci) {
          const float4 v = *reinterpret_cast<const float4*>(ws + ci * kKC + 4 * kq);
          w[ci][0] = v.x; w[ci][1] = v.y; w[ci][2] = v.z; w[ci][3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int p = min(pg + 32 * r, PIN - 1);
          float xv[kCK];
          load8(xs + p * kCK, xv);
#pragma unroll
          for (int ci = 0; ci < kCK; ++ci)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv[ci], w[ci][c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = pg + 32 * r;
        if (p < PIN) {
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] = round_to<T>(acc[r][c]);
          store4(ebuf + p * kKC + 4 * kq, v);
        }
      }
      cp_wait<1>();  // this item's stage; the next item's first x chunk may fly
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // B: dd on the output halo.
    {
      const float uc = vec[13 * kKC + lane], pc = vec[14 * kKC + lane],
                  qc = vec[15 * kKC + lane], mc = vec[16 * kKC + lane],
                  ic = vec[17 * kKC + lane];
      for (int hp = warp; hp < kNDH; hp += 8) {
        const int oy = it.oy0 - 1 + hp / kDH, ox = it.ox0 - 1 + hp % kDH;
        float v = 0.f;
        if (oy >= 0 && oy < Ho && ox >= 0 && ox < Wo) {
          const float dn = normalize(to_f(stg_d[hp * kKC + lane]), mc, ic);
          v = round_to<T>(bn_backward(uc, to_f(stg_v[hp * kKC + lane]), pc, qc, dn));
        }
        ddb[hp * kKC + lane] = v;
      }
    }
    __syncthreads();

    float sc = 0.f, bc = 0.f, mc = 0.f, ic = 0.f;
    if (EXP) {
      sc = vec[9 * kKC + lane]; bc = vec[10 * kKC + lane];
      mc = vec[11 * kKC + lane]; ic = vec[12 * kKC + lane];
    }
    const int iy0 = it.oy0 * S - 1, ix0 = it.ox0 * S - 1;
    // C: tap-gradient sums, warp = output column of the tile.
    float g[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) g[t] = 0.f;
#pragma unroll
    for (int r = 0; r < TIN; ++r) {
      float e3[3];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int hx = warp * S + kx;
        const float e = to_f(ebuf[(r * TIN + hx) * kKC + lane]);
        if (EXP) {
          const int iy = iy0 + r, ix = ix0 + hx;
          const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
          e3[kx] = inside ? round_to<T>(relu6(scale_shift(e, sc, bc))) : 0.f;
        } else {
          e3[kx] = e;
        }
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        if (r - ky < 0 || (r - ky) % S) continue;
        const int qy = (r - ky) / S;
        if (qy >= kT) continue;
        const float ddv = ddb[((qy + 1) * kDH + warp + 1) * kKC + lane];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) g[ky * 3 + kx] = fmaf(e3[kx], ddv, g[ky * 3 + kx]);
      }
    }

    // D: de_act over the 8s x 8s input pixels, the ReLU6 mask of BN1's
    // output and the BN1-backward sums.
    float tap[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) tap[t] = vec[t * kKC + lane];
    const int c = it.k0 + lane;
    constexpr int side = kT * S;
    float sa = 0.f, sb = 0.f;
    for (int pix = warp; pix < side * side; pix += 8) {
      const int ly = pix / side, lx = pix % side;
      const int iy = it.oy0 * S + ly, ix = it.ox0 * S + lx;
      if (iy >= H || ix >= W) continue;
      // de_act[i] = sum_{ky,kx} dd_up[i + k - 1] * DW[2-ky, 2-kx] (ir_fused.py:140-151),
      // dd_up nonzero only on the stride grid.
      float a = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int jy = iy + ky - 1;
        if (jy % S) continue;
        const int hy = jy / S - (it.oy0 - 1);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int jx = ix + kx - 1;
          if (jx % S) continue;
          const int hx = jx / S - (it.ox0 - 1);
          a = fmaf(ddb[(hy * kDH + hx) * kKC + lane], tap[(2 - ky) * 3 + (2 - kx)], a);
        }
      }
      float v = a;
      if (EXP) {
        const float e = to_f(ebuf[((ly + 1) * TIN + lx + 1) * kKC + lane]);
        v = a * relu6_mask(scale_shift(e, sc, bc));
        sa += v;
        sb = fmaf(v, normalize(e, mc, ic), sb);
      }
      dv1[(((size_t)it.b * H + iy) * W + ix) * Ce + c] = from_f<T>(v);
    }

    // The 8 warps' sums, added in order, into the block's row. The staging
    // area was last read in B.
#pragma unroll
    for (int t = 0; t < 9; ++t) red[(warp * kNS + t) * kKC + lane] = g[t];
    red[(warp * kNS + 9) * kKC + lane] = sa;
    red[(warp * kNS + 10) * kKC + lane] = sb;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!sum_ptr[u]) continue;
      const int i = tid + u * kThreads;
      float s = 0.f;
#pragma unroll
      for (int w8 = 0; w8 < 8; ++w8) s += red[(w8 * kNS) * kKC + i];
      *sum_ptr[u] = old[u] + s;
    }
    __syncthreads();
    if (has_next) issue_stage(decode(item + 1));
    cp_commit();
  }
  cp_wait<0>();
}

template <typename T, int S, bool EXP>
cudaError_t prepare(int* per_sm) {
  using L = Layout<T, S, EXP>;
  cudaError_t e = cudaFuncSetAttribute(dw_bwd_kernel<T, S, EXP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, dw_bwd_kernel<T, S, EXP>,
                                                       kThreads, L::BYTES);
}

template <typename T>
int smem_of(int stride, int has_expand) {
  if (stride == 1)
    return has_expand ? Layout<T, 1, true>::BYTES : Layout<T, 1, false>::BYTES;
  return has_expand ? Layout<T, 2, true>::BYTES : Layout<T, 2, false>::BYTES;
}

// Blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -error.
int occupancy(int stride, int has_expand, int dtype) {
  int n = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    if (stride == 1) e = has_expand ? prepare<float, 1, true>(&n) : prepare<float, 1, false>(&n);
    else e = has_expand ? prepare<float, 2, true>(&n) : prepare<float, 2, false>(&n);
  } else if (dtype == 1) {
    using BF = __nv_bfloat16;
    if (stride == 1) e = has_expand ? prepare<BF, 1, true>(&n) : prepare<BF, 1, false>(&n);
    else e = has_expand ? prepare<BF, 2, true>(&n) : prepare<BF, 2, false>(&n);
  }
  return e == cudaSuccess ? n : -(int)e;
}

long long n_items(int B, int Ho, int Wo, int Ce) {
  return (long long)B * ((Ho + kT - 1) / kT) * ((Wo + kT - 1) / kT) * (Ce / kKC);
}

// Persistent grid: as many blocks as the SMs hold, at most one per item.
long long grid_size(int B, int Ho, int Wo, int Ce, int stride, int has_expand, int dtype) {
  const int per_sm = occupancy(stride, has_expand, dtype);
  if (per_sm <= 0) return per_sm < 0 ? per_sm : -(long long)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -(long long)cudaErrorInvalidDevice;
  const long long items = n_items(B, Ho, Wo, Ce);
  const long long g = (long long)per_sm * sms;
  return items < g ? items : g;
}

template <typename T, int S, bool EXP>
cudaError_t run(const Params& p, int grid, cudaStream_t s) {
  dw_bwd_kernel<T, S, EXP><<<grid, kThreads, Layout<T, S, EXP>::BYTES, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int grid, int stride, int has_expand, cudaStream_t s) {
  if (stride == 1) return has_expand ? run<T, 1, true>(p, grid, s) : run<T, 1, false>(p, grid, s);
  return has_expand ? run<T, 2, true>(p, grid, s) : run<T, 2, false>(p, grid, s);
}

}  // namespace

// Shared memory one block uses.
extern "C" int ir_train_dw_bwd_smem(int stride, int has_expand, int dtype) {
  if (stride != 1 && stride != 2) return -1;
  return dtype == 0 ? smem_of<float>(stride, has_expand) : smem_of<__nv_bfloat16>(stride, has_expand);
}

// Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -(CUDA error).
extern "C" int ir_train_dw_bwd_occupancy(int stride, int has_expand, int dtype) {
  if (stride != 1 && stride != 2) return -(int)cudaErrorInvalidValue;
  return occupancy(stride, has_expand, dtype);
}

// Number of partial rows: the persistent grid's blocks, one row each; or
// -(CUDA error).
extern "C" int ir_train_dw_bwd_rows(int B, int Ho, int Wo, int Ce, int stride, int has_expand,
                                    int dtype) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || Ce <= 0 || Ce % kKC || (stride != 1 && stride != 2))
    return -(int)cudaErrorInvalidValue;
  return (int)grid_size(B, Ho, Wo, Ce, stride, has_expand, dtype);
}

// x [B, H, W, Cin], dv2 and d [B, Ho, Wo, Ce], dv1 [B, H, W, Ce] out, NHWC
// (dtype 0 = f32, 1 = bf16, all the same, 16-byte aligned); w1 [Cin, Ce]
// f32 holding input-dtype values and s1/b1/m1/inv1 [Ce] f32 (unused, may be
// null, when has_expand is 0; then Ce == Cin); dw [9, Ce] f32 holding
// input-dtype values; u2/p2/q2/m2/inv2 [Ce] f32; part_dw [rows][9*Ce],
// part_a/part_b [rows][Ce] f32 (rows = ir_train_dw_bwd_rows); scratch
// [ceil(rows/rpg)][9*Ce] f32; ddw [9, Ce], ra/rb [Ce] f32 out. H and W even at
// stride 2 (Ho = H/2); Cin % 8 == 0, Ce % 32 == 0.
extern "C" int ir_train_dw_bwd(const void* x, const void* w1, const void* s1, const void* b1,
                               const void* m1, const void* inv1, const void* dw, const void* dv2,
                               const void* u2, const void* p2, const void* q2, const void* d,
                               const void* m2, const void* inv2, void* dv1, void* part_dw,
                               void* part_a, void* part_b, void* scratch, void* ddw, void* ra,
                               void* rb, int B, int H, int W, int Ho, int Wo, int Cin, int Ce,
                               int stride, int has_expand, int rpg, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ce <= 0 || Cin % kCK || Ce % kKC ||
      (stride != 1 && stride != 2) || Ho * stride != H || Wo * stride != W ||
      (!has_expand && Ce != Cin) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long grid = grid_size(B, Ho, Wo, Ce, stride, has_expand, dtype);
  if (grid <= 0) return grid < 0 ? (int)-grid : (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  p.x = x;
  p.w1 = static_cast<const float*>(w1);
  const float* dwf = static_cast<const float*>(dw);
  for (int t = 0; t < 9; ++t) p.vec[t] = dwf + (size_t)t * Ce;
  const void* v[] = {s1, b1, m1, inv1, u2, p2, q2, m2, inv2};
  for (int i = 0; i < 9; ++i) p.vec[9 + i] = (i < 4 && !has_expand) ? nullptr
                                              : static_cast<const float*>(v[i]);
  p.dv2 = dv2;
  p.d = d;
  p.dv1 = dv1;
  p.part_dw = static_cast<float*>(part_dw);
  p.part_a = static_cast<float*>(part_a);
  p.part_b = static_cast<float*>(part_b);
  p.H = H; p.W = W; p.Ho = Ho; p.Wo = Wo; p.Cin = Cin; p.Ce = Ce;
  p.tiles_x = (Wo + kT - 1) / kT;
  p.tiles = p.tiles_x * ((Ho + kT - 1) / kT);
  p.nch = Ce / kKC;
  p.items = n_items(B, Ho, Wo, Ce);
  cudaError_t e = dtype == 0 ? dispatch<float>(p, (int)grid, stride, has_expand, s)
                             : dispatch<__nv_bfloat16>(p, (int)grid, stride, has_expand, s);
  if (e != cudaSuccess) return (int)e;
  float* sc = static_cast<float*>(scratch);
  e = sum_rows(p.part_dw, grid, 9LL * Ce, rpg, sc, static_cast<float*>(ddw), s);
  if (e != cudaSuccess) return (int)e;
  e = sum_rows(p.part_a, grid, Ce, rpg, sc, static_cast<float*>(ra), s);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(p.part_b, grid, Ce, rpg, sc, static_cast<float*>(rb), s);
}
