// Fused InvertedResidual training backward, pass 1: through the project 1x1
// and ReLU6 of BN2, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/ir_fused.py::_proj_bwd_kernel
// (launched from _ir_train_backward once per 128-lane hidden chunk, grid
// (B,), dW2 and the sums carried in VMEM scratch across the grid):
//
//   d_act = relu6(d * s2 + b2) rounded,  dn = (d - m2) * inv2
//   dW2   = d_act^T . dy                                   [Ce, Cout] f32
//   dv2   = relu6'(d * s2 + b2) * (dy . W2^T)              stored rounded
//   ra[c] = sum_p dv2[p, c],  rb[c] = sum_p dv2[p, c] * dn[p, c]   (f32 dv2)
//
// relu6' is 1 strictly inside (0, 6) and 0 at the ties, as the TPU kernel's
// mask (:449). d, dy [M, Ce] / [M, Cout] (M = B*Ho*Wo) in f32 or bf16, the
// vectors [Ce] f32, W2^T [Cout, Ce] as the pre-split mma fragments of its
// input-dtype values (ops/ir_fused.py::mma_fragments).
//
// Design: one kernel, one pass over the pixels. A block owns a span of
// pixels and a group of cg hidden channels, and walks its span 32 pixels at
// a time. W2^T's fragments for the group stay in shared memory for the
// whole span. Per tile the block
//  - copies dy's tile [32 x Cout] and d's [32 x cg] into a two-stage ring
//    with cp.async (the next tile's copy in flight while this one computes);
//  - forms d_act once per element (scale_shift, relu6, round_to<T>) and, in
//    f32, splits d_act and dy into three bf16 terms each (split3), kept in
//    shared memory; in bf16 d_act is one exact term and dy is read as staged;
//  - computes dd_hat = dy . W2g^T on the tensor cores (mma.sync.m16n8k16
//    through mma_step; A by ldmatrix, K = Cout), and in its epilogue masks
//    with relu6_mask(scale_shift(d, s2, b2)) from the staged d, stores dv2
//    in the input dtype and adds each row into per-lane ra/rb sums;
//  - accumulates dW2g += d_act^T . dy in registers across the whole span (K
//    = pixels, both operands by transposed ldmatrix from the staged tiles).
// Every f32 sum follows mma_step's rule: a fresh accumulator per 16-deep
// k-step, added with __fadd_rn. At the end the block writes one dW2
// partial [cg x Cout] and one ra/rb partial row, which sum_rows adds in a
// fixed order. No float atomics. So d crosses device memory once, dy once
// per channel group, and dv2 once.
//
// A Cout too wide for all of it to sit in shared memory beside a 32-channel
// group (above 320 in f32, 512 in bf16; no stage of the student or the 2x
// teacher) is taken in nk chunks of cw: the block walks (tile, chunk)
// items, the ring also carries each chunk's W2^T fragments, dd_hat sums
// over the chunks of a tile before its epilogue, and dW2's registers, which
// hold one chunk, are added to the block's own partial in device memory
// after each item (ir_train_proj_bwd_chunks gives nk). d and dy still cross
// device memory once (per group); the partial's reads and writes come on
// top, about Ce * Cout / 4 bytes a pixel.
//
// The mask is taken on v2 = d * s2 + b2 computed elementwise (scale_shift,
// each operation rounded as the plain version rounds it); no product
// decides a mask, so K11 and its plain version take the same mask
// decisions on the same inputs.
//
// A block is 16 warps, one block an SM, registers capped at 128. dd_hat: a
// warp takes one 16-pixel m-tile and every eighth n-tile of the group; dW2:
// a warp takes one 16-channel m-tile by up to 8 n-tiles of Cout (of a
// chunk). The group is as wide as shared memory allows for W2^T's terms,
// the ring and the terms (plan below: at most 256 channels, covered by
// dW2's warp grid), then evened out over Ce: at the student's stages 1-5,
// cg is 32 / 192 / 192 / 128 / 128 (1 / 1 / 2 / 3 / 6 groups) in both
// types, 48-215 KB a block in f32 and 23-76 KB in bf16. The spans follow
// from the shape only (about kTargetBlocks blocks a launch), so the sums'
// order does too.
//
// The phases of a tile run one after another (clock64 marks per phase in
// a debug build showed the copies landing before they are waited for, and
// most of a tile's time in dd_hat with its epilogue, then dW2, then issuing
// the next copies and the conversion to terms). Versions that were slower:
// 8 warps (bf16 at two blocks an SM spilled dW2's accumulators around every
// product), a deeper ring (up to six tiles in flight), dd_hat's n-tile
// chains interleaved with ra/rb kept in shared memory per tile.
//
// Bound on the H100: f32 issues six bf16 products per f32-level product,
// 6 * 2 * 2*M*Ce*Cout at 989 TFLOP/s, against reading d and dy and writing
// dv2 (chip_smoke.py counts both); bytes bound every stage in bf16 and most
// in f32.

#include <algorithm>

#include "ir_train_common.cuh"

namespace {

using namespace irt;

constexpr int kP = 32;   // pixels a tile: two m-tiles of dd_hat, two k-steps of dW2
constexpr int kNV = 4;   // s2, b2, m2, inv2
// Blocks a launch aims at: four per SM of an H100's 132 at one block an SM.
constexpr int kTargetBlocks = 528;

// A block is 16 warps, one an SM, registers capped at 128 (with 8 warps
// and the accumulators of twice the tiles, bf16 at two blocks an SM spilled
// dW2's accumulators around every product). dd_hat: a warp takes one
// m-tile of a tile; dW2: one m-tile of the group by up to 8 n-tiles.
constexpr int kWarps = 16;
constexpr int kBlock = 32 * kWarps;

__host__ __device__ inline int pad16(int c) { return (c + 15) / 16 * 16; }

// dW2's warp grid: wgn warps along Cout by 16 / wgn along the group, each
// warp one 16-channel m-tile of the group by nj (even, <= 8) 8-channel
// n-tiles of Cout; the fewest n-tiles a warp, then the fewest warps along
// Cout. False when no grid covers mtn x ntn.
struct Grid {
  int wgn, nj;
};
bool warp_grid(int mtn, int ntn, Grid* g) {
  for (int wgn = 1; wgn <= kWarps; wgn *= 2) {
    const int nj = ((ntn + wgn - 1) / wgn + 1) / 2 * 2;
    if (nj <= 8 && mtn <= kWarps / wgn) {
      *g = {wgn, nj};
      return true;
    }
  }
  return false;
}

// Shared memory (es: 4 f32, 2 bf16) for a group of cg channels and Cout in
// nk chunks of cw: W2^T's fragments of the group and a chunk, [cg/8][cw/16]
// [terms][32] uint2 (two slots when nk > 1, the next chunk's in flight;
// one, resident for the whole span, when nk == 1), the vectors [4][cg] f32,
// the ring of d's tiles [2][32][row_ld(cg)] and of dy's [2][32][row_ld(cw)]
// of T, then the bf16 terms: f32 d_act's [3][32][row_ld(cg, 2)] and dy's
// [3][32][row_ld(cw, 2)]; bf16 d_act [32][row_ld(cg, 2)].
size_t smem_of(int cg, int cw, int nk, int es) {
  const int nt = es == 4 ? kTerms : 1;
  const size_t w = (nk > 1 ? 2 : 1) * (size_t)cg * cw * nt * 2;
  const size_t vec = (size_t)kNV * cg * 4;
  const size_t ring = 2 * (size_t)kP * (row_ld(cg, es) + row_ld(cw, es)) * es;
  const size_t terms = es == 4 ? (size_t)nt * kP * (row_ld(cg, 2) + row_ld(cw, 2)) * 2
                               : (size_t)kP * row_ld(cg, 2) * 2;
  return w + vec + ring + terms;
}

bool fits(int cg, int cw, int nk, int es) {
  Grid g;
  return warp_grid(cg / 16, cw / 8, &g) && smem_of(cg, cw, nk, es) <= (size_t)kSmemBlock;
}

// The channel group cg (a multiple of 32, at most 256) and Cout's chunks
// (nk of cw, a multiple of 16). First all of Cout in one chunk, W2^T's
// fragments resident: the widest group that dW2's warp grid covers and
// that fits the shared memory budget. When not even 32 channels take all
// of Cout, Cout in chunks: the group and chunk with the most of dW2 in
// registers (cg * cw), the wider group on a tie. Then both evened out. Any
// Ce and Cout have a plan (cg 32 by cw 16 always fits).
void plan(int Ce, int Cout, int es, int* cg, int* cw, int* nk, Grid* grid) {
  const int ce32 = (Ce + 31) / 32 * 32, co = pad16(Cout);
  int c = std::min(256, ce32), w = co;
  while (c >= 32 && !fits(c, co, 1, es)) c -= 32;
  if (c < 32) {
    c = 32;
    w = 16;
    for (int c1 = std::min(256, ce32); c1 >= 32; c1 -= 32)
      for (int w1 = std::min(512, co - 16); w1 >= 16; w1 -= 16)
        if (fits(c1, w1, 2, es)) {
          if (c1 * w1 > c * w) c = c1, w = w1;
          break;
        }
  }
  const int groups = (ce32 + c - 1) / c;
  *cg = ((ce32 + groups - 1) / groups + 31) / 32 * 32;
  *nk = (co + w - 1) / w;
  *cw = pad16((co + *nk - 1) / *nk);
  warp_grid(*cg / 16, *cw / 8, grid);
}

// Pixels a span (a multiple of 32) and the number of spans.
long long spans_of(long long M, int groups, long long* span) {
  const long long want = std::max(1, kTargetBlocks / groups);
  *span = ((M + want - 1) / want + kP - 1) / kP * kP;
  return (M + *span - 1) / *span;
}

struct Params {
  const void* d;
  const void* dy;
  const float* vec[kNV];
  const uint2* w2tf;   // W2^T [Cout, Ce] as B fragments (k = Cout, n = Ce)
  void* dv2;
  float* part_a;       // [spans][Ce]
  float* part_b;
  float* part_w;       // [spans][Ce * Cout]
  long long M, span;
  int Ce, Cout, cg, cw, nk, ks_w2t, np8, vec16;
  Grid grid;
};

__device__ __forceinline__ int sw(int r, int c) { return x_chunk<__nv_bfloat16>(r, c); }

// Elements [c, c + 4) of staged row r (rows of ld elements, 16-byte chunks
// swizzled by x_chunk<T>), as f32; c % 4 == 0.
__device__ __forceinline__ float4 staged4(const float* m, int r, int c, int ld) {
  return *reinterpret_cast<const float4*>(m + r * ld + x_chunk<float>(r, c >> 2) * 4);
}
__device__ __forceinline__ float4 staged4(const __nv_bfloat16* m, int r, int c, int ld) {
  const uint2 u = *reinterpret_cast<const uint2*>(m + r * ld + sw(r, c >> 3) * 8 + (c & 7));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// Elements c, c + 1 of staged row r, as f32; c even.
__device__ __forceinline__ float2 staged2(const float* m, int r, int c, int ld) {
  return *reinterpret_cast<const float2*>(m + r * ld + x_chunk<float>(r, c >> 2) * 4 + (c & 3));
}
__device__ __forceinline__ float2 staged2(const __nv_bfloat16* m, int r, int c, int ld) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(m + r * ld + sw(r, c >> 3) * 8 + (c & 7)));
}

// Four values (c % 4 == 0) as their bf16 terms, to row r of each term plane
// (planes `plane` elements apart, rows of ld, x_chunk<bf16> swizzle).
template <int NT>
__device__ __forceinline__ void store_terms(__nv_bfloat16* t, size_t plane, int r, int c, int ld,
                                            float4 v) {
  __nv_bfloat16* p = t + (size_t)r * ld + sw(r, c >> 3) * 8 + (c & 7);
  if (NT == 1) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf2_bits(__floats2bfloat162_rn(v.x, v.y)),
                                              bf2_bits(__floats2bfloat162_rn(v.z, v.w)));
  } else {
    uint32_t lo[kTerms], hi[kTerms];
    split3(v.x, v.y, lo);
    split3(v.z, v.w, hi);
#pragma unroll
    for (int q = 0; q < kTerms; ++q)
      *reinterpret_cast<uint2*>(p + q * plane) = make_uint2(lo[q], hi[q]);
  }
}

// A lane's dW2 registers (rows c + {0, 8}, columns co + 8 j + {0, 1} for
// its nj n-tiles j) to the block's partial pw: written, or with `add`
// added to what the lane wrote there before.
__device__ __forceinline__ void store_w(float* pw, const float (&accw)[8][4], int c, int Ce,
                                        int Cout, int co, int nj, bool add) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = c + 8 * h, col = co + 8 * j + e;
        if (j < nj && r < Ce && col < Cout) {
          float* q = pw + (size_t)r * Cout + col;
          *q = add ? __fadd_rn(*q, accw[j][2 * h + e]) : accw[j][2 * h + e];
        }
      }
}

// CHUNKED: Cout in nk > 1 chunks (else one, W2^T's fragments resident).
// A block walks items (tile, chunk); d's tile lands with the tile's first
// chunk and stays for its last, whose epilogue masks dd_hat. With chunks,
// dW2's registers hold one chunk: after each item the block adds them to
// its own dW2 partial in device memory (each element read and written by
// one thread only, so in a fixed order and with no atomics).
template <typename T, bool CHUNKED>
__global__ void __launch_bounds__(kBlock, 1)
proj_bwd_kernel(const Params P) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NT = Mma<T>::terms;
  constexpr int E = 16 / (int)sizeof(T);
  extern __shared__ float4 smem4[];
  const int Ce = P.Ce, Cout = P.Cout, cg = P.cg, cw = P.cw;
  const int nk = CHUNKED ? P.nk : 1;
  const int kw = cw / 16;  // k-steps of dd_hat a chunk
  const int ldd = row_ld(cg, sizeof(T)), ldy = row_ld(cw, sizeof(T));
  const int ldtd = row_ld(cg, 2), ldty = row_ld(cw, 2);
  const size_t wslot = (size_t)cg / 8 * kw * NT * 32;  // uint2 of a chunk's fragments
  // Layout (smem_of).
  uint2* w2s = reinterpret_cast<uint2*>(smem4);                     // [1|2][cg/8][kw][NT][32]
  float* vec = reinterpret_cast<float*>(w2s + (CHUNKED ? 2 : 1) * wslot);  // [4][cg]
  T* dring = reinterpret_cast<T*>(vec + kNV * cg);                   // [2][32][ldd]
  T* yring = dring + 2 * kP * ldd;                                   // [2][32][ldy]
  __nv_bfloat16* dts = reinterpret_cast<__nv_bfloat16*>(yring + 2 * kP * ldy);
  __nv_bfloat16* yts = dts + (size_t)NT * kP * ldtd;                 // f32: [3][32][ldty]
  const float* s2v = vec;
  const float* b2v = vec + cg;
  const float* m2v = vec + 2 * cg;
  const float* i2v = vec + 3 * cg;

  const T* __restrict__ d = static_cast<const T*>(P.d);
  const T* __restrict__ dy = static_cast<const T*>(P.dy);
  T* __restrict__ dv2 = static_cast<T*>(P.dv2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, li = lane >> 3;
  const int c0g = blockIdx.y * cg;
  const int cgn = min(cg, Ce - c0g);
  const long long r_begin = (long long)blockIdx.x * P.span;
  const long long r_end = min(r_begin + P.span, P.M);
  const int ntile = (int)((r_end - r_begin + kP - 1) / kP);
  const int nitem = ntile * nk;
  const int nta = cg / 8;  // n-tiles of dd_hat: warp w takes w % 8 + 8 j
  const int ma = warp / 8, wa = warp % 8;  // ... of m-tile ma
  // dW2's warp tile: group m-tile mt by chunk n-tiles nt0 .. nt0 + nj.
  const int mtn = cg / 16, ntn = cw / 8;
  const int mt = warp / P.grid.wgn, nt0 = (warp % P.grid.wgn) * P.grid.nj;
  const int nj_n = mt < mtn ? min(P.grid.nj, ntn - nt0) : 0;
  const int c_dw = c0g + 16 * mt + g, co_dw = 8 * nt0 + 2 * t;  // this lane's dW2 elements
  float* pw = P.part_w + (long long)blockIdx.x * Ce * Cout;

  for (int i = tid; i < kNV * cg; i += kBlock) {
    const int v = i / cg, c = i - v * cg;
    vec[i] = c < cgn ? P.vec[v][c0g + c] : 0.f;
  }
  // W2^T's fragments of the group for chunk k (n-tiles c0g/8.., k-steps
  // k kw ..), zero past Ce and Cout, into `ws`.
  auto load_w = [&](int k, uint2* ws) {
    const int per = kw * NT * 16;  // 16-byte pieces of one n-tile
    for (int i = tid; i < nta * per; i += kBlock) {
      const int j = i / per, p = i - j * per;
      const int nt = c0g / 8 + j, ks = k * kw + p / (NT * 16);
      const bool ok = nt < P.np8 && ks < P.ks_w2t;
      cp_async16(ws + (size_t)j * kw * NT * 32 + 2 * p,
                 ok ? (const void*)(P.w2tf + ((size_t)nt * P.ks_w2t + k * kw) * NT * 32 + 2 * p)
                    : (const void*)P.w2tf,
                 ok);
    }
  };
  if (!CHUNKED) load_w(0, w2s);
  // The row of flat index i over rows of n elements, inv = 1 / n: i / n
  // by a float reciprocal, exact here (i < 2^13, n < 2^8: (i + 0.5) / n is
  // at least 1 / (2 n) from an integer).
  auto row_of = [](int i, float inv) { return (int)((i + 0.5f) * inv); };
  // Item it = (tile, chunk k): d's tile (the group's channels; with the
  // tile's first chunk) into slot tile & 1 of d's ring, dy's tile of the
  // chunk into slot it & 1 of dy's ring (and, with chunks, the chunk's
  // fragments into slot it & 1), zero past the span, Ce and Cout.
  auto issue = [&](int it) {
    const int tile = CHUNKED ? it / nk : it, k = it - tile * nk;
    const long long r0 = r_begin + (long long)tile * kP;
    const int co0 = k * cw;
    T* rd = dring + (size_t)(tile & 1) * kP * ldd;
    T* ry = yring + (size_t)(it & 1) * kP * ldy;
    const int qd = k == 0 ? cg / E : 0, qn = qd + cw / E;  // 16-byte pieces of a row
    const float inv_qn = 1.f / qn;
    for (int i = tid; i < kP * qn; i += kBlock) {
      const int r = row_of(i, inv_qn), q = i - r * qn;
      const long long row = r0 + r;
      const bool isd = q < qd;
      const int qq = isd ? q : q - qd;
      const int c = isd ? c0g + qq * E : co0 + qq * E, lim = isd ? Ce : Cout;
      const T* src = isd ? d + row * Ce + c : dy + row * Cout + c;
      T* dst = (isd ? rd + r * ldd : ry + r * ldy) + x_chunk<T>(r, qq) * E;
      const bool ok = row < r_end && c < lim;
      if (P.vec16) {
        cp_async16(dst, ok ? (const void*)src : P.d, ok);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          dst[e] = row < r_end && c + e < lim ? src[e] : from_f<T>(0.f);
      }
    }
    if (CHUNKED) load_w(k, w2s + (size_t)(it & 1) * wslot);
  };

  float accw[8][4];  // dW2: [chunk n-tile][fragment]
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) accw[j][r] = 0.f;
  float ra[4][2], rb[4][2];  // this lane's sums of channels 8 (wa + 8 j) + 2t (+1)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) ra[j][e] = rb[j][e] = 0.f;
  float acc[4][4];  // dd_hat of a tile: [n-tile j][fragment], across its chunks

  issue(0);
  cp_commit();
  for (int it = 0; it < nitem; ++it) {
    const int tile = CHUNKED ? it / nk : it, k = it - tile * nk;
    const long long r0 = r_begin + (long long)tile * kP;
    __syncthreads();  // the previous item's readers of the slots it + 1 takes and of the terms are done
    if (it + 1 < nitem) issue(it + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // this item landed (and, at item 0, the fragments and vectors)
    const T* rd = dring + (size_t)(tile & 1) * kP * ldd;
    const T* ry = yring + (size_t)(it & 1) * kP * ldy;
    const uint2* ws = w2s + (CHUNKED ? (size_t)(it & 1) * wslot : 0);

    // d_act (at the tile's first chunk) and in f32 dy as bf16 terms, four
    // elements a thread.
    {
      if (k == 0) {
        const int n4 = cg / 4;
        const float inv4 = 1.f / n4;
        for (int i = tid; i < kP * n4; i += kBlock) {
          const int r = row_of(i, inv4), c = 4 * (i - r * n4);
          const float4 v = staged4(rd, r, c, ldd);
          const float4 a = make_float4(round_to<T>(relu6(scale_shift(v.x, s2v[c], b2v[c]))),
                                       round_to<T>(relu6(scale_shift(v.y, s2v[c + 1], b2v[c + 1]))),
                                       round_to<T>(relu6(scale_shift(v.z, s2v[c + 2], b2v[c + 2]))),
                                       round_to<T>(relu6(scale_shift(v.w, s2v[c + 3], b2v[c + 3]))));
          store_terms<NT>(dts, (size_t)kP * ldtd, r, c, ldtd, a);
        }
      }
      if (F32) {
        const int m4 = cw / 4;
        const float invm = 1.f / m4;
        for (int i = tid; i < kP * m4; i += kBlock) {
          const int r = row_of(i, invm), c = 4 * (i - r * m4);
          store_terms<NT>(yts, (size_t)kP * ldty, r, c, ldty, staged4(ry, r, c, ldy));
        }
      }
    }
    __syncthreads();
    // dy as the tensor cores read it: f32 its terms, bf16 the staged tile.
    const __nv_bfloat16* ya = F32 ? yts : reinterpret_cast<const __nv_bfloat16*>(ry);
    const int lda = F32 ? ldty : ldy;
    const size_t plane_y = (size_t)kP * ldty;

    // 1. dd_hat += dy_k . W2g_k^T: warp w, m-tile w / 8, n-tiles w % 8 + 8 j.
    if (k == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
    }
    for (int ks = 0; ks < kw; ++ks) {
      uint32_t a[NT][4];
      const int r = 16 * ma + lr + 8 * (li & 1);
#pragma unroll
      for (int q = 0; q < NT; ++q)
        ldsm_x4(a[q], ya + q * plane_y + (size_t)r * lda + sw(r, 2 * ks + (li >> 1)) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = wa + 8 * j;
        if (nt >= nta) break;
        uint32_t b[NT][2];
        smem_b<T>(b, ws + ((size_t)nt * kw + ks) * NT * 32, lane);
        mma_step<NT, NT>(acc[j], a, b);
      }
    }
    // Epilogue, at the tile's last chunk: mask, store dv2, add to ra / rb.
    if (k == nk - 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = wa + 8 * j;
        if (nt >= nta) break;
        const int cl = 8 * nt + 2 * t;  // this lane's channel pair in the group
        const int c = c0g + cl;
        const float2 sv = *reinterpret_cast<const float2*>(s2v + cl);
        const float2 bv = *reinterpret_cast<const float2*>(b2v + cl);
        const float2 mv = *reinterpret_cast<const float2*>(m2v + cl);
        const float2 iv = *reinterpret_cast<const float2*>(i2v + cl);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = 16 * ma + g + 8 * h;
          const long long row = r0 + rl;
          if (row >= r_end) continue;
          const float2 dd = staged2(rd, rl, cl, ldd);
          const float v0 = acc[j][2 * h] * relu6_mask(scale_shift(dd.x, sv.x, bv.x));
          const float v1 = acc[j][2 * h + 1] * relu6_mask(scale_shift(dd.y, sv.y, bv.y));
          T* o = dv2 + row * Ce + c;
          if (c + 1 < Ce && (Ce & 1) == 0) {
            store_pair(o, v0, v1);
          } else {
            if (c < Ce) o[0] = from_f<T>(v0);
            if (c + 1 < Ce) o[1] = from_f<T>(v1);
          }
          ra[j][0] += v0;
          ra[j][1] += v1;
          rb[j][0] = fmaf(v0, normalize(dd.x, mv.x, iv.x), rb[j][0]);
          rb[j][1] = fmaf(v1, normalize(dd.y, mv.y, iv.y), rb[j][1]);
        }
      }
    }

    // 2. dW2g_k += d_act^T . dy_k over the tile's 32 pixels (two k-steps).
    if (nj_n > 0) {
      const size_t plane_d = (size_t)kP * ldtd;
#pragma unroll
      for (int ks = 0; ks < kP / 16; ++ks) {
        uint32_t a[NT][4];
        const int px = 16 * ks + lr + 8 * (li >> 1);
#pragma unroll
        for (int q = 0; q < NT; ++q)
          ldsm_x4_t(a[q], dts + q * plane_d + (size_t)px * ldtd + sw(px, 2 * mt + (li & 1)) * 8);
        const int pb = 16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (2 * jp >= nj_n) break;
          const int nt = nt0 + 2 * jp;  // n-tiles nt, nt + 1 (ntn and nj are even)
          uint32_t b4[NT][4];
#pragma unroll
          for (int q = 0; q < NT; ++q)
            ldsm_x4_t(b4[q], ya + q * plane_y + (size_t)pb * lda + sw(pb, nt + (lane >> 4)) * 8);
          uint32_t b0[NT][2], b1[NT][2];
#pragma unroll
          for (int q = 0; q < NT; ++q) {
            b0[q][0] = b4[q][0];
            b0[q][1] = b4[q][1];
            b1[q][0] = b4[q][2];
            b1[q][1] = b4[q][3];
          }
          mma_step<NT, NT>(accw[2 * jp], a, b0);
          mma_step<NT, NT>(accw[2 * jp + 1], a, b1);
        }
      }
    }
    if (CHUNKED) {
      store_w(pw, accw, c_dw, Ce, Cout, k * cw + co_dw, nj_n, tile > 0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) accw[j][r] = 0.f;
    }
  }

  // ra / rb: the 8 lanes of a channel pair (g = 0..7) added in a fixed
  // order, then the two warps of a channel (m-tiles 0 and 1) in that order
  // through shared memory; one partial row per block.
  const long long span_row = blockIdx.x;
  float* red = vec + kNV * cg;  // [2][4 j][8 wa][8 (t, e)]: d's ring, now free
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nt = wa + 8 * j;
    if (nt >= nta) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        ra[j][e] += __shfl_xor_sync(0xffffffffu, ra[j][e], o);
        rb[j][e] += __shfl_xor_sync(0xffffffffu, rb[j][e], o);
      }
      if (ma == 1 && g == 0) {
        red[((0 * 4 + j) * 8 + wa) * 8 + 2 * t + e] = ra[j][e];
        red[((1 * 4 + j) * 8 + wa) * 8 + 2 * t + e] = rb[j][e];
      }
    }
  }
  __syncthreads();
  if (ma == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nt = wa + 8 * j;
      if (nt >= nta) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0g + 8 * nt + 2 * t + e;
        if (g == 0 && c < Ce) {
          P.part_a[span_row * Ce + c] = ra[j][e] + red[((0 * 4 + j) * 8 + wa) * 8 + 2 * t + e];
          P.part_b[span_row * Ce + c] = rb[j][e] + red[((1 * 4 + j) * 8 + wa) * 8 + 2 * t + e];
        }
      }
    }
  }
  if (!CHUNKED) store_w(pw, accw, c_dw, Ce, Cout, co_dw, nj_n, false);
}

// The kernel for these sizes, with its plan and shared memory set.
template <typename T>
cudaError_t prepare(Params* p, const void** fn, size_t* smem) {
  plan(p->Ce, p->Cout, sizeof(T), &p->cg, &p->cw, &p->nk, &p->grid);
  *smem = smem_of(p->cg, p->cw, p->nk, sizeof(T));
  *fn = p->nk > 1 ? (const void*)proj_bwd_kernel<T, true> : (const void*)proj_bwd_kernel<T, false>;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <typename T>
int launch(Params p, float* scratch, float* dw2, float* ra, float* rb, int rpg, cudaStream_t s) {
  size_t smem = 0;
  const void* fn = nullptr;
  cudaError_t e = prepare<T>(&p, &fn, &smem);
  if (e != cudaSuccess) return (int)e;
  const int groups = (p.Ce + p.cg - 1) / p.cg;
  const long long spans = spans_of(p.M, groups, &p.span);
  if (spans > 0x7fffffffLL || groups > 65535) return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  e = cudaLaunchKernel(fn, dim3((unsigned)spans, groups), dim3(kBlock), args, smem, s);
  if (e != cudaSuccess) return (int)e;
  e = sum_rows(p.part_a, spans, p.Ce, rpg, scratch, ra, s);
  if (e != cudaSuccess) return (int)e;
  e = sum_rows(p.part_b, spans, p.Ce, rpg, scratch, rb, s);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(p.part_w, spans, (long long)p.Ce * p.Cout, rpg, scratch, dw2, s);
}

bool bad_shape(int Ce, int Cout, int dtype) {
  return Ce <= 0 || Cout <= 0 || (dtype != 0 && dtype != 1);
}

Params sized(int Ce, int Cout) {
  Params p{};
  p.Ce = Ce;
  p.Cout = Cout;
  return p;
}

}  // namespace

// The number of spans (the rows of the ra/rb and dW2 partials) for these
// sizes; -1 for a bad shape.
extern "C" int ir_train_proj_bwd_rows(long long M, int Ce, int Cout, int dtype) {
  if (M <= 0 || bad_shape(Ce, Cout, dtype)) return -1;
  Params p = sized(Ce, Cout);
  plan(Ce, Cout, dtype == 0 ? 4 : 2, &p.cg, &p.cw, &p.nk, &p.grid);
  long long span = 0;
  const long long spans = spans_of(M, (Ce + p.cg - 1) / p.cg, &span);
  return spans > 0x7fffffffLL ? -1 : (int)spans;
}
// The channel groups, Cout's chunks, the shared memory a block uses, and
// resident blocks per SM, for this Ce, Cout and dtype; negative for a bad
// shape (or on a CUDA error).
extern "C" int ir_train_proj_bwd_groups(int Ce, int Cout, int dtype) {
  if (bad_shape(Ce, Cout, dtype)) return -1;
  Params p = sized(Ce, Cout);
  plan(Ce, Cout, dtype == 0 ? 4 : 2, &p.cg, &p.cw, &p.nk, &p.grid);
  return (Ce + p.cg - 1) / p.cg;
}
extern "C" int ir_train_proj_bwd_chunks(int Ce, int Cout, int dtype) {
  if (bad_shape(Ce, Cout, dtype)) return -1;
  Params p = sized(Ce, Cout);
  plan(Ce, Cout, dtype == 0 ? 4 : 2, &p.cg, &p.cw, &p.nk, &p.grid);
  return p.nk;
}
extern "C" int ir_train_proj_bwd_smem(int Ce, int Cout, int dtype) {
  if (bad_shape(Ce, Cout, dtype)) return -1;
  Params p = sized(Ce, Cout);
  const int es = dtype == 0 ? 4 : 2;
  plan(Ce, Cout, es, &p.cg, &p.cw, &p.nk, &p.grid);
  return (int)smem_of(p.cg, p.cw, p.nk, es);
}
extern "C" int ir_train_proj_bwd_occupancy(int Ce, int Cout, int dtype) {
  if (bad_shape(Ce, Cout, dtype)) return -1;
  Params p = sized(Ce, Cout);
  const void* fn = nullptr;
  size_t smem = 0;
  cudaError_t e = dtype == 0 ? prepare<float>(&p, &fn, &smem)
                             : prepare<__nv_bfloat16>(&p, &fn, &smem);
  int per_sm = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kBlock, smem);
  return e == cudaSuccess ? per_sm : -(int)e;
}

// d [M, Ce], dy [M, Cout], dv2 [M, Ce] out (dtype 0 = f32, 1 = bf16, all
// three the same); s2/b2/m2/inv2 [Ce] f32; w2tf the mma fragments of W2^T
// [Cout, Ce] (ks_w2t k-steps, np8 n-tiles: ops/ir_fused.py::mma_fragments);
// part_a/part_b [rows][Ce] and part_w [rows][Ce*Cout] f32 (rows =
// ir_train_proj_bwd_rows); scratch f32 of at least ceil(rows/rpg) rows of
// each reduction's width (may be null when rows <= rpg); dw2 [Ce, Cout],
// ra/rb [Ce] f32 out.
extern "C" int ir_train_proj_bwd(const void* d, const void* dy, const void* s2, const void* b2,
                                 const void* m2, const void* inv2, const void* w2tf, void* dv2,
                                 void* part_a, void* part_b, void* part_w, void* scratch,
                                 void* dw2, void* ra, void* rb, long long M, int Ce, int Cout,
                                 int ks_w2t, int np8, int rpg, int dtype, void* stream) {
  if (M <= 0 || bad_shape(Ce, Cout, dtype) || ks_w2t * 16 < pad16(Cout) || np8 * 8 < Ce)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.d = d;
  p.dy = dy;
  const void* v[] = {s2, b2, m2, inv2};
  for (int i = 0; i < kNV; ++i) p.vec[i] = static_cast<const float*>(v[i]);
  p.w2tf = static_cast<const uint2*>(w2tf);
  p.dv2 = dv2;
  p.part_a = static_cast<float*>(part_a);
  p.part_b = static_cast<float*>(part_b);
  p.part_w = static_cast<float*>(part_w);
  p.M = M;
  p.Ce = Ce;
  p.Cout = Cout;
  p.ks_w2t = ks_w2t;
  p.np8 = np8;
  const int E = dtype == 0 ? 4 : 8;
  p.vec16 = Ce % E == 0 && Cout % E == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  float* o[] = {static_cast<float*>(dw2), static_cast<float*>(ra), static_cast<float*>(rb)};
  if (dtype == 0) return launch<float>(p, sc, o[0], o[1], o[2], rpg, s);
  return launch<__nv_bfloat16>(p, sc, o[0], o[1], o[2], rpg, s);
}
