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
// Rounding points are the TPU kernel's (ir_fused.py:228-239, :340-344): e is
// NOT rounded before BN1 (the training path's _expand_chunk rounds it; this
// kernel does not share that epilogue), relu6(e * s1 + b1) is rounded to the
// input dtype, the depthwise taps are input-dtype values, d is rounded to
// the input dtype before the projection, the BN3 result is rounded and the
// residual added in the input dtype. Every elementwise BN is a multiply then
// an add, each rounded (scale_shift), as the plain version computes it.
//
// Bound on the H100: the products on the tensor cores (6 bf16 products per
// f32-level product, 1 per bf16 one, at 989 TFLOP/s) beside the depthwise
// on CUDA cores at 67 TFLOP/s, against reading x and writing out
// (chip_smoke.py counts all three); the expansion-1 stage is bound by bytes.
//
// What held the first design back (0.805 / 0.887 ms f32 / bf16 summed over
// the student's five stages at B=8; bf16 49x its bound): both products on
// CUDA cores in both dtypes, every chunk's weights staged with plain loads
// and four barriers a chunk, an 8x8 output tile whose 10x10 halo gave 400
// register tiles to 256 threads, and a split of the 32x32 stages' hidden
// chunks over blocks that needed an f32 partial buffer and a second kernel.
//
// This design:
// - Expand and project on the tensor cores: mma.sync.m16n8k16 with
//   ir_train_common.cuh's split-operand arithmetic (f32 operands in three
//   bf16 terms, each k-step's products into a fresh accumulator added with
//   __fadd_rn; bf16 one exact product); mma_steps below issues two k-steps'
//   chains interleaved. W1 and W2 arrive as pre-split fragments
//   (ops/ir_fused.py::mma_fragments, built once per folded-parameter set)
//   and are read from L2 through L1, which holds a chunk's fragments for the
//   block's warps (staging them in shared memory rings measured slower).
//   The A operands come by ldmatrix: the bf16 halo and d as they are, f32's
//   as three bf16 term planes, split once when staged, not at every read.
//   Only the depthwise runs on CUDA cores, from shared memory, each lane
//   sliding a 3-row window down its output column.
// - Persistent blocks of 8 warps, two a SM where shared memory allows, each
//   walking a contiguous range of (image, output tile) items and each
//   item's 32-channel hidden chunks. A chunk is two phases split by two
//   barriers:
//     A (tensor cores): the projection of the previous chunk (from d in
//       shared memory; its sums stay in registers across the item's chunks,
//       and BN3 and the residual are applied from them when the item's last
//       chunk is in), then the expand of this chunk over the halo into e;
//     B (CUDA cores): the depthwise of this chunk into d.
//   The two blocks of a SM overlap one's tensor phase with the other's
//   depthwise. The chunk's per-channel vectors (s1, b1; the taps, s2, b2)
//   are copied (cp.async) a phase ahead, and so is the next item's halo,
//   in phase B of the item's last chunk (f32's term planes are split from
//   plain loads there).
// - Output tile from the stage: 16x8, 8x8 or 4x8, the largest that still
//   gives every block slot an item (the student's 32x32 stages give 256
//   4x8 items at B=8), so no hidden split, partial buffer or second kernel
//   is needed. Halo recompute: (S*(TH-1)+3)(S*7+3) pixels for TH*8 outputs.
// - Shared memory: the halo [pin + 1][Cin] (all Cin, staged once an item;
//   the extra zero row is what ldmatrix reads for an m-tile's rows past the
//   halo) and d [pixels][32] in bf16 terms (one for bf16, three for f32), e
//   [pin][32] in the input dtype, swizzled for the fragment reads. At the
//   4x8 tile every block that the first design took fits.

#include <type_traits>

#include "ir_train_common.cuh"

namespace {

using namespace irt;

constexpr int kWarps = 8;
constexpr int kBlock = 32 * kWarps;
constexpr int kTW = 8;       // output tile columns
constexpr int kNWMax = 8;    // projection n-tiles a warp

// The busiest warp's (m-tile, n-tile) pairs when the expand's `mth` m-tiles
// and a chunk's 4 n-tiles are shared by kWarps warps, `wn` of them along n.
constexpr int expand_cost(int mth, int wn) {
  return (mth + kWarps / wn - 1) / (kWarps / wn) * (4 / wn);
}

// Tiling of one (stride, tile rows) instance.
template <int S, int TH>
struct Geo {
  static constexpr int TIN_H = S * (TH - 1) + 3, TIN_W = S * (kTW - 1) + 3;
  static constexpr int PIN = TIN_H * TIN_W;        // halo pixels
  static constexpr int M = TH * kTW;               // output pixels
  static constexpr int MT = M / 16;                // projection m-tiles: one a warp
  static constexpr int WNP = kWarps / MT;          // projection warps along n
  static constexpr int MTH = (PIN + 15) / 16;      // expand m-tiles
  // The expand shares (m-tile, n-tile) pairs of the chunk's 4 n-tiles among
  // the warps: WNH (2 or 4) warps along n, the rest along m, whichever
  // leaves the busiest warp the fewest pairs (ties: 2, so two n-tiles share
  // one A operand; four would take more registers than f32 has).
  static constexpr int C2 = expand_cost(MTH, 2), C4 = expand_cost(MTH, 4);
  static constexpr int WNH = C4 < C2 ? 4 : 2;
  static constexpr int WMH = kWarps / WNH;
  static constexpr int NM = (MTH + WMH - 1) / WMH;  // expand m-tiles a warp
  static constexpr int NN = 4 / WNH;                // expand n-tiles a warp
};

// Physical column of channel c in row r of e ([rows][32] of T) or of a d
// plane ([pixels][32] bf16): 8-element groups XOR-ed so that the expand's
// stores, ldmatrix phases and depthwise rows hit every bank (as
// ir_train_expand_dw.cu's ea_col).
template <typename T> __device__ __forceinline__ int sw_col(int r, int c) {
  return sizeof(T) == 4 ? c ^ ((r & 3) << 3) : c ^ (((r >> 1) & 3) << 3);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 8 : 0));
}

// Per-chunk vectors staged in shared memory, in floats: s1 and b1 of the
// chunk's 32 channels (read by the expand's epilogue), then its 9 depthwise
// taps, s2 and b2 (read by the depthwise).
constexpr int kVecX = 2 * kKC, kVecD = 11 * kKC;

struct Params {
  const void* x;
  void* out;
  const uint2* w1f;  // W1's fragments (mma_fragments), ksw1 k-steps a n-tile
  const uint2* w2f;  // W2's fragments, ksw2 k-steps a n-tile
  const float* s1;
  const float* b1;
  const float* dw;   // [9][Ce], input-dtype values
  const float* s2;
  const float* b2;
  const float* s3;
  const float* b3;
  int H, W, Ho, Wo, Cin, Ce, Cout;
  int tiles_x, tiles, nch, ks1, ksw1, ksw2;
  int ntv;           // projection n-tiles holding output channels
  int nw;            // projection n-tiles a warp
  int ldx;           // staged halo row, elements
  int gran;          // bytes a copy of x: 16, or 8 where a bf16 row is not 16-byte sized
  int residual;
  int off_ea, off_ds, off_vec;  // bytes
  long long items;
};

// Shared memory of one instance: the halo's and d's bf16 term planes
// (`terms` of them; the halo with its zero row), e, the chunk's vectors.
// ops/ir_fused.py::_smem_bytes repeats this for the 4x8 tile in f32.
struct Layout {
  int ldx, off_ea, off_ds, off_vec, total;
};
inline Layout layout_of(int pin, int m, bool exp, int Cin, int es, int terms) {
  Layout L;
  L.ldx = row_ld(Cin, 2);
  L.off_ea = exp ? terms * (pin + 1) * L.ldx * 2 : 0;
  L.off_ds = L.off_ea + (exp ? 1 : 2) * pin * kKC * es;  // expansion 1: two e slots
  L.off_vec = L.off_ds + terms * m * kKC * 2;
  L.total = L.off_vec + (kVecX + kVecD) * 4;
  return L;
}

// KK consecutive k-steps of a warp's NM x NN tiles. Each (k-step, tile)
// gets mma_step's products, in mma_step's order, into a fresh accumulator,
// and each tile's k-step sums are added to acc in k order (__fadd_rn): acc
// ends as KK calls of mma_step_tiles leave it, bit for bit, but the KK * NM
// * NN chains of dependent products are issued interleaved.
template <int AT, int BT, int KK, int NM, int NN>
__device__ __forceinline__ void mma_steps(float (&acc)[NM][NN][4],
                                          const uint32_t (&a)[KK][NM][AT][4],
                                          const uint32_t (&b)[KK][NN][BT][2]) {
  float tmp[KK][NM][NN][4];
#pragma unroll
  for (int q = 0; q < KK; ++q)
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) tmp[q][m][n][r] = 0.f;
#pragma unroll
  for (int s = kTerms - 1; s >= 0; --s)
#pragma unroll
    for (int i = kTerms - 1; i >= 0; --i) {
      const int j = s - i;
      if (j >= 0 && i < AT && j < BT) {
#pragma unroll
        for (int q = 0; q < KK; ++q)
#pragma unroll
          for (int n = 0; n < NN; ++n)
#pragma unroll
            for (int m = 0; m < NM; ++m)
              mma_bf16(tmp[q][m][n], a[q][m][i], b[q][n][j][0], b[q][n][j][1]);
      }
    }
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < KK; ++q) acc[m][n][r] = __fadd_rn(acc[m][n][r], tmp[q][m][n][r]);
}

// Expand of G m-tiles x NN n-tiles of a chunk over all of Cin: ev[u][j]
// (zeroed here), two k-steps at a time, every tile's chains issued
// together; a_at(a, u, ks) gives m-tile u's A terms, w_at(j, ks) n-tile
// j's fragment.
template <typename T, int G, int NN, typename AAt, typename WAt>
__device__ __forceinline__ void expand_tiles(float (&ev)[G][NN][4], int ks1, int lane, AAt a_at,
                                             WAt w_at) {
  constexpr int TERMS = Mma<T>::terms;
  constexpr int KK = 2;
#pragma unroll
  for (int u = 0; u < G; ++u)
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) ev[u][j][r] = 0.f;
  int ks = 0;
  for (; ks + KK <= ks1; ks += KK) {
    uint32_t a[KK][G][TERMS][4];
    uint32_t b[KK][NN][TERMS][2];
#pragma unroll
    for (int q = 0; q < KK; ++q) {
#pragma unroll
      for (int j = 0; j < NN; ++j) load_b<T>(b[q][j], w_at(j, ks + q), lane);
#pragma unroll
      for (int u = 0; u < G; ++u) a_at(a[q][u], u, ks + q);
    }
    mma_steps<TERMS, TERMS, KK, G, NN>(ev, a, b);
  }
  for (; ks < ks1; ++ks) {
    uint32_t a[1][G][TERMS][4];
    uint32_t b[1][NN][TERMS][2];
#pragma unroll
    for (int j = 0; j < NN; ++j) load_b<T>(b[0][j], w_at(j, ks), lane);
#pragma unroll
    for (int u = 0; u < G; ++u) a_at(a[0][u], u, ks);
    mma_steps<TERMS, TERMS, 1, G, NN>(ev, a, b);
  }
}

template <typename T, int S, int TH, bool EXP>
__global__ void __launch_bounds__(kBlock, 2)
ir_infer_kernel(const Params P) {
  using Gm = Geo<S, TH>;
  constexpr int TERMS = Mma<T>::terms;
  constexpr int E = 16 / (int)sizeof(T);  // elements a 16-byte chunk
  constexpr int PIN = Gm::PIN, TIN_W = Gm::TIN_W;
  constexpr int DPLANE = Gm::M * kKC;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  // The tensor cores' A operands, in bf16 terms: the halo and d.
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(smem);  // [TERMS][PIN + 1][ldx]
  const int xplane = (PIN + 1) * P.ldx;
  T* ea = reinterpret_cast<T*>(smem + P.off_ea);               // [PIN][32] (two at expansion 1)
  __nv_bfloat16* db = reinterpret_cast<__nv_bfloat16*>(smem + P.off_ds);  // [TERMS][M][32]
  float* vx = reinterpret_cast<float*>(smem + P.off_vec);      // s1, b1 [2][32]
  float* vd = vx + kVecX;                                      // taps, s2, b2 [11][32]
  const T* __restrict__ x = static_cast<const T*>(P.x);
  T* __restrict__ out = static_cast<T*>(P.out);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int H = P.H, W = P.W, Cin = P.Cin, Ce = P.Ce;
  const int first = (int)((long long)P.items * blockIdx.x / gridDim.x);
  const int last = (int)((long long)P.items * (blockIdx.x + 1) / gridDim.x);
  const long long steps = (long long)(last - first) * P.nch;  // a step: an item's chunk
  if (steps == 0) return;

  struct Item { int b, oy0, ox0; };
  auto decode = [&](int it) {
    Item r;
    r.b = it / P.tiles;
    const int tile = it - r.b * P.tiles;
    r.oy0 = (tile / P.tiles_x) * TH;
    r.ox0 = (tile % P.tiles_x) * kTW;
    return r;
  };
  auto inside = [&](const Item& it, int p, int* iy, int* ix) {
    *iy = it.oy0 * S - 1 + p / TIN_W;
    *ix = it.ox0 * S - 1 + p % TIN_W;
    return *iy >= 0 && *iy < H && *ix >= 0 && *ix < W;
  };
  // The item's halo, all of Cin (zero past Cin, to the k-steps' 16, and
  // outside the image). bf16: cp.async (the zero row is written once).
  // f32: split into its three bf16 terms, one plane each, from plain loads
  // (four 8-channel groups in flight a thread), the zero row included.
  auto stage_halo = [&](const Item& it) {
    if constexpr (sizeof(T) == 2) {
      const int per = P.gran / (int)sizeof(T);
      const int cpr = (Cin + 15) / 16 * 16 / per;
      for (int i = tid; i < PIN * cpr; i += kBlock) {
        const int p = i / cpr, ch = (i - p * cpr) * per;
        int iy, ix;
        const bool ok = inside(it, p, &iy, &ix) && ch < Cin;
        T* dst = reinterpret_cast<T*>(xb) + p * P.ldx + x_chunk<T>(p, ch / E) * E + ch % E;
        const void* src = ok ? (const void*)(x + (((size_t)it.b * H + iy) * W + ix) * Cin + ch)
                             : P.x;
        if (P.gran == 16) cp_async16(dst, src, ok);
        else cp_async8(dst, src, ok);
      }
    } else {
      const int gr = 2 * P.ks1, n = (PIN + 1) * gr;
      for (int i0 = tid; i0 < n; i0 += 4 * kBlock) {
        float4 v[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kBlock, p = i / gr, c = (i - p * gr) * 8;
          v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
          int iy, ix;
          if (i < n && p < PIN && inside(it, p, &iy, &ix)) {
            const float* src = x + (((size_t)it.b * H + iy) * W + ix) * Cin + c;
            if (c < Cin) v[u][0] = load4(src);
            if (c + 4 < Cin) v[u][1] = load4(src + 4);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kBlock, p = i / gr, c = (i - p * gr) * 8;
          if (i >= n) continue;
          uint32_t o[4][kTerms];
          split3(v[u][0].x, v[u][0].y, o[0]);
          split3(v[u][0].z, v[u][0].w, o[1]);
          split3(v[u][1].x, v[u][1].y, o[2]);
          split3(v[u][1].z, v[u][1].w, o[3]);
#pragma unroll
          for (int q = 0; q < kTerms; ++q)
            *reinterpret_cast<uint4*>(xb + q * xplane + p * P.ldx +
                                      x_chunk<__nv_bfloat16>(p, c / 8) * 8) =
                make_uint4(o[0][q], o[1][q], o[2][q], o[3][q]);
        }
      }
    }
  };
  // Expansion 1: e is the halo of x itself, channels [k0, k0 + 32), into
  // one of two slots.
  auto issue_e = [&](const Item& it, int k0, int slot) {
    const int per = P.gran / (int)sizeof(T);
    const int lg = P.gran == 16 && sizeof(T) == 2 ? 2 : 3;  // log2 of the copies a row
    for (int i = tid; i < PIN << lg; i += kBlock) {
      const int p = i >> lg, cl = (i & ((1 << lg) - 1)) * per;
      int iy, ix;
      const bool ok = inside(it, p, &iy, &ix) && k0 + cl < Ce;
      T* dst = ea + (slot * PIN + p) * kKC + sw_col<T>(p, cl);
      const void* src = ok ? (const void*)(x + (((size_t)it.b * H + iy) * W + ix) * Cin + k0 + cl)
                           : P.x;
      if (P.gran == 16) cp_async16(dst, src, ok);
      else cp_async8(dst, src, ok);
    }
  };
  // Rows of 32 floats of the chunk at k0 (zero past Ce): s1, b1 into vx
  // (`expand`), or the taps, s2, b2 into vd.
  auto issue_vec = [&](int k0, bool expand) {
    const int rows = expand ? 2 : 11;
    for (int i = tid; i < rows * 8; i += kBlock) {
      const int row = i >> 3, q = (i & 7) * 4;
      const float* src = expand ? (row ? P.b1 : P.s1)
                                : row < 9 ? P.dw + (size_t)row * Ce : (row == 9 ? P.s2 : P.b2);
      const bool ok = k0 + q < Ce;
      cp_async16((expand ? vx : vd) + row * kKC + q, ok ? (const void*)(src + k0 + q) : P.x, ok);
    }
  };

  // Projection: warp = (m-tile pm, n group pn); n-tiles pn + WNP j.
  const int pm = warp % Gm::MT, pn = warp / Gm::MT;
  float acc[kNWMax][4];
#pragma unroll
  for (int j = 0; j < kNWMax; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  // Copy groups, in commit order, each step k: [the taps, s2, b2 of k] then
  // [at expansion 1, e of k + 1] after barrier 1; [the next item's halo],
  // [s1, b1 of k + 1] in phase B. Barrier 2 waits for all but the newest
  // group, barrier 1 for all.
  {
    const Item it0 = decode(first);
    if (EXP && sizeof(T) == 2) {  // the zero row (stage_halo's copies fill rows < PIN)
      for (int i = tid; i < P.ldx / 8; i += kBlock)
        *reinterpret_cast<uint4*>(xb + PIN * P.ldx + 8 * i) = make_uint4(0u, 0u, 0u, 0u);
    }
    if (EXP) {
      stage_halo(it0);
      issue_vec(0, true);
    } else {
      issue_e(it0, 0, 0);
    }
    cp_commit();
  }

  // This step's chunk kc of item `item` (decoded: it), the previous step's
  // chunk and item; counters, not divisions, a step.
  int kc = 0, item = first, pkc = 0;
  Item it = decode(first), pit = it;
  for (long long k = 0; k <= steps; ++k) {
    const bool has = k < steps;
    const int k0 = kc * kKC;
    const int nkc = kc + 1 == P.nch ? 0 : kc + 1;  // the next step's chunk
    // Barrier 1: s1 and b1 of step k and the item's halo (at expansion 1, e
    // of step k) landed; step k - 1's d is written; e and the depthwise's
    // vectors are free.
    cp_wait<0>();
    __syncthreads();
    if (has) issue_vec(k0, false);
    cp_commit();
    if (!EXP && k + 1 < steps) issue_e(nkc ? it : decode(item + 1), nkc * kKC, (int)((k + 1) & 1));
    cp_commit();

    // Phase A. The projection of step k - 1's chunk (its two k-steps
    // together) ...
    if (k >= 1) {
      const int pc = pkc;
      uint32_t a[2][1][TERMS][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int r = 16 * pm + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int col = sw_col<__nv_bfloat16>(r, (2 * kk + (lane >> 4)) * 8);
#pragma unroll
        for (int q = 0; q < TERMS; ++q) ldsm_x4(a[kk][0][q], db + q * DPLANE + r * kKC + col);
      }
      // The warp's n-tiles in groups of NG, each group's chains issued
      // together (bf16 four, f32 two: its split operands take three times
      // the registers); n-tiles past the output channels take zeros.
      constexpr int NG = TERMS == 1 ? 4 : 2;
#pragma unroll
      for (int jg = 0; jg < kNWMax / NG; ++jg) {
        if (NG * jg >= P.nw) break;
        uint32_t b[2][NG][TERMS][2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int h = 0; h < NG; ++h) {
            const int nt = pn + Gm::WNP * (NG * jg + h);
            if (nt < P.ntv) {
              load_b<T>(b[kk][h], P.w2f + ((size_t)nt * P.ksw2 + 2 * pc + kk) * TERMS * 32, lane);
            } else {
#pragma unroll
              for (int q = 0; q < TERMS; ++q) b[kk][h][q][0] = b[kk][h][q][1] = 0u;
            }
          }
        float grp[1][NG][4];
#pragma unroll
        for (int h = 0; h < NG; ++h)
#pragma unroll
          for (int r = 0; r < 4; ++r) grp[0][h][r] = acc[NG * jg + h][r];
        mma_steps<TERMS, TERMS, 2, 1, NG>(grp, a, b);
#pragma unroll
        for (int h = 0; h < NG; ++h)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[NG * jg + h][r] = grp[0][h][r];
      }
      // ... and, after an item's last chunk, BN3, the residual and the store.
      if (pc == P.nch - 1) {
        const Item po = pit;
#pragma unroll
        for (int j = 0; j < kNWMax; ++j) {
          const int nt = pn + Gm::WNP * j;
          const int co = 8 * nt + 2 * t;
          if (j < P.nw && nt < P.ntv && co < P.Cout) {
            const float sa = __ldg(P.s3 + co), sb = __ldg(P.s3 + co + 1);
            const float ba = __ldg(P.b3 + co), bb = __ldg(P.b3 + co + 1);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int pp = 16 * pm + g + 8 * h;
              const int oy = po.oy0 + pp / kTW, ox = po.ox0 + pp % kTW;
              if (oy >= P.Ho || ox >= P.Wo) continue;
              float o0 = round_to<T>(scale_shift(acc[j][2 * h], sa, ba));
              float o1 = round_to<T>(scale_shift(acc[j][2 * h + 1], sb, bb));
              if (P.residual) {
                const T* xr = x + (((size_t)po.b * H + oy) * W + ox) * Cin + co;
                o0 = to_f(xr[0]) + o0;
                o1 = to_f(xr[1]) + o1;
              }
              store_pair(out + (((size_t)po.b * P.Ho + oy) * P.Wo + ox) * P.Cout + co, o0, o1);
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
        }
      }
    }

    // ... then the expand of step k's chunk over the halo: relu6(e * s1 +
    // b1), rounded to T (e itself unrounded), 0 outside the image and past Ce.
    if (EXP && has) {
      const int wmh = warp % Gm::WMH, wnh = warp / Gm::WMH;
      const uint2* wb[Gm::NN];  // this warp's n-tiles of W1, at k-step 0
#pragma unroll
      for (int j = 0; j < Gm::NN; ++j)
        wb[j] = P.w1f + (size_t)(k0 / 8 + wnh * Gm::NN + j) * P.ksw1 * TERMS * 32;
      auto w_at = [&](int j, int ks) { return wb[j] + ks * TERMS * 32; };
      const int ahi = lane >> 4;
      // GM m-tiles at a time (their chains issued together): two, but one
      // for f32 with two n-tiles a warp, whose registers that would exceed.
      constexpr int GM = TERMS == 1 || Gm::NN == 1 ? 2 : 1;
      auto expand_group = [&](auto gm, int u0) {
        constexpr int G = decltype(gm)::value;
        int ar[G];  // the lane's ldmatrix row of each m-tile (the zero row past the halo)
#pragma unroll
        for (int u = 0; u < G; ++u)
          ar[u] = min(16 * (wmh + Gm::WMH * (u0 + u)) + (lane & 7) + 8 * ((lane >> 3) & 1), PIN);
        auto a_at = [&](uint32_t (&a)[TERMS][4], int u, int ks) {
          const __nv_bfloat16* src =
              xb + ar[u] * P.ldx + x_chunk<__nv_bfloat16>(ar[u], 2 * ks + ahi) * 8;
#pragma unroll
          for (int q = 0; q < TERMS; ++q) ldsm_x4(a[q], src + q * xplane);
        };
        float ev[G][Gm::NN][4];
        expand_tiles<T, G, Gm::NN>(ev, P.ks1, lane, a_at, w_at);
        float sb[Gm::NN][4];  // s1, s1', b1, b1' of the lane's channel pair
#pragma unroll
        for (int j = 0; j < Gm::NN; ++j) {
          const int cl = 8 * (wnh * Gm::NN + j) + 2 * t;
          sb[j][0] = vx[cl]; sb[j][1] = vx[cl + 1];
          sb[j][2] = vx[kKC + cl]; sb[j][3] = vx[kKC + cl + 1];
        }
#pragma unroll
        for (int u = 0; u < G; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * (wmh + Gm::WMH * (u0 + u)) + g + 8 * h;
            if (r >= PIN) continue;
            int iy, ix;
            const bool in = inside(it, r, &iy, &ix);
            T* row = ea + r * kKC;
#pragma unroll
            for (int j = 0; j < Gm::NN; ++j) {
              const int cl = 8 * (wnh * Gm::NN + j) + 2 * t, c = k0 + cl;
              store_pair(row + sw_col<T>(r, cl),
                         in && c < Ce ? relu6(scale_shift(ev[u][j][2 * h], sb[j][0], sb[j][2]))
                                      : 0.f,
                         in && c + 1 < Ce
                             ? relu6(scale_shift(ev[u][j][2 * h + 1], sb[j][1], sb[j][3]))
                             : 0.f);
            }
          }
      };
#pragma unroll
      for (int u0 = 0; u0 < Gm::NM; u0 += GM) {
        if (wmh + Gm::WMH * u0 >= Gm::MTH) break;
        if (GM == 2 && u0 + 1 < Gm::NM && wmh + Gm::WMH * (u0 + 1) < Gm::MTH)
          expand_group(std::integral_constant<int, GM>(), u0);
        else
          expand_group(std::integral_constant<int, 1>(), u0);
      }
    }
    // Barrier 2: e and step k's taps are in; the halo, d and s1, b1 are free.
    cp_wait<1>();
    __syncthreads();

    // Phase B: copies for what comes next, then the depthwise: lane =
    // channel, warp = output column. Each lane slides down the halo rows
    // its outputs need; each output takes its taps in (ky, kx) order.
    if (EXP && has && nkc == 0 && k + 1 < steps) stage_halo(decode(item + 1));
    cp_commit();
    if (EXP && k + 1 < steps) issue_vec(nkc * kKC, true);
    cp_commit();
    if (has) {
      const T* ev = ea + (EXP ? 0 : (int)(k & 1) * PIN * kKC);
      const bool live = k0 + lane < Ce;
      float tap[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) tap[q] = vd[q * kKC + lane];
      const float sc = vd[9 * kKC + lane], bc = vd[10 * kKC + lane];
      const int col = warp;
      float a[TH];
#pragma unroll
      for (int i = 0; i < TH; ++i) a[i] = 0.f;
#pragma unroll
      for (int rr = 0; rr < (TH - 1) * S + 3; ++rr) {
        float v[3];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int r = rr * TIN_W + col * S + kx;
          v[kx] = to_f(ev[r * kKC + sw_col<T>(r, lane)]);
        }
#pragma unroll
        for (int i = 0; i < TH; ++i) {
          const int ky = rr - i * S;
          if (ky >= 0 && ky < 3) {
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) a[i] = fmaf(v[kx], tap[ky * 3 + kx], a[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TH; ++i) {
        const int p = i * kTW + col;
        const float v = live ? relu6(scale_shift(a[i], sc, bc)) : 0.f;
        __nv_bfloat16* dp = db + p * kKC + sw_col<__nv_bfloat16>(p, lane);
        if constexpr (sizeof(T) == 4) {  // d's three bf16 terms, one plane each
          uint32_t o[kTerms];
          split3(v, 0.f, o);
#pragma unroll
          for (int q = 0; q < kTerms; ++q)
            dp[q * DPLANE] = __ushort_as_bfloat16((unsigned short)(o[q] & 0xffffu));
        } else {
          *dp = __float2bfloat16(v);
        }
      }
    }
    pkc = kc;
    pit = it;
    kc = nkc;
    if (nkc == 0 && ++item < last) it = decode(item);
  }
  cp_wait<0>();
}

template <typename T, int S, int TH, bool EXP>
cudaError_t prepare(size_t smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(ir_infer_kernel<T, S, TH, EXP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, ir_infer_kernel<T, S, TH, EXP>,
                                                       kBlock, smem);
}

template <typename T, int S, int TH>
cudaError_t prepare_e(bool exp, size_t smem, int* per_sm) {
  return exp ? prepare<T, S, TH, true>(smem, per_sm) : prepare<T, S, TH, false>(smem, per_sm);
}

template <typename T>
cudaError_t prepare_t(int stride, int th, bool exp, size_t smem, int* per_sm) {
  if (stride == 2)
    return th == 8 ? prepare_e<T, 2, 8>(exp, smem, per_sm) : prepare_e<T, 2, 4>(exp, smem, per_sm);
  if (th == 16) return prepare_e<T, 1, 16>(exp, smem, per_sm);
  return th == 8 ? prepare_e<T, 1, 8>(exp, smem, per_sm) : prepare_e<T, 1, 4>(exp, smem, per_sm);
}

struct Plan {
  int th = 0, per_sm = 0;
  size_t smem = 0;
  long long grid = 0;
  Params p;
};

// The launch of one call: of the tiles 16x8 (stride 1), 8x8 and 4x8 whose
// projection fits a warp's registers (Cout <= 64, 128, 256), the one that
// gives the most block slots an item (two blocks a SM where shared memory
// lets them), weighed by the halo recompute it saves (ties: the larger
// tile); then the persistent grid.
cudaError_t plan_of(int B, int Ho, int Wo, int Cin, int Ce, int Cout, int stride, int has_expand,
                    int dtype, Plan* L) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int es = dtype == 0 ? 4 : 2, terms = dtype == 0 ? kTerms : 1;
  const bool exp = has_expand != 0;
  Params& p = L->p;
  p.ntv = (Cout + 7) / 8;
  double best = 0;
  for (int th : {16, 8, 4}) {
    const int mt = th * kTW / 16, wnp = kWarps / mt;
    const int nw = (p.ntv + wnp - 1) / wnp;
    if ((th == 16 && stride != 1) || nw > kNWMax) continue;
    const int pin = (stride * (th - 1) + 3) * (stride * (kTW - 1) + 3);
    const Layout lay = layout_of(pin, th * kTW, exp, Cin, es, terms);
    if (lay.total > kSmemBlock) continue;
    const long long items = (long long)B * ((Ho + th - 1) / th) * ((Wo + kTW - 1) / kTW);
    const long long slots = (long long)(lay.total <= kSmemTwoBlocks ? 2 : 1) * sms;
    // Block slots with an item, times the share of the halo's expand that
    // lands in the tile's outputs.
    const double score = (double)(items < slots ? items : slots) * th * kTW / pin;
    if (score > best) {
      best = score;
      L->th = th;
      L->smem = lay.total;
      p.nw = nw;
      p.ldx = lay.ldx;
      p.off_ea = lay.off_ea; p.off_ds = lay.off_ds; p.off_vec = lay.off_vec;
    }
  }
  if (L->th == 0) return cudaErrorInvalidValue;
  p.Ho = Ho; p.Wo = Wo; p.Cin = Cin; p.Ce = Ce; p.Cout = Cout;
  p.tiles_x = (Wo + kTW - 1) / kTW;
  p.tiles = p.tiles_x * ((Ho + L->th - 1) / L->th);
  p.nch = (Ce + kKC - 1) / kKC;
  p.ks1 = (Cin + 15) / 16;
  p.gran = (Cin * es) % 16 == 0 ? 16 : 8;
  p.items = (long long)B * p.tiles;
  e = dtype == 0 ? prepare_t<float>(stride, L->th, exp, L->smem, &L->per_sm)
                 : prepare_t<__nv_bfloat16>(stride, L->th, exp, L->smem, &L->per_sm);
  if (e != cudaSuccess) return e;
  if (L->per_sm <= 0) return cudaErrorInvalidConfiguration;
  const long long g = (long long)L->per_sm * sms;
  L->grid = p.items < g ? p.items : g;
  return cudaSuccess;
}

template <typename T>
cudaError_t run(const Plan& L, int stride, int has_expand, cudaStream_t s) {
  const dim3 grid((unsigned)L.grid);
#define IR_RUN(S_, TH_)                                                    \
  (has_expand ? ir_infer_kernel<T, S_, TH_, true><<<grid, kBlock, L.smem, s>>>(L.p) \
              : ir_infer_kernel<T, S_, TH_, false><<<grid, kBlock, L.smem, s>>>(L.p))
  if (stride == 2) {
    if (L.th == 8) IR_RUN(2, 8); else IR_RUN(2, 4);
  } else if (L.th == 16) {
    IR_RUN(1, 16);
  } else if (L.th == 8) {
    IR_RUN(1, 8);
  } else {
    IR_RUN(1, 4);
  }
#undef IR_RUN
  return cudaGetLastError();
}

bool bad_args(int B, int H, int W, int Ho, int Wo, int Cin, int Ce, int Cout, int stride,
              int has_expand, int dtype) {
  return B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ce <= 0 || Cout <= 0 || Cout > 256 ||
         Cin % 4 || Ce % 4 || Cout % 4 || (stride != 1 && stride != 2) ||
         Ho != (H - 1) / stride + 1 || Wo != (W - 1) / stride + 1 ||
         (!has_expand && Ce != Cin) || (dtype != 0 && dtype != 1);
}

}  // namespace

// The plan of a call, into out[5]: output tile rows and columns, shared
// memory a block (bytes), resident blocks per SM, blocks launched. Returns
// the CUDA error.
extern "C" int ir_fused_infer_plan(int B, int H, int W, int Cin, int Ce, int Cout, int stride,
                                   int has_expand, int dtype, void* out) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  if (bad_args(B, H, W, Ho, Wo, Cin, Ce, Cout, stride, has_expand, dtype))
    return (int)cudaErrorInvalidValue;
  Plan L;
  const cudaError_t e = plan_of(B, Ho, Wo, Cin, Ce, Cout, stride, has_expand, dtype, &L);
  if (e != cudaSuccess) return (int)e;
  int* o = static_cast<int*>(out);
  o[0] = L.th; o[1] = kTW; o[2] = (int)L.smem; o[3] = L.per_sm; o[4] = (int)L.grid;
  return 0;
}

// x [B, H, W, Cin] and out [B, Ho, Wo, Cout] NHWC (dtype 0 = f32, 1 = bf16),
// 16-byte aligned; w1f and w2f the mma fragments of W1 [Cin, Ce] and W2
// [Ce, Cout] holding input-dtype values (ops/ir_fused.py::mma_fragments;
// ksw1 and ksw2 k-steps a n-tile; w1f, s1 and b1 unused, may be null, when
// has_expand is 0, then Ce == Cin); s1/b1/s2/b2 [Ce], s3/b3 [Cout] and dw
// [9, Ce] (input-dtype values) in f32, 16-byte aligned. stride 1 or 2; Cin,
// Ce and Cout multiples of 4; Cout <= 256; residual adds x (stride 1, Cin
// == Cout).
extern "C" int ir_fused_infer(const void* x, const void* w1f, const void* s1, const void* b1,
                              const void* dw, const void* s2, const void* b2, const void* w2f,
                              const void* s3, const void* b3, void* out, int B, int H, int W,
                              int Ho, int Wo, int Cin, int Ce, int Cout, int ksw1, int ksw2,
                              int stride, int has_expand, int residual, int dtype,
                              void* stream) {
  if (bad_args(B, H, W, Ho, Wo, Cin, Ce, Cout, stride, has_expand, dtype) ||
      (has_expand && (!w1f || ksw1 * 16 < Cin)) || ksw2 * 16 < Ce || !w2f ||
      (residual && (stride != 1 || Cin != Cout)))
    return (int)cudaErrorInvalidValue;
  Plan L;
  cudaError_t e = plan_of(B, Ho, Wo, Cin, Ce, Cout, stride, has_expand, dtype, &L);
  if (e != cudaSuccess) return (int)e;
  Params& p = L.p;
  p.x = x;
  p.out = out;
  p.w1f = static_cast<const uint2*>(w1f);
  p.w2f = static_cast<const uint2*>(w2f);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.dw = static_cast<const float*>(dw);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.s3 = static_cast<const float*>(s3);
  p.b3 = static_cast<const float*>(b3);
  p.H = H;
  p.W = W;
  p.ksw1 = ksw1;
  p.ksw2 = ksw2;
  p.residual = residual;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? run<float>(L, stride, has_expand, s)
                          : run<__nv_bfloat16>(L, stride, has_expand, s));
}
