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
// ReLU6 mask can disagree with the forward's activation: both compute it
// with the shared expand_step (ir_train_common.cuh) on the tensor cores,
// k-steps of 16 input channels in increasing order, from the same x values
// and W1 fragments, and the same halo pixel and channel land in the same
// fragment position in both (16-pixel m-tiles of the same halo, 8-channel
// n-tiles of the same 32-channel chunk). Both kernels' probe builds write e
// so that chip_smoke.py can compare the two bit for bit.
//
// Design. A work item is (image, 8x8 output tile, 32 hidden channels),
// ordered image, tile, channel chunk (fastest), so consecutive items of a
// block share the input halo and find it in L2. Persistent blocks, as many
// as the SMs hold (ir_train_dw_bwd_occupancy), each walk a contiguous range
// of items. Per item, with the next item's loads in flight (cp.async):
//   A  the expand, on the tensor cores (expand_step, the tiles shared among
//      the warps as in K9; W1's fragments read through L1). Where it leaves
//      two blocks an SM (every stride-1 stage; stride 2 at Cin 32, and in
//      bf16 at Cin 64), x's whole halo tile ((7s+3)^2 pixels, all Cin) is
//      staged once per tile and serves the tile's consecutive items, the
//      next tile's loading (cp.async) once every warp has expanded (FULL);
//      else it arrives in Cin chunks of 16 through a two-slot ring
//      (XOR-swizzled 16-byte chunks), the next chunk (or the next item's
//      first) loading while this one is multiplied. e is kept once, in the
//      input dtype; e_act = round(relu6(e * s1 + b1)) is recomputed where it
//      is read (zero outside the image);
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
// in a fixed order, so every sum is deterministic. Shared memory per block
// at the student's stages 1-5 (ir_train_dw_bwd_smem): 53.5 / 114.7 / 79.1 /
// 114.7 / 104.7 KB f32, 34.3 / 83.4 / 47.1 / 83.4 / 59.9 KB bf16; 2 resident
// blocks of 8 warps per SM (at most 128 registers a thread).
//
// Bound on the H100: the expand recompute's products on the tensor cores
// (2*B*H*W*Cin*Ce each; 6 in f32, 1 in bf16) at 989 TFLOP/s plus
// 36*B*Ho*Wo*Ce multiply-adds (tap sums and the transposed conv) on CUDA
// cores, against reading x, d and dv2 and writing dv1; bytes for the
// expansion-1 stage. The halo recompute adds (7s+3)^2/(8s)^2 - 1 of
// the expand work (56% at stride 1, 13% at stride 2).

#include "ir_train_common.cuh"

namespace {

using namespace irt;

constexpr int kCK = 16;           // input channels per ring chunk: one k-step
constexpr int kDH = kT + 2;       // dd halo side: output rows/cols o0-1 .. o0+8
constexpr int kNDH = kDH * kDH;
constexpr int kNV = 18;           // channel vectors: 9 taps, s1 b1 m1 inv1, u2 p2 q2 m2 inv2
constexpr int kNS = 11;           // per-channel sums: 9 taps, ra, rb

// Shared memory, in order: x (FULL: the whole halo [PIN][ldx], staged once
// per tile; else a two-slot ring of [PIN][kCK] chunks), e
// [PIN][kKC], dd [kNDH][kKC] f32, the staging of d and dv2 (later the
// warps' sums) and the channel vectors [kNV][kKC] f32.
template <typename T, int S, bool EXP, bool FULL>
struct Layout {
  static constexpr int TIN = S * (kT - 1) + 3;
  static constexpr int PIN = TIN * TIN;
  static constexpr int ES = (int)sizeof(T);
  static constexpr int STG_IN = 2 * kNDH * kKC * ES;
  static constexpr int RED = 8 * kNS * kKC * 4;
  static constexpr int STG = STG_IN > RED ? STG_IN : RED;
  static constexpr int E_B = PIN * kKC * ES, DD_B = kNDH * kKC * 4;
  static constexpr int REST = E_B + DD_B + STG + kNV * kKC * 4;
  __host__ __device__ static int x_bytes(int ldx) {
    return !EXP ? 0 : FULL ? PIN * ldx * ES : 2 * PIN * kCK * ES;
  }
  __host__ __device__ static int bytes(int ldx) { return x_bytes(ldx) + REST; }
  static_assert(E_B % 16 == 0 && DD_B % 16 == 0 && STG % 16 == 0 && (PIN * kCK * ES) % 16 == 0,
                "16-byte aligned regions");
};

// Physical 16-byte chunk of logical chunk c in ring row r (rows of 16
// channels): a half-warp's float2 fragment reads (f32, rows g..g+3) or a
// warp's 32-bit reads (bf16, rows g..g+7) then hit all banks.
template <typename T> __device__ __forceinline__ int ring_chunk(int r, int c) {
  return sizeof(T) == 4 ? c ^ (((r >> 1) & 1) << 1) : c ^ ((r >> 2) & 1);
}

struct Params {
  const void* x;
  const uint2* w1f;       // W1's fragments (ops/ir_fused.py::mma_fragments)
  const float* vec[kNV];  // dw rows 0-8 ([9][Ce]), s1, b1, m1, inv1, u2, p2, q2, m2, inv2
  const void* dv2;
  const void* d;
  void* dv1;
  float* part_dw;         // [grid][9 * Ce]
  float* part_a;          // [grid][Ce]
  float* part_b;          // [grid][Ce]
  float* probe;           // [B][H][W][Ce] f32 e of every tile's own pixels, or null
  int H, W, Ho, Wo, Cin, Ce, tiles_x, tiles, nch;
  int ksteps;             // k-steps per n-tile in w1f
  int ldx;                // row width of the staged halo (FULL)
  long long items;
};

// PROBE (chip_smoke.py's check of e against K9) also writes e to P.probe;
// the main path's build has no trace of it.
template <typename T, int S, bool EXP, bool FULL, bool PROBE>
__global__ void __launch_bounds__(kThreads, 2)
dw_bwd_kernel(const Params P) {
  using L = Layout<T, S, EXP, FULL>;
  constexpr int TIN = L::TIN, PIN = L::PIN;
  constexpr int E = 16 / (int)sizeof(T);  // elements a 16-byte copy
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int o_e = L::x_bytes(P.ldx), o_dd = o_e + L::E_B, o_stg = o_dd + L::DD_B;
  T* ring_x = reinterpret_cast<T*>(smem);                    // [2][PIN][kCK], or the halo
  T* ebuf = reinterpret_cast<T*>(smem + o_e);                // [PIN][kKC] e (x at e1)
  float* ddb = reinterpret_cast<float*>(smem + o_dd);        // [kNDH][kKC] dd
  T* stg_d = reinterpret_cast<T*>(smem + o_stg);             // [kNDH][kKC] d
  T* stg_v = stg_d + kNDH * kKC;                             // [kNDH][kKC] dv2
  float* red = reinterpret_cast<float*>(smem + o_stg);       // [8][kNS][kKC], after B
  float* vec = reinterpret_cast<float*>(smem + o_stg + L::STG);  // [kNV][kKC]

  const T* __restrict__ x = static_cast<const T*>(P.x);
  const T* __restrict__ dv2 = static_cast<const T*>(P.dv2);
  const T* __restrict__ dg = static_cast<const T*>(P.d);
  T* __restrict__ dv1 = static_cast<T*>(P.dv1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = P.H, W = P.W, Ho = P.Ho, Wo = P.Wo, Cin = P.Cin, Ce = P.Ce;
  const int nc = EXP ? (Cin + kCK - 1) / kCK : 0;
  const long long first = P.items * blockIdx.x / gridDim.x;
  const long long last = P.items * (blockIdx.x + 1) / gridDim.x;

  struct Item { int b, oy0, ox0, k0; long long tile; };
  auto decode = [&](long long it) {
    Item r;
    const long long rest = it / P.nch;
    r.k0 = (int)(it - rest * P.nch) * kKC;
    r.tile = rest;  // image * tiles + tile
    const int tile = (int)(rest % P.tiles);
    r.b = (int)(rest / P.tiles);
    r.oy0 = (tile / P.tiles_x) * kT;
    r.ox0 = (tile % P.tiles_x) * kT;
    return r;
  };
  // FULL: x's whole halo for the item's tile (zero past Cin and outside
  // the image).
  auto issue_halo = [&](const Item& it) {
    const int cpp = (Cin + 15) / 16 * 16 / E;
    for (int i = tid; i < PIN * cpp; i += kThreads) {
      const int p = i / cpp, c = i - p * cpp;
      const int iy = it.oy0 * S - 1 + p / TIN, ix = it.ox0 * S - 1 + p % TIN;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && c * E < Cin;
      cp_async16(ring_x + p * P.ldx + x_chunk<T>(p, c) * E,
                 ok ? (const void*)(x + (((size_t)it.b * H + iy) * W + ix) * Cin + c * E)
                    : P.x,
                 ok);
    }
  };
  // x's halo, channels [cc * kCK, +kCK) (zero past Cin).
  auto issue_x = [&](const Item& it, int cc, int slot) {
    constexpr int CPP = kCK / E;            // 16-byte copies per pixel
    T* dst = ring_x + (size_t)slot * PIN * kCK;
    for (int i = tid; i < PIN * CPP; i += kThreads) {
      const int p = i / CPP, c = i - p * CPP;
      const int iy = it.oy0 * S - 1 + p / TIN, ix = it.ox0 * S - 1 + p % TIN;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && cc * kCK + c * E < Cin;
      cp_async16(dst + p * kCK + ring_chunk<T>(p, c) * E,
                 ok ? (const void*)(x + (((size_t)it.b * H + iy) * W + ix) * Cin + cc * kCK +
                                    c * E)
                    : P.x,
                 ok);
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
    if (FULL) issue_halo(it);
    else if (EXP) issue_x(it, 0, 0);
    cp_commit();
    issue_stage(it);
    cp_commit();
  }
  int q = 0;  // ring chunks consumed so far
  long long prev_tile = -1;  // the tile whose halo is staged (FULL)
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column
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

    // A: the expand, e = round(x . W1), through the shared expand_step, the
    // m-tiles and n-tiles shared among the warps as in K9 (HaloTiling).
    if (EXP) {
      using HT = HaloTiling<PIN>;
      const int m0 = HT::m0(warp), n0 = HT::n0(warp);
      float acc[HT::UPW][HT::NPW][4];
#pragma unroll
      for (int u = 0; u < HT::UPW; ++u)
#pragma unroll
        for (int j = 0; j < HT::NPW; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[u][j][r] = 0.f;
      auto w_at = [&](int cc) {
        return [&, cc](int j) {
          return P.w1f + ((size_t)(it.k0 / 8 + n0 + j) * P.ksteps + cc) * Mma<T>::terms * 32;
        };
      };
      if constexpr (FULL) {
        // The halo of a new tile has landed (issued after the previous
        // item's expand); a tile's items all expand from it.
        if (it.tile != prev_tile) {
          cp_wait<0>();
          __syncthreads();
        }
        for (int cc = 0; cc < nc; ++cc) {
          uint32_t w[HT::NPW][Mma<T>::terms][2];
          halo_load_w<T, HT>(w, lane, w_at(cc));
          halo_expand_step<T, HT>(acc, m0, lane, w, [&](int r, int k) {
            k += 16 * cc;
            return r < PIN ? pair_at(ring_x, r, x_chunk<T>(r, k / E) * E + k % E, P.ldx)
                           : zero_pair<T>();
          });
        }
      } else {
        for (int cc = 0; cc < nc; ++cc, ++q) {
          // This chunk's W1 fragments load while the block waits for its x.
          uint32_t w[HT::NPW][Mma<T>::terms][2];
          halo_load_w<T, HT>(w, lane, w_at(cc));
          if (cc == 0) cp_wait<1>(); else cp_wait<0>();
          __syncthreads();
          if (cc + 1 < nc) issue_x(it, cc + 1, (q + 1) & 1);
          else if (has_next) issue_x(decode(item + 1), 0, (q + 1) & 1);
          cp_commit();
          const T* xs = ring_x + (size_t)(q & 1) * PIN * kCK;
          halo_expand_step<T, HT>(acc, m0, lane, w, [&](int r, int k) {
            return r < PIN ? pair_at(xs, r, ring_chunk<T>(r, k / E) * E + k % E, kCK)
                           : zero_pair<T>();
          });
        }
      }
#pragma unroll
      for (int u = 0; u < HT::UPW; ++u) {
        const int mt = m0 + 8 * u;
#pragma unroll
        for (int j = 0; j < HT::NPW; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * mt + g + 8 * h;
            if (mt >= HT::MT || r >= PIN) continue;
            const int cl = 8 * (n0 + j) + 2 * t4;
            const float e0 = round_to<T>(acc[u][j][2 * h]), e1 = round_to<T>(acc[u][j][2 * h + 1]);
            store_pair(ebuf + r * kKC + cl, e0, e1);
            const int hy = r / TIN, hx = r - hy * TIN;
            const int iy = it.oy0 * S - 1 + hy, ix = it.ox0 * S - 1 + hx;
            if (PROBE && hy >= 1 && hy <= kT * S && hx >= 1 && hx <= kT * S && iy < H &&
                ix < W)
              store_pair(P.probe + (((size_t)it.b * H + iy) * W + ix) * Ce + it.k0 + cl, e0, e1);
          }
      }
      if (FULL) cp_wait<0>();  // this item's stage
      else cp_wait<1>();  // this item's stage; the next item's first x chunk may fly
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (FULL) {
      // Every warp has expanded from the halo: the next tile's may load.
      const Item nx = has_next ? decode(item + 1) : it;
      if (nx.tile != it.tile) issue_halo(nx);
      cp_commit();
      prev_tile = it.tile;
    }

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

template <typename T, int S, bool EXP, bool FULL>
cudaError_t prepare(int ldx, int* per_sm, int* bytes) {
  using L = Layout<T, S, EXP, FULL>;
  *bytes = L::bytes(ldx);
  if (*bytes > kSmemBlock) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(dw_bwd_kernel<T, S, EXP, FULL, false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (e == cudaSuccess && EXP)
    e = cudaFuncSetAttribute(dw_bwd_kernel<T, S, EXP, FULL, EXP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, dw_bwd_kernel<T, S, EXP, FULL, false>, kThreads, *bytes);
}

// The whole halo once per tile (FULL) at stride 1, and at stride 2 where it
// still leaves two blocks an SM; else the ring.
template <typename T>
bool full_halo(int Cin, int stride) {
  return stride == 1 || Layout<T, 2, true, true>::bytes(row_ld(Cin, sizeof(T))) <= kSmemTwoBlocks;
}

template <typename T>
cudaError_t prepare_t(int Cin, int stride, int has_expand, int* per_sm, int* bytes) {
  const int ldx = row_ld(Cin, sizeof(T));
  if (!has_expand)
    return stride == 1 ? prepare<T, 1, false, false>(ldx, per_sm, bytes)
                       : prepare<T, 2, false, false>(ldx, per_sm, bytes);
  if (stride == 1) return prepare<T, 1, true, true>(ldx, per_sm, bytes);
  return full_halo<T>(Cin, 2) ? prepare<T, 2, true, true>(ldx, per_sm, bytes)
                              : prepare<T, 2, true, false>(ldx, per_sm, bytes);
}

// Blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the
// shared memory a block uses.
cudaError_t occupancy(int Cin, int stride, int has_expand, int dtype, int* per_sm, int* bytes) {
  if (dtype == 0) return prepare_t<float>(Cin, stride, has_expand, per_sm, bytes);
  if (dtype == 1) return prepare_t<__nv_bfloat16>(Cin, stride, has_expand, per_sm, bytes);
  return cudaErrorInvalidValue;
}

long long n_items(int B, int Ho, int Wo, int Ce) {
  return (long long)B * ((Ho + kT - 1) / kT) * ((Wo + kT - 1) / kT) * (Ce / kKC);
}

// Persistent grid: as many blocks as the SMs hold, at most one per item; or
// -(CUDA error).
long long grid_size(int B, int Ho, int Wo, int Cin, int Ce, int stride, int has_expand,
                    int dtype, int* bytes) {
  int per_sm = 0;
  const cudaError_t e = occupancy(Cin, stride, has_expand, dtype, &per_sm, bytes);
  if (e != cudaSuccess) return -(long long)e;
  if (per_sm <= 0) return -(long long)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -(long long)cudaErrorInvalidDevice;
  const long long items = n_items(B, Ho, Wo, Ce);
  const long long g = (long long)per_sm * sms;
  return items < g ? items : g;
}

template <typename T, int S, bool EXP, bool FULL>
cudaError_t run(const Params& p, int grid, int bytes, cudaStream_t s) {
  if (EXP && p.probe)
    dw_bwd_kernel<T, S, EXP, FULL, EXP><<<grid, kThreads, bytes, s>>>(p);
  else
    dw_bwd_kernel<T, S, EXP, FULL, false><<<grid, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int grid, int bytes, int stride, int has_expand,
                     cudaStream_t s) {
  if (!has_expand)
    return stride == 1 ? run<T, 1, false, false>(p, grid, bytes, s)
                       : run<T, 2, false, false>(p, grid, bytes, s);
  if (stride == 1) return run<T, 1, true, true>(p, grid, bytes, s);
  return full_halo<T>(p.Cin, 2) ? run<T, 2, true, true>(p, grid, bytes, s)
                                : run<T, 2, true, false>(p, grid, bytes, s);
}

}  // namespace

// Shared memory one block uses, or -(CUDA error) (cudaErrorInvalidValue:
// more than a block may have).
extern "C" int ir_train_dw_bwd_smem(int Cin, int stride, int has_expand, int dtype) {
  if (Cin <= 0 || (stride != 1 && stride != 2)) return -(int)cudaErrorInvalidValue;
  int per_sm = 0, bytes = 0;
  const cudaError_t e = occupancy(Cin, stride, has_expand, dtype, &per_sm, &bytes);
  return e == cudaSuccess || e == cudaErrorInvalidValue ? bytes : -(int)e;
}

// Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -(CUDA error).
extern "C" int ir_train_dw_bwd_occupancy(int Cin, int stride, int has_expand, int dtype) {
  if (Cin <= 0 || (stride != 1 && stride != 2)) return -(int)cudaErrorInvalidValue;
  int per_sm = 0, bytes = 0;
  const cudaError_t e = occupancy(Cin, stride, has_expand, dtype, &per_sm, &bytes);
  return e == cudaSuccess ? per_sm : -(int)e;
}

// Number of partial rows: the persistent grid's blocks, one row each; or
// -(CUDA error).
extern "C" int ir_train_dw_bwd_rows(int B, int Ho, int Wo, int Cin, int Ce, int stride,
                                    int has_expand, int dtype) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || Cin <= 0 || Ce <= 0 || Ce % kKC ||
      (stride != 1 && stride != 2))
    return -(int)cudaErrorInvalidValue;
  int bytes = 0;
  return (int)grid_size(B, Ho, Wo, Cin, Ce, stride, has_expand, dtype, &bytes);
}

// x [B, H, W, Cin], dv2 and d [B, Ho, Wo, Ce], dv1 [B, H, W, Ce] out, NHWC
// (dtype 0 = f32, 1 = bf16, all the same, 16-byte aligned); w1f W1's mma
// fragments (ops/ir_fused.py::mma_fragments, `ksteps` k-steps per n-tile)
// and s1/b1/m1/inv1 [Ce] f32 (unused, may be null, when has_expand is 0;
// then Ce == Cin); dw [9, Ce] f32 holding
// input-dtype values; u2/p2/q2/m2/inv2 [Ce] f32; part_dw [rows][9*Ce],
// part_a/part_b [rows][Ce] f32 (rows = ir_train_dw_bwd_rows); scratch
// [ceil(rows/rpg)][9*Ce] f32; ddw [9, Ce], ra/rb [Ce] f32 out; probe null,
// or [B, H, W, Ce] f32 that receives e (rounded to the input dtype) of
// every pixel. H and W even at stride 2 (Ho = H/2); Cin % 8 == 0, Ce % 32
// == 0.
extern "C" int ir_train_dw_bwd(const void* x, const void* w1f, const void* s1, const void* b1,
                               const void* m1, const void* inv1, const void* dw, const void* dv2,
                               const void* u2, const void* p2, const void* q2, const void* d,
                               const void* m2, const void* inv2, void* dv1, void* part_dw,
                               void* part_a, void* part_b, void* scratch, void* ddw, void* ra,
                               void* rb, void* probe, int B, int H, int W, int Ho, int Wo,
                               int Cin, int Ce, int ksteps, int stride, int has_expand, int rpg,
                               int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ce <= 0 || Cin % 8 || Ce % kKC ||
      (has_expand && (!w1f || ksteps * 16 < Cin)) ||
      (stride != 1 && stride != 2) || Ho * stride != H || Wo * stride != W ||
      (!has_expand && Ce != Cin) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  int bytes = 0;
  const long long grid = grid_size(B, Ho, Wo, Cin, Ce, stride, has_expand, dtype, &bytes);
  if (grid <= 0) return grid < 0 ? (int)-grid : (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  p.x = x;
  p.w1f = static_cast<const uint2*>(w1f);
  p.probe = static_cast<float*>(probe);
  p.ksteps = ksteps;
  p.ldx = row_ld(Cin, dtype == 0 ? 4 : 2);
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
  cudaError_t e = dtype == 0 ? dispatch<float>(p, (int)grid, bytes, stride, has_expand, s)
                             : dispatch<__nv_bfloat16>(p, (int)grid, bytes, stride, has_expand, s);
  if (e != cudaSuccess) return (int)e;
  float* sc = static_cast<float*>(scratch);
  e = sum_rows(p.part_dw, grid, 9LL * Ce, rpg, sc, static_cast<float*>(ddw), s);
  if (e != cudaSuccess) return (int)e;
  e = sum_rows(p.part_a, grid, Ce, rpg, sc, static_cast<float*>(ra), s);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(p.part_b, grid, Ce, rpg, sc, static_cast<float*>(rb), s);
}
