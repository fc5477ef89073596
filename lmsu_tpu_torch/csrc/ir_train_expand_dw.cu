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
// Design. A work item is (image, 8x8 output tile, 32 hidden channels),
// ordered image, tile, channel chunk (fastest). Persistent blocks, as many
// as the SMs hold (2-3 a SM), each walk a contiguous range of items. The
// input halo tile ((7s+3)^2 pixels, all Cin channels) is staged in shared
// memory once per tile and expanded from there for every chunk of the
// tile, so a block stages x once for its 6-24 consecutive chunks, not once
// per 32 channels. The expand runs on the tensor cores through the shared
// expand_step (ir_train_common.cuh), its m-tiles and n-tiles shared among
// the warps as K12 shares them (HaloTiling); e_act = round(relu6(round(e)
// * s1 + b1)) goes to shared memory (zero outside the image: the depthwise
// conv pads with zeros). When
// the tile's last chunk has been expanded, the next tile's halo starts
// loading (cp.async) while this chunk's depthwise runs. The depthwise taps
// stay on CUDA cores in registers (lane = channel, warp = output column;
// 18 multiply-adds an output). Each chunk's 64 outputs per channel reduce
// over the 8 warps in order and add to the block's own partial row in
// device memory (read and written by the same thread: no atomics);
// sum_rows adds the blocks' rows in a fixed order.
//
// Shared memory: the halo [pin][Cin] and e_act [pin][32] in the input dtype,
// XOR-swizzled by 16-byte chunk (x) or 8-element group (e_act) so that the
// fragment reads and the depthwise reads hit all banks: at the student's
// stages 2-5, 76.0 / 40.4 / 113.0 / 66.0 KB f32 and 57.5 / 21.2 / 57.5 /
// 34.0 KB bf16 a block (ir_train_expand_dw_smem), 2-3 blocks an SM. A halo
// wider than a block's shared memory is staged in 16-channel-aligned slices
// of Cin, restaged for every chunk (no model of the repo needs that).
//
// Bound on the H100: the products the design issues on the tensor cores,
// 2*B*H*W*Cin*Ce per product (6 products in f32: split operands; 1 in
// bf16) at 989 TFLOP/s, or the depthwise taps' 18 multiply-adds an output on
// CUDA cores (the larger; the two overlap), against reading x and writing d;
// bytes for the expansion-1 stage. The halo recompute adds (7s+3)^2/(8s)^2 - 1 of the
// expand work (56% at stride 1, 13% at stride 2).

#include "ir_train_common.cuh"

namespace {

using namespace irt;

constexpr int kEL = kKC;  // e_act row: the chunk's 32 channels

// Physical column of e_act column c in row r (8-element groups XOR-ed).
template <typename T> __device__ __forceinline__ int ea_col(int r, int c) {
  return sizeof(T) == 4 ? c ^ ((r & 3) << 3) : c ^ (((r >> 1) & 3) << 3);
}

struct Params {
  const void* x;
  const uint2* w1f;  // W1's fragments (ops/ir_fused.py::mma_fragments)
  const float* s1;
  const float* b1;
  const float* dw;   // [9][Ce]
  void* d;
  float* part_s;     // [grid][Ce]
  float* part_q;     // [grid][Ce]
  float* probe;      // [B][H][W][Ce] f32 e of every tile's own pixels, or null
  int H, W, Ho, Wo, Cin, Ce, tiles_x, tiles, nch;
  int kx;            // channels of x staged at once: a multiple of 16
  int ldx;           // elements per staged halo row
  int ksteps;        // k-steps per n-tile in w1f
  long long items;
};

template <typename T, int S>
constexpr int pin_of() { return (S * (kT - 1) + 3) * (S * (kT - 1) + 3); }

template <typename T, int S>
size_t smem_of(bool exp, int ldx) {
  constexpr int PIN = pin_of<T, S>();
  return (exp ? (size_t)PIN * ldx * sizeof(T) : 0) + (size_t)PIN * kEL * sizeof(T) +
         2 * 8 * kKC * sizeof(float);
}

// PROBE (chip_smoke.py's check of e against K12) also writes e to P.probe;
// the main path's build has no trace of it.
template <typename T, int S, bool EXP, bool PROBE>
__global__ void __launch_bounds__(kThreads, S == 1 ? 3 : 2)
expand_dw_kernel(const Params P) {
  constexpr int TIN = S * (kT - 1) + 3, PIN = TIN * TIN;
  constexpr int E = 16 / (int)sizeof(T);  // elements a 16-byte copy
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* xs = reinterpret_cast<T*>(smem);                                     // [PIN][ldx]
  T* ea = reinterpret_cast<T*>(smem + (EXP ? (size_t)PIN * P.ldx * sizeof(T) : 0));
  float* red = reinterpret_cast<float*>(reinterpret_cast<char*>(ea) + PIN * kEL * sizeof(T));

  const T* __restrict__ x = static_cast<const T*>(P.x);
  T* __restrict__ dout = static_cast<T*>(P.d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int H = P.H, W = P.W, Cin = P.Cin, Ce = P.Ce;
  const int nslice = EXP ? (Cin + P.kx - 1) / P.kx : 0;
  const long long first = P.items * blockIdx.x / gridDim.x;
  const long long last = P.items * (blockIdx.x + 1) / gridDim.x;

  struct Item { int b, tile, oy0, ox0, k0; };
  auto decode = [&](long long it) {
    Item r;
    const long long rest = it / P.nch;
    r.k0 = (int)(it - rest * P.nch) * kKC;
    r.tile = (int)(rest % P.tiles);
    r.b = (int)(rest / P.tiles);
    r.oy0 = (r.tile / P.tiles_x) * kT;
    r.ox0 = (r.tile % P.tiles_x) * kT;
    return r;
  };
  // x's halo, channels [sl * kx, +kx) (zero past Cin and outside the image).
  auto issue_x = [&](const Item& it, int sl) {
    const int c0 = sl * P.kx;
    const int cw = min(P.kx, Cin - c0);
    const int cpp = (cw + 15) / 16 * 16 / E;  // 16-byte copies a row
    for (int i = tid; i < PIN * cpp; i += kThreads) {
      const int p = i / cpp, c = i - p * cpp;
      const int iy = it.oy0 * S - 1 + p / TIN, ix = it.ox0 * S - 1 + p % TIN;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && c0 + c * E < Cin;
      cp_async16(xs + p * P.ldx + x_chunk<T>(p, c) * E,
                 ok ? (const void*)(x + (((size_t)it.b * H + iy) * W + ix) * Cin + c0 + c * E)
                    : P.x,
                 ok);
    }
  };
  // Expansion 1: e_act is x's halo itself, channels [k0, k0 + 32).
  auto issue_e = [&](const Item& it) {
    constexpr int CPP = kEL / E;
    for (int i = tid; i < PIN * CPP; i += kThreads) {
      const int p = i / CPP, c = i - p * CPP;
      const int iy = it.oy0 * S - 1 + p / TIN, ix = it.ox0 * S - 1 + p % TIN;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && it.k0 + c * E < Ce;
      cp_async16(ea + p * kEL + ea_col<T>(p, c * E),
                 ok ? (const void*)(x + (((size_t)it.b * H + iy) * W + ix) * Cin + it.k0 + c * E)
                    : P.x,
                 ok);
    }
  };

  float* row_s = P.part_s + (size_t)blockIdx.x * Ce;
  float* row_q = P.part_q + (size_t)blockIdx.x * Ce;
  for (int i = tid; i < 2 * Ce; i += kThreads) (i < Ce ? row_s : row_q - Ce)[i] = 0.f;
  if (first >= last) return;
  if (EXP && nslice == 1) issue_x(decode(first), 0);
  cp_commit();

  long long prev_tile = -1;
  for (long long item = first; item < last; ++item) {
    const Item it = decode(item);
    const long long tile_id = (long long)it.b * P.tiles + it.tile;
    const bool has_next = item + 1 < last;
    __syncthreads();  // the previous item's e_act and sums consumed

    if (EXP) {
      if (nslice == 1 && tile_id != prev_tile) {
        cp_wait<0>();
        __syncthreads();
      }
      // e for this chunk over the halo (HaloTiling).
      using HT = HaloTiling<PIN>;
      const int m0 = HT::m0(warp), n0 = HT::n0(warp);
      float acc[HT::UPW][HT::NPW][4];
#pragma unroll
      for (int u = 0; u < HT::UPW; ++u)
#pragma unroll
        for (int j = 0; j < HT::NPW; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[u][j][r] = 0.f;
      for (int sl = 0; sl < nslice; ++sl) {
        if (nslice > 1) {
          __syncthreads();
          issue_x(it, sl);
          cp_commit();
          cp_wait<0>();
          __syncthreads();
        }
        const int ks_n = (min(P.kx, Cin - sl * P.kx) + 15) / 16;
        for (int ks = 0; ks < ks_n; ++ks) {
          const int kg = sl * (P.kx / 16) + ks;  // k-step of W1
          uint32_t w[HT::NPW][Mma<T>::terms][2];
          halo_load_w<T, HT>(w, lane, [&](int j) {
            return P.w1f + ((size_t)(it.k0 / 8 + n0 + j) * P.ksteps + kg) * Mma<T>::terms * 32;
          });
          halo_expand_step<T, HT>(acc, m0, lane, w, [&](int r, int k) {
            k += 16 * ks;
            return r < PIN ? pair_at(xs, r, x_chunk<T>(r, k / E) * E + k % E, P.ldx)
                           : zero_pair<T>();
          });
        }
      }
      // e_act (and the probe's e) for the warp's fragments.
#pragma unroll
      for (int j = 0; j < HT::NPW; ++j) {
        const int cl = 8 * (n0 + j) + 2 * t, c = it.k0 + cl;
        const float sc0 = c < Ce ? P.s1[c] : 0.f, bc0 = c < Ce ? P.b1[c] : 0.f;
        const float sc1 = c + 1 < Ce ? P.s1[c + 1] : 0.f, bc1 = c + 1 < Ce ? P.b1[c + 1] : 0.f;
#pragma unroll
        for (int u = 0; u < HT::UPW; ++u) {
          const int mt = m0 + 8 * u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * mt + g + 8 * h;
            if (mt >= HT::MT || r >= PIN) continue;
            const int hy = r / TIN, hx = r - hy * TIN;
            const int iy = it.oy0 * S - 1 + hy, ix = it.ox0 * S - 1 + hx;
            const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
            const float e0 = round_to<T>(acc[u][j][2 * h]), e1 = round_to<T>(acc[u][j][2 * h + 1]);
            store_pair(ea + r * kEL + ea_col<T>(r, cl),
                       inside && c < Ce ? relu6(scale_shift(e0, sc0, bc0)) : 0.f,
                       inside && c + 1 < Ce ? relu6(scale_shift(e1, sc1, bc1)) : 0.f);
            if (PROBE && inside && hy >= 1 && hy <= kT * S && hx >= 1 && hx <= kT * S) {
              float* pr = P.probe + (((size_t)it.b * H + iy) * W + ix) * Ce + c;
              if (c < Ce) pr[0] = e0;
              if (c + 1 < Ce) pr[1] = e1;
            }
          }
        }
      }
    } else {
      issue_e(it);
      cp_commit();
      cp_wait<0>();
    }
    __syncthreads();
    // The halo is free: the next tile's starts loading.
    if (EXP && nslice == 1 && has_next) {
      const Item nx = decode(item + 1);
      if ((long long)nx.b * P.tiles + nx.tile != tile_id) issue_x(nx, 0);
      cp_commit();
    }
    prev_tile = tile_id;

    // Depthwise: lane = channel, warp = output column of the tile.
    const int c = it.k0 + lane;
    float tap[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) tap[k] = c < Ce ? P.dw[k * Ce + c] : 0.f;
    float s = 0.f, q = 0.f;
    const int ox = it.ox0 + warp;
#pragma unroll
    for (int qy = 0; qy < kT; ++qy) {
      float a = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int r = (qy * S + ky) * TIN + warp * S + kx;
          a = fmaf(to_f(ea[r * kEL + ea_col<T>(r, lane)]), tap[ky * 3 + kx], a);
        }
      const int oy = it.oy0 + qy;
      if (oy < P.Ho && ox < P.Wo && c < Ce) {
        const T v = from_f<T>(a);
        dout[(((size_t)it.b * P.Ho + oy) * P.Wo + ox) * Ce + c] = v;
        const float dv = to_f(v);
        s += dv;
        q = fmaf(dv, dv, q);
      }
    }
    red[warp * kKC + lane] = s;
    red[(8 + warp) * kKC + lane] = q;
    __syncthreads();
    if (tid < 2 * kKC && it.k0 + (tid % kKC) < Ce) {
      const int which = tid / kKC, l = tid % kKC;
      float sum = 0.f;
#pragma unroll
      for (int w8 = 0; w8 < 8; ++w8) sum += red[(which * 8 + w8) * kKC + l];
      float* row = (which ? row_q : row_s) + it.k0 + l;
      *row = *row + sum;
    }
  }
  cp_wait<0>();
}

// kx and the row width of the staged halo: all of Cin when it fits in a
// block's shared memory, else the widest multiple of 16 that does.
template <typename T, int S>
void choose_kx(int Cin, bool exp, int* kx, int* ldx) {
  *kx = (Cin + 15) / 16 * 16;
  *ldx = row_ld(*kx, sizeof(T));
  while (exp && *kx > 16 && smem_of<T, S>(exp, *ldx) > (size_t)kSmemBlock) {
    *kx -= 16;
    *ldx = row_ld(*kx, sizeof(T));
  }
}

template <typename T, int S, bool EXP>
cudaError_t prepare(int Cin, int* per_sm, size_t* smem, int* kx, int* ldx) {
  choose_kx<T, S>(Cin, EXP, kx, ldx);
  *smem = smem_of<T, S>(EXP, *ldx);
  cudaError_t e = cudaFuncSetAttribute(expand_dw_kernel<T, S, EXP, false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (e == cudaSuccess && EXP)
    e = cudaFuncSetAttribute(expand_dw_kernel<T, S, EXP, EXP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, expand_dw_kernel<T, S, EXP, false>,
                                                       kThreads, *smem);
}

template <typename T>
cudaError_t prepare_t(int stride, int has_expand, int Cin, int* per_sm, size_t* smem, int* kx,
                      int* ldx) {
  if (stride == 1)
    return has_expand ? prepare<T, 1, true>(Cin, per_sm, smem, kx, ldx)
                      : prepare<T, 1, false>(Cin, per_sm, smem, kx, ldx);
  return has_expand ? prepare<T, 2, true>(Cin, per_sm, smem, kx, ldx)
                    : prepare<T, 2, false>(Cin, per_sm, smem, kx, ldx);
}

struct Launch {
  int per_sm = 0, kx = 0, ldx = 0;
  size_t smem = 0;
  long long grid = 0;
};

long long n_items(int B, int Ho, int Wo, int Ce) {
  return (long long)B * ((Ho + kT - 1) / kT) * ((Wo + kT - 1) / kT) * ((Ce + kKC - 1) / kKC);
}

cudaError_t plan(int B, int Ho, int Wo, int Cin, int Ce, int stride, int has_expand, int dtype,
                 Launch* L) {
  cudaError_t e = dtype == 0
      ? prepare_t<float>(stride, has_expand, Cin, &L->per_sm, &L->smem, &L->kx, &L->ldx)
      : prepare_t<__nv_bfloat16>(stride, has_expand, Cin, &L->per_sm, &L->smem, &L->kx,
                                 &L->ldx);
  if (e != cudaSuccess) return e;
  if (L->per_sm <= 0) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long items = n_items(B, Ho, Wo, Ce), g = (long long)L->per_sm * sms;
  L->grid = items < g ? items : g;
  return cudaSuccess;
}

template <typename T>
cudaError_t run(const Params& p, const Launch& L, int stride, int has_expand, cudaStream_t s) {
  const dim3 grid((unsigned)L.grid);
  const bool pr = p.probe != nullptr;
  if (stride == 1) {
    if (!has_expand) expand_dw_kernel<T, 1, false, false><<<grid, kThreads, L.smem, s>>>(p);
    else if (pr) expand_dw_kernel<T, 1, true, true><<<grid, kThreads, L.smem, s>>>(p);
    else expand_dw_kernel<T, 1, true, false><<<grid, kThreads, L.smem, s>>>(p);
  } else {
    if (!has_expand) expand_dw_kernel<T, 2, false, false><<<grid, kThreads, L.smem, s>>>(p);
    else if (pr) expand_dw_kernel<T, 2, true, true><<<grid, kThreads, L.smem, s>>>(p);
    else expand_dw_kernel<T, 2, true, false><<<grid, kThreads, L.smem, s>>>(p);
  }
  return cudaGetLastError();
}

bool bad_args(int B, int H, int W, int Ho, int Wo, int Cin, int Ce, int stride, int has_expand,
              int dtype) {
  return B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ce <= 0 || Cin % 8 ||
         (stride != 1 && stride != 2) || Ho * stride != H || Wo * stride != W ||
         (!has_expand && Ce != Cin) || (dtype != 0 && dtype != 1);
}

}  // namespace

// Shared memory one block uses, or -(CUDA error).
extern "C" int ir_train_expand_dw_smem(int Cin, int stride, int has_expand, int dtype) {
  Launch L;
  if (bad_args(1, 2, 2, 2 / stride, 2 / stride, Cin, has_expand ? 8 : Cin, stride, has_expand,
               dtype))
    return -(int)cudaErrorInvalidValue;
  const cudaError_t e = dtype == 0
      ? prepare_t<float>(stride, has_expand, Cin, &L.per_sm, &L.smem, &L.kx, &L.ldx)
      : prepare_t<__nv_bfloat16>(stride, has_expand, Cin, &L.per_sm, &L.smem, &L.kx, &L.ldx);
  return e == cudaSuccess ? (int)L.smem : -(int)e;
}

// Resident blocks per SM, or -(CUDA error).
extern "C" int ir_train_expand_dw_occupancy(int Cin, int stride, int has_expand, int dtype) {
  Launch L;
  if (bad_args(1, 2, 2, 2 / stride, 2 / stride, Cin, has_expand ? 8 : Cin, stride, has_expand,
               dtype))
    return -(int)cudaErrorInvalidValue;
  const cudaError_t e = dtype == 0
      ? prepare_t<float>(stride, has_expand, Cin, &L.per_sm, &L.smem, &L.kx, &L.ldx)
      : prepare_t<__nv_bfloat16>(stride, has_expand, Cin, &L.per_sm, &L.smem, &L.kx, &L.ldx);
  return e == cudaSuccess ? L.per_sm : -(int)e;
}

// Number of per-block partial rows (the persistent grid), or -(CUDA error).
extern "C" int ir_train_expand_dw_rows(int B, int H, int W, int Cin, int Ce, int stride,
                                       int has_expand, int dtype) {
  if (stride != 1 && stride != 2) return -(int)cudaErrorInvalidValue;
  const int Ho = H / stride, Wo = W / stride;
  if (bad_args(B, H, W, Ho, Wo, Cin, Ce, stride, has_expand, dtype))
    return -(int)cudaErrorInvalidValue;
  Launch L;
  const cudaError_t e = plan(B, Ho, Wo, Cin, Ce, stride, has_expand, dtype, &L);
  return e == cudaSuccess ? (int)L.grid : -(int)e;
}

// x [B, H, W, Cin] and d [B, Ho, Wo, Ce] NHWC (dtype 0 = f32, 1 = bf16,
// 16-byte aligned); w1f W1's mma fragments (ops/ir_fused.py::mma_fragments,
// `ksteps` k-steps per n-tile, n-tiles for at least ceil(Ce / 32) * 32
// channels) and s1/b1 [Ce] f32 (unused, may be null, when has_expand is 0;
// then Ce == Cin); dw [9, Ce] f32 holding input-dtype values; part_s/part_q
// [rows][Ce] f32 (rows = ir_train_expand_dw_rows); scratch
// [ceil(rows/rpg)][Ce] f32; sum/sq [Ce] f32 out; probe null, or [B, H, W,
// Ce] f32 that receives e (rounded to the input dtype) of every pixel.
// Cin % 8 == 0; stride 1 or 2 with H, W multiples of it.
extern "C" int ir_train_expand_dw(const void* x, const void* w1f, const void* s1, const void* b1,
                                  const void* dw, void* d, void* part_s, void* part_q,
                                  void* scratch, void* sum, void* sq, void* probe, int B, int H,
                                  int W, int Cin, int Ce, int ksteps, int stride, int has_expand,
                                  int rpg, int dtype, void* stream) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  const int Ho = H / stride, Wo = W / stride;
  if (bad_args(B, H, W, Ho, Wo, Cin, Ce, stride, has_expand, dtype) ||
      (has_expand && (!w1f || ksteps * 16 < Cin)))
    return (int)cudaErrorInvalidValue;
  Launch L;
  cudaError_t e = plan(B, Ho, Wo, Cin, Ce, stride, has_expand, dtype, &L);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  p.x = x;
  p.w1f = static_cast<const uint2*>(w1f);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.dw = static_cast<const float*>(dw);
  p.d = d;
  p.part_s = static_cast<float*>(part_s);
  p.part_q = static_cast<float*>(part_q);
  p.probe = static_cast<float*>(probe);
  p.H = H; p.W = W; p.Ho = Ho; p.Wo = Wo; p.Cin = Cin; p.Ce = Ce;
  p.tiles_x = (Wo + kT - 1) / kT;
  p.tiles = p.tiles_x * ((Ho + kT - 1) / kT);
  p.nch = (Ce + kKC - 1) / kKC;
  p.kx = L.kx;
  p.ldx = L.ldx;
  p.ksteps = ksteps;
  p.items = n_items(B, Ho, Wo, Ce);
  e = dtype == 0 ? run<float>(p, L, stride, has_expand, s)
                 : run<__nv_bfloat16>(p, L, stride, has_expand, s);
  if (e != cudaSuccess) return (int)e;
  e = sum_rows(p.part_s, L.grid, Ce, rpg, static_cast<float*>(scratch), static_cast<float*>(sum),
               s);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(p.part_q, L.grid, Ce, rpg, static_cast<float*>(scratch),
                       static_cast<float*>(sq), s);
}
