// Fused InvertedResidual training, pass 1: the batch statistics of the
// expand 1x1 output, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/ir_fused.py::_stats1_kernel
// (launched from _ir_train_forward once per 128-lane chunk of the hidden
// dim, grid (B,), sums carried in VMEM scratch across the grid):
//
//   e = (x . W1) rounded to the input dtype   (never stored)
//   sum[c] = sum_p e[p, c],  sq[c] = sum_p e[p, c]^2   (f32)
//
// x [M, Cin] (M = B*H*W pixels, NHWC) in f32 or bf16; W1 [Cin, Ce] as the
// pre-split mma fragments of its input-dtype values
// (ops/ir_fused.py::mma_fragments, the array K9 and K12 read). One launch
// covers every hidden channel.
//
// Design. e comes from the shared expand's arithmetic (expand_step of
// ir_train_common.cuh, mma.sync.m16n8k16 bf16 -> f32: f32 operands as three
// bf16 terms, six products into a fresh accumulator per 16-channel k-step,
// k-steps in increasing order from zero; bf16 one exact product), issued
// for a warp's eight tiles at once (mma_step_tiles, the same products per
// tile), so it is the e that K9 normalises and K12 recomputes, bit for bit
// (chip_smoke.py compares K8's probe with K9's). A block owns tiles of 128
// pixels, in order, and walks all of Ce for each, so x crosses device
// memory once: a tile of x is staged once in shared memory (cp.async, the
// x_chunk swizzle K9 uses) and serves every hidden channel. Ce is walked in
// passes of 8 n-tiles (64 channels; W1's fragments pad Ce to 64); 8 warps
// as 4 (pixels) x 2 (channels), each warp 32 pixels x 32 channels (2 x 4
// mma tiles). A block whose 128-pixel tile does not fit shared memory (Cin
// 320 in f32, wider than any stage of the student or the 2x teacher) takes
// 64-pixel tiles with 8 warps as 2 x 4 and passes of 128 channels. W1's
// fragments for one k-chunk of a pass (2 k-steps f32, 4 bf16) ride a
// two-slot cp.async ring. Epilogue per pass: round_to<T>, then
// per channel the sum and the sum of squares of the warp's 32 pixels (each
// lane's 4 rows in order, then a fixed reduce-scatter over the 8 lanes of a
// column, column_sums), added to the warp's row of a shared-memory
// accumulator. At the end the 4 pixel warps' rows are added in order into
// the block's one partial row, and sum_rows adds the partial rows in a
// fixed order. The grid (at most kMaxBlocks, each a contiguous range of
// tiles) depends on M alone, so the sums depend on the sizes alone. No
// float atomics. Two blocks share an SM (112 KB of shared memory at the
// student's last stage in f32).
//
// Bound on the H100: the products the design issues on the tensor cores,
// 2*M*Cin*Ce per product (6 in f32, 1 in bf16) at 989 TFLOP/s: 0.157 ms
// at B=128 for each of the student's stages 2-5 in f32; in bf16 0.026 ms,
// below reading x (0.010-0.040 ms), beside the epilogue's rounding, squares
// and sums on CUDA cores (chip_smoke.py counts both). mma.sync reaches about
// half the 989 TFLOP/s that wgmma can, so the f32 kernel can come no closer
// than about twice its bound; in bf16 the epilogue's CUDA-core work per
// element is of the order of the product's.

#include "ir_train_common.cuh"

namespace {

using namespace irt;

constexpr int kMaxBlocks = 1056;  // grid cap: partial rows, fixed by the sizes alone

// Tile shapes: WM pixel warps x (8 / WM) channel warps, each warp 32 pixels
// x 32 channels: 128 pixels and passes of 8 n-tiles (64 channels) at WM = 4,
// 64 pixels and passes of 16 n-tiles (128 channels) at WM = 2, for blocks
// whose 128-pixel tile does not fit shared memory.
__host__ __device__ constexpr int bm_of(int wm) { return 32 * wm; }
__host__ __device__ constexpr int pass_of(int wm) { return 32 / wm; }

// k-steps of W1 a ring slot holds.
template <typename T> __host__ __device__ constexpr int kc_of() { return sizeof(T) == 4 ? 2 : 4; }

struct Params {
  const void* x;
  const uint2* w1f;  // [np8][ksteps][terms][32] uint2
  float* part_s;     // [grid][Ce]
  float* part_q;     // [grid][Ce]
  float* probe;      // [M][Ce] f32 e, or null
  long long M;
  int Cin, Ce, ksteps, np8, ldx, tiles;
};

// Shared memory: the x tile [BM][ldx] of T, the W1 ring [2][pass n-tiles]
// [kc][terms][32] uint2, the accumulators [WM pixel warps][2][Ce] f32.
template <typename T>
size_t smem_of(int Cin, int Ce, int wm) {
  const int terms = sizeof(T) == 4 ? kTerms : 1;
  return (size_t)bm_of(wm) * row_ld(Cin, sizeof(T)) * sizeof(T) +
         2 * (size_t)pass_of(wm) * kc_of<T>() * terms * 256 + (size_t)wm * 2 * Ce * sizeof(float);
}

// 128-pixel tiles where they fit a block's shared memory, else 64; 0 if
// neither does.
template <typename T>
int wm_of(int Cin, int Ce) {
  return smem_of<T>(Cin, Ce, 4) <= (size_t)kSmemBlock ? 4
         : smem_of<T>(Cin, Ce, 2) <= (size_t)kSmemBlock ? 2 : 0;
}

// v[j][0..3] (sum c, sum c + 1, sq c, sq c + 1 of n-tile j, over this
// lane's rows) summed over the 8 lanes of a column (lanes 4g + t, g = 0..7)
// by a reduce-scatter: after halving over lane bits 4, 3 and 2, lane g
// holds n-tile j = g >> 1's sums (g even) or squares (g odd) for its two
// columns. The order of the additions is fixed.
__device__ __forceinline__ void column_sums(const float (&v)[4][4], float (&z)[2], int lane) {
  const bool b2 = lane & 16, b1 = lane & 8, b0 = lane & 4;
  float w[2][4];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float keep = b2 ? v[jj + 2][r] : v[jj][r];
      const float send = b2 ? v[jj][r] : v[jj + 2][r];
      w[jj][r] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
  float u[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float keep = b1 ? w[1][r] : w[0][r];
    const float send = b1 ? w[0][r] : w[1][r];
    u[r] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float keep = b0 ? u[r + 2] : u[r];
    const float send = b0 ? u[r] : u[r + 2];
    z[r] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
}

// PROBE (chip_smoke.py's check of e against K9) also writes e to P.probe;
// the main path's build has no trace of it.
template <typename T, int WM, bool PROBE>
__global__ void __launch_bounds__(kThreads, 2)
stats1_kernel(const Params P) {
  constexpr int NT = Mma<T>::terms;
  constexpr int KC = kc_of<T>();
  constexpr int BM = bm_of(WM), WN = 8 / WM, PN = pass_of(WM);
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int PER_NT = KC * NT * 16;                // 16-byte pieces of an n-tile's chunk
  constexpr int WSLOT = PN * KC * NT * 32;        // uint2 a ring slot
  constexpr int WCOPIES = PN * PER_NT / kThreads;  // pieces a thread copies an item
  static_assert(PN * PER_NT % kThreads == 0, "ring slot copies");
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* xs = reinterpret_cast<T*>(smem);
  uint2* ws = reinterpret_cast<uint2*>(smem + (size_t)BM * P.ldx * sizeof(T));
  float* acc_sm = reinterpret_cast<float*>(ws + 2 * WSLOT);  // [WM][2][Ce]

  const T* __restrict__ x = static_cast<const T*>(P.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int Cin = P.Cin, Ce = P.Ce;
  const int ks_n = (Cin + 15) / 16;             // k-steps walked (as K9)
  const int nchunk = (ks_n + KC - 1) / KC;      // ring items a pass
  const int npass = (Ce + 8 * PN - 1) / (8 * PN);
  const int t0 = (int)((long long)P.tiles * blockIdx.x / gridDim.x);
  const int t1 = (int)((long long)P.tiles * (blockIdx.x + 1) / gridDim.x);
  const int items = (t1 - t0) * npass * nchunk;

  for (int i = tid; i < 2 * WM * Ce; i += kThreads) acc_sm[i] = 0.f;

  // x rows of tile tl (zero past M and Cin).
  auto issue_x = [&](int tl) {
    const long long m0 = (long long)tl * BM;
    const int cpp = (Cin + 15) / 16 * 16 / E;  // 16-byte copies a row
    for (int i = tid; i < BM * cpp; i += kThreads) {
      const int r = i / cpp, c = i - r * cpp;
      const bool ok = m0 + r < P.M && c * E < Cin;
      cp_async16(xs + r * P.ldx + x_chunk<T>(r, c) * E,
                 ok ? (const void*)(x + (m0 + r) * Cin + c * E) : P.x, ok);
    }
  };
  // This thread's pieces of a ring slot: n-tile j, k-step kk of the chunk.
  int w_j[WCOPIES], w_src[WCOPIES], w_dst[WCOPIES], w_kk[WCOPIES];
#pragma unroll
  for (int u = 0; u < WCOPIES; ++u) {
    const int i = tid + u * kThreads, j = i / PER_NT, pc = i - j * PER_NT;
    w_j[u] = j;
    w_src[u] = j * P.ksteps * NT * 32 + 2 * pc;
    w_dst[u] = j * KC * NT * 32 + 2 * pc;
    w_kk[u] = pc / (NT * 16);
  }
  // Pass p's PN n-tiles (zeros past the fragment array, which pads N to a
  // multiple of 64) and chunk q's k-steps of W1's fragments into slot s.
  auto issue_w = [&](int p, int q, int s) {
    const uint2* src = P.w1f + ((size_t)p * PN * P.ksteps + (size_t)q * KC) * NT * 32;
    uint2* dst = ws + (size_t)s * WSLOT;
    const int kn = min(KC, ks_n - q * KC);
#pragma unroll
    for (int u = 0; u < WCOPIES; ++u) {
      const bool ok = WM == 4 || p * PN + w_j[u] < P.np8;  // 128-pixel tiles: always inside
      if (w_kk[u] < kn) cp_async16(dst + w_dst[u], ok ? src + w_src[u] : P.w1f, ok);
    }
  };

  // The thread's rows of the x tile (rows 32 wm + 16 mt + g + 8 h all share
  // g's swizzle, x_chunk<T>(g, c)).
  const T* xrow[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) xrow[mt][h] = xs + (32 * wm + 16 * mt + g + 8 * h) * P.ldx;

  float acc[2][4][4];
  if (items > 0) {
    issue_x(t0);
    issue_w(0, 0, 0);
  }
  cp_commit();
  int tl = t0, p = 0, q = 0;     // this item: tile, pass, chunk
  int pn = 0, qn = 0;            // the next item's pass and chunk
  for (int it = 0; it < items; ++it) {
    if (++qn == nchunk) {
      qn = 0;
      if (++pn == npass) pn = 0;
    }
    cp_wait<0>();
    __syncthreads();  // item it landed; every warp is done with item it - 1's slot
    if (it + 1 < items) issue_w(pn, qn, (it + 1) & 1);
    cp_commit();

    if (q == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0.f;
    }
    const uint2* wt = ws + (size_t)(it & 1) * WSLOT + (size_t)4 * wn * KC * NT * 32;
    const int kn = min(KC, ks_n - q * KC);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      if (kk >= kn) break;
      const int k0 = 16 * (q * KC + kk) + 2 * t;
      uint32_t a[2][NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        typename Mma<T>::Pair xa[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int k = k0 + 8 * (f >> 1);
          xa[f] = pair_at(xrow[mt][f & 1], 0, x_chunk<T>(g, k / E) * E + k % E, 0);
        }
        terms_of(a[mt], xa);
      }
      uint32_t b[4][NT][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) smem_b<T>(b[j], wt + (size_t)(j * KC + kk) * NT * 32, lane);
      // expand_step's arithmetic on each of the warp's tiles.
      mma_step_tiles<NT, NT, 2, 4>(acc, a, b);
    }

    if (q == nchunk - 1) {
      // Epilogue of the pass: e rounded, per channel the warp's sums.
      const int cb = 8 * (p * PN + 4 * wn) + 2 * t;  // column of n-tile 0
      const long long m0 = (long long)tl * BM + 32 * wm;
      float v[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cb + 8 * j;
#pragma unroll
        for (int r = 0; r < 4; ++r) v[j][r] = 0.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float e0 = round_to<T>(acc[mt][j][2 * h]);
            const float e1 = round_to<T>(acc[mt][j][2 * h + 1]);
            v[j][0] += e0;
            v[j][1] += e1;
            v[j][2] = fmaf(e0, e0, v[j][2]);
            v[j][3] = fmaf(e1, e1, v[j][3]);
            if (PROBE) {
              const long long row = m0 + 16 * mt + g + 8 * h;
              if (row < P.M) {
                float* pr = P.probe + row * Ce + c;
                if (c < Ce) pr[0] = e0;
                if (c + 1 < Ce) pr[1] = e1;
              }
            }
          }
      }
      // Channels past Ce hold zeros (W1's fragments are zero there).
      float z[2];
      column_sums(v, z, lane);
      const int c = cb + 8 * (g >> 1);
      float* as = acc_sm + (size_t)wm * 2 * Ce + (g & 1) * Ce;
      if (c < Ce) as[c] += z[0];
      if (c + 1 < Ce) as[c + 1] += z[1];
      if (p == npass - 1 && tl + 1 < t1) {
        // The tile is done: the next one's x replaces it (one buffer;
        // another block resident on the SM computes meanwhile).
        __syncthreads();
        issue_x(tl + 1);
        cp_commit();
      }
    }
    if (++q == nchunk) {
      q = 0;
      if (++p == npass) {
        p = 0;
        ++tl;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * Ce; i += kThreads) {
    const int which = i / Ce, c = i - which * Ce;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WM; ++w) s += acc_sm[(size_t)w * 2 * Ce + i];
    (which ? P.part_q : P.part_s)[(size_t)blockIdx.x * Ce + c] = s;
  }
}

int grid_of(long long M, int wm) {
  const long long tiles = (M + bm_of(wm) - 1) / bm_of(wm);
  return (int)(tiles < kMaxBlocks ? tiles : kMaxBlocks);
}

template <typename T, int WM, bool PROBE>
cudaError_t prepare(int Cin, int Ce, size_t* smem) {
  *smem = smem_of<T>(Cin, Ce, WM);
  return cudaFuncSetAttribute(stats1_kernel<T, WM, PROBE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <typename T, int WM, bool PROBE>
int launch(const Params& P0, float* scratch, float* sum, float* sq, int rpg, cudaStream_t s) {
  size_t smem = 0;
  cudaError_t e = prepare<T, WM, PROBE>(P0.Cin, P0.Ce, &smem);
  if (e != cudaSuccess) return (int)e;
  Params P = P0;
  P.ldx = row_ld(P.Cin, sizeof(T));
  P.tiles = (int)((P.M + bm_of(WM) - 1) / bm_of(WM));
  const int grid = grid_of(P.M, WM);
  stats1_kernel<T, WM, PROBE><<<grid, kThreads, smem, s>>>(P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = sum_rows(P.part_s, grid, P.Ce, rpg, scratch, sum, s);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(P.part_q, grid, P.Ce, rpg, scratch, sq, s);
}

template <typename T, bool PROBE>
int launch_t(const Params& P, float* scratch, float* sum, float* sq, int rpg, cudaStream_t s) {
  switch (wm_of<T>(P.Cin, P.Ce)) {
    case 4: return launch<T, 4, PROBE>(P, scratch, sum, sq, rpg, s);
    case 2: return launch<T, 2, PROBE>(P, scratch, sum, sq, rpg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int occupancy_t(int Cin, int Ce) {
  size_t smem = 0;
  int per_sm = 0;
  const int wm = wm_of<T>(Cin, Ce);
  cudaError_t e = wm == 4 ? prepare<T, 4, false>(Cin, Ce, &smem)
                  : wm == 2 ? prepare<T, 2, false>(Cin, Ce, &smem) : cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wm == 4 ? (const void*)stats1_kernel<T, 4, false>
                         : (const void*)stats1_kernel<T, 2, false>,
        kThreads, smem);
  return e == cudaSuccess ? per_sm : -(int)e;
}

}  // namespace

// Tile rows for these widths and dtype (0 = f32, 1 = bf16; 0 rows: no
// tile fits), and the number of per-block partial rows for M pixels (the
// wrapper sizes part_s/part_q [rows][Ce] and the reduction scratch with it).
extern "C" int ir_train_stats1_tile(int Cin, int Ce, int dtype) {
  if (Cin <= 0 || Ce <= 0 || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  return bm_of(dtype == 0 ? wm_of<float>(Cin, Ce) : wm_of<__nv_bfloat16>(Cin, Ce));
}
extern "C" int ir_train_stats1_rows(long long M, int Cin, int Ce, int dtype) {
  const int bm = ir_train_stats1_tile(Cin, Ce, dtype);
  return M > 0 && bm > 0 ? grid_of(M, bm / 32) : 0;
}

// Shared memory a block uses, and resident blocks per SM, for this Cin, Ce
// and dtype; negative on a CUDA error.
extern "C" int ir_train_stats1_smem(int Cin, int Ce, int dtype) {
  const int bm = ir_train_stats1_tile(Cin, Ce, dtype);
  if (bm <= 0) return -(int)cudaErrorInvalidValue;
  return (int)(dtype == 0 ? smem_of<float>(Cin, Ce, bm / 32)
                          : smem_of<__nv_bfloat16>(Cin, Ce, bm / 32));
}
extern "C" int ir_train_stats1_occupancy(int Cin, int Ce, int dtype) {
  if (Cin <= 0 || Ce <= 0 || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  return dtype == 0 ? occupancy_t<float>(Cin, Ce) : occupancy_t<__nv_bfloat16>(Cin, Ce);
}

// x [M, Cin] (dtype 0 = f32, 1 = bf16; Cin % 8 == 0, 16-byte aligned),
// w1f the mma fragments of W1 [Cin, Ce] (ksteps k-steps and np8 n-tiles:
// ops/ir_fused.py::mma_fragments); part_s/part_q [rows][Ce] f32 scratch
// (ir_train_stats1_rows), scratch [ceil(rows/rpg)][Ce] f32 (may be null
// when rows <= rpg); sum/sq [Ce] f32 out; probe [M][Ce] f32 (e, rounded) or
// null.
extern "C" int ir_train_stats1(const void* x, const void* w1f, void* part_s, void* part_q,
                               void* scratch, void* sum, void* sq, void* probe, long long M,
                               int Cin, int Ce, int ksteps, int np8, int rpg, int dtype,
                               void* stream) {
  if (M <= 0 || Cin <= 0 || Ce <= 0 || Cin % 8 || ksteps * 16 < Cin || np8 * 8 < Ce ||
      (dtype != 0 && dtype != 1) || (M + 63) / 64 > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params P{};
  P.x = x;
  P.w1f = static_cast<const uint2*>(w1f);
  P.part_s = static_cast<float*>(part_s);
  P.part_q = static_cast<float*>(part_q);
  P.probe = static_cast<float*>(probe);
  P.M = M;
  P.Cin = Cin;
  P.Ce = Ce;
  P.ksteps = ksteps;
  P.np8 = np8;
  float* f[] = {static_cast<float*>(scratch), static_cast<float*>(sum), static_cast<float*>(sq)};
  if (dtype == 0)
    return probe ? launch_t<float, true>(P, f[0], f[1], f[2], rpg, s)
                 : launch_t<float, false>(P, f[0], f[1], f[2], rpg, s);
  return probe ? launch_t<__nv_bfloat16, true>(P, f[0], f[1], f[2], rpg, s)
               : launch_t<__nv_bfloat16, false>(P, f[0], f[1], f[2], rpg, s);
}
