// Fused InvertedResidual training backward, pass 3: through BN1 and the
// expand 1x1, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/ir_fused.py::_expand_bwd_kernel
// (launched from _ir_train_backward once per 128-lane hidden chunk, grid
// (B,), dW1 carried in VMEM scratch across the grid, the chunks' dx
// partials added in XLA):
//
//   e   = x . W1 rounded to the input dtype          (recomputed, not stored)
//   de  = (u1 * dv1 - p1 - q1 * (e - m1) * inv1) rounded       (BN1 backward)
//   dW1 = x^T . de                                   [Cin, Ce] f32
//   dx  = de . W1^T                                  [M, Cin] f32
//
// x [M, Cin] and dv1 [M, Ce] (M = B*H*W) in f32 or bf16, W1 as mma
// fragments of input-dtype values, the vectors [Ce] f32.
//
// Design. All three products run on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulate): e through the shared expand_step of K9 and K12
// (ir_train_common.cuh), dW1 and dx through the same split-operand
// mma_step (f32: three bf16 terms a side, six products; bf16: one exact
// product), each k-step's products in a fresh accumulator added once,
// rounded to nearest. A block owns (a strip of `strip_rows` pixels, a group
// of `cg` hidden channels) and walks its strip 64 pixels at a time. Each
// tile of x is split once into its bf16 terms in shared memory (f32: from a
// staging buffer that the next tile fills by cp.async meanwhile; bf16: x
// itself, double-buffered), and every fragment is read from the terms with
// ldmatrix (transposed for x^T), so no value is split twice. Per tile the
// block walks its group in chunks of 64 channels: e for the chunk (warp =
// 8-channel n-tile, all four 16-pixel m-tiles), de formed once and kept in
// shared memory as its terms (in bf16, the bf16 the TPU kernel rounds it
// to), dW1's tile added to the block's [Cin][cg] f32 sum in shared memory
// (each element owned by one thread), and dx's tile summed in registers
// across the chunks and written once per tile. The group is as wide as
// shared memory allows (ir_train_expand_bwd_groups): at the student's
// stages 2-5, 1 / 3 / 3 / 4 groups in f32 (1 / 2 / 2 / 3 in bf16), so dx is
// written as that many f32 partial copies (none with one group) and added
// by sum_rows, against 3 / 6 / 6 / 12 copies (0.8 GB a stage at B=128) in
// the first version. dW1 is one [Cin, Ce] partial per strip, added by
// sum_rows in a fixed order. No float atomics. Cin above 128 is taken in
// 128-channel register groups (dx then adds into its partial in device
// memory once per chunk).
//
// Bound on the H100: the products the design issues on the tensor cores,
// 3 x 2*M*Cin*Ce (6 products each in f32, 1 in bf16) at 989 TFLOP/s,
// against reading x and dv1 and writing dx: at B=128 0.47 ms a stage in
// f32 at stages 3-5 (operations), bytes elsewhere (chip_smoke.py).

#include "ir_train_common.cuh"

namespace {

using namespace irt;

constexpr int kRows = 64;  // pixels a tile
constexpr int kCC = 64;    // hidden channels a chunk
constexpr int kNV = 5;     // m1, inv1, u1, p1, q1

// Rows of bf16 terms (x's of row_ld, de's of 128 bytes) are swizzled as
// x_chunk<bf16>: the eight rows one ldmatrix phase reads, and a warp's pair
// stores to eight rows, hit all banks.
__device__ __forceinline__ int sw(int r, int c) { return x_chunk<__nv_bfloat16>(r, c); }

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

struct Params {
  const void* x;
  const uint2* w1f;   // W1 [Cin, Ce] as B fragments (k = Cin)
  const uint2* w1tf;  // W1^T [Ce, Cin] as B fragments (k = Ce)
  const float* vec[kNV];
  const void* dv1;
  float* dx_out;      // [groups][M][Cin] partials, or dx itself with one group
  float* dw1p;        // [strips][Cin][Ce]
  long long M;
  int Cin, Ce, cg, strip_rows, ldt, nbuf, ks_w1, ks_w1t;
};

// Shared memory: f32 (es 4): x's staging [64][Cin16] f32 when nbuf is 1 (0:
// x is read from device memory straight into its terms), x's terms
// [3][64][ldt] and de's [3][64][64]; bf16: x itself [nbuf][64][ldt] and de
// [64][64]; then dW1's sum [Cin][cg] and the vectors [5][cg] f32.
size_t smem_of(int Cin, int cg, int nbuf, int es) {
  const int nt = es == 4 ? 3 : 1;
  const size_t x = es == 4 ? (size_t)nbuf * kRows * ((Cin + 15) / 16 * 16) * 4 +
                                 (size_t)nt * kRows * row_ld(Cin, 2) * 2
                           : (size_t)nbuf * kRows * row_ld(Cin, 2) * 2;
  return x + (size_t)nt * kRows * kCC * 2 + (size_t)Cin * cg * 4 + (size_t)kNV * cg * 4;
}

// The group width and x's buffering: the first of (two blocks an SM, then
// one; the most buffering of x first: f32 staging 1 then 0, bf16 2 then 1)
// whose widest fitting group (a multiple of 64) leaves at most 4 groups,
// else the widest group of any.
bool plan(int Cin, int Ce, int es, int* cg, int* nbuf) {
  const int ce64 = (Ce + kCC - 1) / kCC * kCC;
  const int hi = es == 4 ? 1 : 2;
  const int limits[2] = {kSmemTwoBlocks, kSmemBlock};
  int best = 0, best_nb = 0;
  for (int limit : limits)
    for (int nb = hi; nb >= hi - 1; --nb) {
      int c = ce64;
      while (c >= kCC && smem_of(Cin, c, nb, es) > (size_t)limit) c -= kCC;
      if (c < kCC) continue;
      if (4 * c >= ce64) {
        *cg = c;
        *nbuf = nb;
        return true;
      }
      if (c > best) {
        best = c;
        best_nb = nb;
      }
    }
  *cg = best;
  *nbuf = best_nb;
  return best > 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
expand_bwd_kernel(const Params P) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NT = Mma<T>::terms;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int Cin = P.Cin, Ce = P.Ce, ldt = P.ldt;
  const int k16 = (Cin + 15) / 16 * 16;
  // Layout (smem_of).
  float* xstage = reinterpret_cast<float*>(smem);  // f32, nbuf 1: [64][k16]
  __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(
      smem + (F32 ? (size_t)P.nbuf * kRows * k16 * 4 : 0));  // [NT or nbuf][64][ldt]
  const int xt_n = F32 ? NT : P.nbuf;
  __nv_bfloat16* det = xt + (size_t)xt_n * kRows * ldt;  // [NT][64][64]
  float* dwa = reinterpret_cast<float*>(det + (size_t)NT * kRows * kCC);  // [Cin][cg]
  float* vec = dwa + (size_t)Cin * P.cg;  // [5][cg]

  const T* __restrict__ x = static_cast<const T*>(P.x);
  const T* __restrict__ dv1 = static_cast<const T*>(P.dv1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0g = blockIdx.y * P.cg;
  const int cgn = min(P.cg, Ce - c0g);
  const int nchunk = (cgn + kCC - 1) / kCC;
  const long long r_begin = (long long)blockIdx.x * P.strip_rows;
  const long long r_end = min(r_begin + P.strip_rows, P.M);
  const int ntile = (int)((r_end - r_begin + kRows - 1) / kRows);
  const int ksx = k16 / 16;               // k-steps of the expand
  const int cgroups = (k16 + 127) / 128;  // 128-channel register groups of Cin
  const bool dx_in_regs = cgroups == 1;
  float* dxo = P.dx_out + (size_t)blockIdx.y * P.M * Cin;
  // ldmatrix row addresses: lane l reads row (l & 7) of matrix l >> 3.
  const int lr = lane & 7, li = lane >> 3;

  for (int i = tid; i < Cin * P.cg; i += kThreads) dwa[i] = 0.f;
  for (int i = tid; i < kNV * P.cg; i += kThreads) {
    const int v = i / P.cg, c = i - v * P.cg;
    vec[i] = c < cgn ? P.vec[v][c0g + c] : 0.f;
  }
  // x rows [r0, r0 + 64), zero past r_end and past Cin: into f32's staging,
  // or (bf16) straight into buffer `buf` of x.
  auto issue_x = [&](int tile, int buf) {
    const long long r0 = r_begin + (long long)tile * kRows;
    constexpr int E = 16 / (int)sizeof(T);
    const int cpp = k16 / E;
    for (int i = tid; i < kRows * cpp; i += kThreads) {
      const int r = i / cpp, c = i - r * cpp;
      const bool ok = r0 + r < r_end && c * E < Cin;
      void* dst = F32 ? (void*)(xstage + r * k16 + c * E)
                      : (void*)(xt + ((size_t)buf * kRows + r) * ldt + sw(r, c) * 8);
      cp_async16(dst, ok ? (const void*)(x + (r0 + r) * Cin + c * E) : P.x, ok);
    }
  };
  // f32: x's tile into its three bf16 terms, from the staging buffer or
  // (nbuf 0) from device memory.
  auto split_x = [&](int tile) {
    const long long r0 = r_begin + (long long)tile * kRows;
    const int c4 = k16 / 4;
    for (int i = tid; i < kRows * c4; i += kThreads) {
      const int r = i / c4, c = 4 * (i - r * c4);
      float4 v;
      if (P.nbuf) {
        v = *reinterpret_cast<const float4*>(xstage + r * k16 + c);
      } else {
        const bool ok = r0 + r < r_end && c < Cin;
        v = ok ? load4(reinterpret_cast<const float*>(x) + (r0 + r) * Cin + c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      uint32_t lo[kTerms], hi[kTerms];
      split3(v.x, v.y, lo);
      split3(v.z, v.w, hi);
#pragma unroll
      for (int q = 0; q < kTerms; ++q)
        *reinterpret_cast<uint2*>(xt + ((size_t)q * kRows + r) * ldt + sw(r, c / 8) * 8 + c % 8) =
            make_uint2(lo[q], hi[q]);
    }
  };
  if (!F32 || P.nbuf) issue_x(0, 0);
  cp_commit();

  for (int tile = 0; tile < ntile; ++tile) {
    const long long r0 = r_begin + (long long)tile * kRows;
    int buf = 0;
    if (F32) {
      cp_wait<0>();
      __syncthreads();  // staging landed; the previous tile's terms consumed
      split_x(tile);
      __syncthreads();
      if (P.nbuf && tile + 1 < ntile) issue_x(tile + 1, 0);
      cp_commit();
    } else if (P.nbuf == 2) {
      buf = tile & 1;
      cp_wait<0>();
      __syncthreads();
      if (tile + 1 < ntile) issue_x(tile + 1, buf ^ 1);
      cp_commit();
    } else {
      if (tile > 0) {
        __syncthreads();
        issue_x(tile, 0);
        cp_commit();
      }
      cp_wait<0>();
      __syncthreads();
    }
    const __nv_bfloat16* xs = xt + (size_t)buf * kRows * ldt;  // term q at + q * 64 * ldt

    float dxacc[8][4];  // dx rows 16 (warp & 3) + g (+8), n-tiles (warp >> 2) + 2 j
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) dxacc[j][r] = 0.f;

    for (int ch = 0; ch < nchunk; ++ch) {
      const int cl0 = ch * kCC;   // chunk base within the group
      const int cc0 = c0g + cl0;  // global channel base
      // 1. e (shared expand) and de: warp = n-tile, all four m-tiles.
      {
        const int cl = cl0 + 8 * warp + 2 * t, c = c0g + cl;
        float2 gv[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long r = r0 + 16 * mt + g + 8 * h;
            gv[mt][h] = r < r_end && c < Ce ? load_pair(dv1 + r * Ce + c) : make_float2(0.f, 0.f);
          }
        float acc[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][r] = 0.f;
        const uint2* wf = P.w1f + (size_t)(cc0 / 8 + warp) * P.ks_w1 * NT * 32;
        for (int ks = 0; ks < ksx; ++ks) {
          uint32_t w[NT][2];
          load_b<T>(w, wf + (size_t)ks * NT * 32, lane);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const int r = 16 * mt + lr + 8 * (li & 1);
            uint32_t a[NT][4];
#pragma unroll
            for (int q = 0; q < NT; ++q)
              ldsm_x4(a[q], xs + ((size_t)q * kRows + r) * ldt + sw(r, 2 * ks + (li >> 1)) * 8);
            expand_step<T>(acc[mt], a, w);
          }
        }
        float m[2], iv[2], u[2], p[2], q[2];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int l = min(cl + e2, P.cg - 1);
          m[e2] = vec[l]; iv[e2] = vec[P.cg + l]; u[e2] = vec[2 * P.cg + l];
          p[e2] = vec[3 * P.cg + l]; q[e2] = vec[4 * P.cg + l];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rl = 16 * mt + g + 8 * h;
            const bool ok = r0 + rl < r_end && c < Ce;  // Ce % 8 == 0: c + 1 < Ce too
            float de[2];
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const float en = normalize(round_to<T>(acc[mt][2 * h + e2]), m[e2], iv[e2]);
              const float gg = e2 ? gv[mt][h].y : gv[mt][h].x;
              de[e2] = ok ? round_to<T>(bn_backward(u[e2], gg, p[e2], q[e2], en)) : 0.f;
            }
            uint32_t dt[kTerms];
            if (F32) split3(de[0], de[1], dt);
            else dt[0] = bf2_bits(__floats2bfloat162_rn(de[0], de[1]));
#pragma unroll
            for (int qq = 0; qq < NT; ++qq)
              *reinterpret_cast<uint32_t*>(det + ((size_t)qq * kRows + rl) * kCC +
                                           sw(rl, warp) * 8 + 2 * t) = dt[qq];
          }
      }
      __syncthreads();

      // 2. dW1[ci][c] += x^T . de: warp = the chunk's n-tile, m-tiles of Cin.
      for (int gi = 0; gi < cgroups; ++gi) {
        const int nm = min(8, (k16 - 128 * gi) / 16);
        float dacc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) dacc[j][r] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kRows / 16; ++ks) {
          uint32_t b[NT][2];
          {
            const int px = 16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
            for (int q = 0; q < NT; ++q)
              ldsm_x2_t(b[q], det + ((size_t)q * kRows + px) * kCC + sw(px, warp) * 8);
          }
          const int px = 16 * ks + lr + 8 * (li >> 1);
#pragma unroll
          for (int mi = 0; mi < 8; ++mi) {
            if (mi >= nm) break;
            const int chunk = 16 * gi + 2 * mi + (li & 1);
            uint32_t a[NT][4];
#pragma unroll
            for (int q = 0; q < NT; ++q)
              ldsm_x4_t(a[q], xs + ((size_t)q * kRows + px) * ldt + sw(px, chunk) * 8);
            mma_step<NT, NT>(dacc[mi], a, b);
          }
        }
#pragma unroll
        for (int mi = 0; mi < 8; ++mi) {
          if (mi >= nm) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ci = 128 * gi + 16 * mi + g + 8 * h;
            const int cl = cl0 + 8 * warp + 2 * t;
            if (ci >= Cin || cl >= cgn) continue;
            float* d = dwa + (size_t)ci * P.cg + cl;
            d[0] = __fadd_rn(d[0], dacc[mi][2 * h]);
            d[1] = __fadd_rn(d[1], dacc[mi][2 * h + 1]);
          }
        }
      }

      // 3. dx[px][ci] += de . W1^T: warp = m-tile warp & 3, n-tiles
      // (warp >> 2) + 2 j of each 128-channel group of Cin. With Cin <= 128
      // dxacc carries the tile's sum across the chunks; wider, it takes one
      // group's share of this chunk, which is added to the partial in device
      // memory.
      {
        const int mt = warp & 3;
        for (int gi = 0; gi < cgroups; ++gi) {
          if (!dx_in_regs) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int r = 0; r < 4; ++r) dxacc[j][r] = 0.f;
          }
#pragma unroll
          for (int ks = 0; ks < kCC / 16; ++ks) {
            const int r = 16 * mt + lr + 8 * (li & 1);
            uint32_t a[NT][4];
#pragma unroll
            for (int q = 0; q < NT; ++q)
              ldsm_x4(a[q], det + ((size_t)q * kRows + r) * kCC + sw(r, 2 * ks + (li >> 1)) * 8);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int nt = 16 * gi + (warp >> 2) + 2 * j;
              if (8 * nt >= k16) break;
              uint32_t w[NT][2];
              load_b<T>(w, P.w1tf + ((size_t)nt * P.ks_w1t + cc0 / 16 + ks) * NT * 32, lane);
              mma_step<NT, NT>(dxacc[j], a, w);
            }
          }
          if (!dx_in_regs) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int ci = 8 * (16 * gi + (warp >> 2) + 2 * j) + 2 * t;
              if (ci >= Cin) break;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const long long r = r0 + 16 * mt + g + 8 * h;
                if (r >= r_end) continue;
                float* d = dxo + r * Cin + ci;
                const float2 o = ch ? *reinterpret_cast<const float2*>(d) : make_float2(0.f, 0.f);
                *reinterpret_cast<float2*>(d) = make_float2(__fadd_rn(o.x, dxacc[j][2 * h]),
                                                            __fadd_rn(o.y, dxacc[j][2 * h + 1]));
              }
            }
          }
        }
      }
      __syncthreads();  // de consumed
    }

    if (dx_in_regs) {
      const int mt = warp & 3;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ci = 8 * ((warp >> 2) + 2 * j) + 2 * t;
        if (ci >= Cin) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long r = r0 + 16 * mt + g + 8 * h;
          if (r < r_end)
            *reinterpret_cast<float2*>(dxo + r * Cin + ci) =
                make_float2(dxacc[j][2 * h], dxacc[j][2 * h + 1]);
        }
      }
    }
  }

  __syncthreads();
  float* pw = P.dw1p + (size_t)blockIdx.x * Cin * Ce;
  for (int i = tid; i < Cin * cgn; i += kThreads) {
    const int ci = i / cgn, cl = i - ci * cgn;
    pw[(size_t)ci * Ce + c0g + cl] = dwa[(size_t)ci * P.cg + cl];
  }
}

template <typename T>
int launch(const Params& p0, float* scratch, float* dx, float* dw1, int rpg, cudaStream_t s) {
  Params p = p0;
  const int es = sizeof(T);
  if (!plan(p.Cin, p.Ce, es, &p.cg, &p.nbuf)) return (int)cudaErrorInvalidValue;
  p.ldt = row_ld(p.Cin, 2);
  const size_t smem = smem_of(p.Cin, p.cg, p.nbuf, es);
  cudaError_t e = cudaFuncSetAttribute(expand_bwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nstrip = (p.M + p.strip_rows - 1) / p.strip_rows;
  const int ngroups = (p.Ce + p.cg - 1) / p.cg;
  if (ngroups == 1) p.dx_out = dx;
  expand_bwd_kernel<T><<<dim3((unsigned)nstrip, ngroups), kThreads, smem, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (ngroups > 1) {
    e = sum_rows(p.dx_out, ngroups, p.M * p.Cin, rpg, scratch, dx, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)sum_rows(p.dw1p, nstrip, (long long)p.Cin * p.Ce, rpg, scratch, dw1, s);
}

}  // namespace

// The channel groups a block owns (the rows of the dx partials; 1 = no
// partials) and the shared memory a block uses, for this Cin, Ce and dtype;
// -1 when no group of 64 channels fits in a block's shared memory.
extern "C" int ir_train_expand_bwd_groups(int Cin, int Ce, int dtype) {
  int cg = 0, nbuf = 0;
  if (Cin <= 0 || Ce <= 0 || !plan(Cin, Ce, dtype == 0 ? 4 : 2, &cg, &nbuf)) return -1;
  return (Ce + cg - 1) / cg;
}
extern "C" int ir_train_expand_bwd_smem(int Cin, int Ce, int dtype) {
  int cg = 0, nbuf = 0;
  const int es = dtype == 0 ? 4 : 2;
  if (Cin <= 0 || Ce <= 0 || !plan(Cin, Ce, es, &cg, &nbuf)) return -1;
  return (int)smem_of(Cin, cg, nbuf, es);
}

// x [M, Cin], dv1 [M, Ce] (dtype 0 = f32, 1 = bf16, both the same, 16-byte
// aligned); w1f / w1tf the mma fragments of W1 [Cin, Ce] and W1^T [Ce, Cin]
// (ops/ir_fused.py::mma_fragments, ks_w1 / ks_w1t k-steps per n-tile);
// m1/inv1/u1/p1/q1 [Ce] f32; dxp [groups][M][Cin] f32 partials (groups =
// ir_train_expand_bwd_groups; unused, may be null, with one group);
// dw1p [ceil(M/strip_rows)][Cin*Ce] f32 partials; scratch f32 of at least
// ceil(n/rpg) rows of each reduction's width (n its row count; may be null
// when every n <= rpg); dx [M, Cin] and dw1 [Cin, Ce] f32 out. Cin % 8 ==
// 0, Ce % 8 == 0; strip_rows a multiple of 64.
extern "C" int ir_train_expand_bwd(const void* x, const void* w1f, const void* w1tf,
                                   const void* m1, const void* inv1, const void* u1,
                                   const void* p1, const void* q1, const void* dv1, void* dxp,
                                   void* dw1p, void* scratch, void* dx, void* dw1, long long M,
                                   int Cin, int Ce, int ks_w1, int ks_w1t, int strip_rows,
                                   int rpg, int dtype, void* stream) {
  if (M <= 0 || Cin <= 0 || Cin % 8 || Ce <= 0 || Ce % 8 || strip_rows <= 0 ||
      strip_rows % kRows || (M + strip_rows - 1) / strip_rows > 0x7fffffffLL ||
      ks_w1 * 16 < Cin || ks_w1t * 16 < (Ce + kCC - 1) / kCC * kCC || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.w1f = static_cast<const uint2*>(w1f);
  p.w1tf = static_cast<const uint2*>(w1tf);
  const void* v[] = {m1, inv1, u1, p1, q1};
  for (int i = 0; i < kNV; ++i) p.vec[i] = static_cast<const float*>(v[i]);
  p.dv1 = dv1;
  p.dx_out = static_cast<float*>(dxp);
  p.dw1p = static_cast<float*>(dw1p);
  p.M = M;
  p.Cin = Cin;
  p.Ce = Ce;
  p.strip_rows = strip_rows;
  p.ks_w1 = ks_w1;
  p.ks_w1t = ks_w1t;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch<float>(p, sc, static_cast<float*>(dx), static_cast<float*>(dw1), rpg, s);
  return launch<__nv_bfloat16>(p, sc, static_cast<float*>(dx), static_cast<float*>(dw1), rpg, s);
}
