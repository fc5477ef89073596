// Weighted-fusion gate, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/fusion_pallas.py::_gate_kernel
// (launched from _gate_forward). Per BEV row (one pixel, C channels):
//
//   a   = [cam | lid] . W1^T + b1      (the concat 1x1 conv, W1 [C, 2C])
//   h   = relu(a)
//   d   = h . (w2[0] - w2[1]) + (b2[0] - b2[1])
//   g   = sigmoid(d)                   (2-way softmax == sigmoid of the
//                                       logit difference)
//   out = g * cam + (1 - g) * lid      (written in the input dtype)
//
// Design. The 2C x C product runs on the tensor cores
// (mma.sync.m16n8k16 bf16 -> f32, mma_step's arithmetic from
// ir_train_common.cuh). W1 stays at f32 precision in both types, as the TPU
// kernel casts it to f32: a first kernel (fusion_gate_fragments, same launch)
// splits it into three bf16 terms per value, laid out as mma B fragments
// (K = [cam channels padded to 16 | lid channels padded to 16], N = C
// padded to 256); f32 features are split into three terms in registers
// (products a_i . w_j with i + j < 3: six), bf16 features are one exact
// term (three products). Each 16-channel k-step's products go to a fresh
// accumulator added once with __fadd_rn, as the shared expand does
// (ops/fusion_gate.py::fusion_gate_emulated repeats this arithmetic on the
// CPU and chose the term count).
//
// A block owns a tile of BM = 32 * WM rows and all C output channels: the
// tile's [cam | lid] rows are staged once in shared memory in the input
// dtype (cp.async, the x_chunk swizzle), warps as WM (rows) x WN
// (channels), each warp 32 rows x 32 channels (2 x 4 mma tiles) of a pass
// of NC = 32 * WN channels; wider C takes more passes. W1's fragments for
// one (pass, k-step) ride a four-slot cp.async ring, three items ahead; in
// the first pass the same group brings that k-step's columns of the tile,
// so the tile's load overlaps the first pass. After a pass each warp forms
// relu(a + b1) . w2d for its rows over its channels (a quad's lanes reduced
// by shuffles), added over the passes in order in registers; the warps'
// partial logits are then added in a fixed order through shared memory,
// and the sigmoid and the blend read cam and lid from the staged tile, so
// both cross device memory once and out is written once. The shape is the
// first of 8 warps whose block fits two to an SM (the student's C = 128:
// 64 rows in f32, 128 in bf16; the teacher's C = 256 in bf16: 64 rows),
// else of 16 warps in one block (C = 256 in f32: 64 rows, one pass of 256
// channels), else of 32 rows (up to C = 512 in f32, 1,024 in bf16).
//
// A C whose 32-row tile does not fit (RX, "x in a ring") streams x
// instead: each item's k-step of the 64 rows' [cam | lid] rides the ring
// beside its W1 slot, in every pass, and the blend reads cam and lid from
// device memory again. The products, their order and the accumulator
// schedule are those of the resident tile, so a is the same function of
// the inputs; x is read once a pass (C / 128 times) and once more for the
// blend, which the products, growing as C^2, outweigh at such widths.
//
// Bound on the H100: at C = 128 the bytes (cam and lid read, out written:
// 3 * M * C elements); at C = 256 the products the design issues, 2 * M *
// 2C * C per product (6 in f32, 3 in bf16) at 989 TFLOP/s; the epilogue's
// ~8 * M * C operations on CUDA cores at 67 TFLOP/s lie below both
// (chip_smoke.py counts all three). mma.sync reaches about half the rate
// that wgmma can, so where the products bound the kernel it can come no
// closer than about twice its bound. W1's fragments (6 bytes an element)
// cross from L2 to each block once: 2C * C * 6 / BM bytes a row.

#include "ir_train_common.cuh"

namespace {

using namespace irt;

constexpr int kWTerms = kTerms;  // W1 is f32 in both types: three terms
constexpr int kRing = 4;         // ring slots, one (pass, k-step) each
constexpr int kRingLd = 24;      // RX: elements a row of a ring slot of x (16
                                 // used; fragment reads conflict-free)

__host__ __device__ constexpr int pad16(int c) { return (c + 15) / 16 * 16; }

// Block shapes: WM row warps x WN channel warps (BM = 32 WM rows, passes of
// NC = 32 WN channels): 8 warps, two blocks to an SM where they fit, else
// 16 warps in one.
struct Shape { int wm, wn; };
constexpr Shape kShapes[] = {{4, 2}, {2, 4}, {1, 8}, {4, 4}, {2, 8}};

constexpr int kRingShape = 1;    // RX: 64 rows, passes of 128 channels

// Shared memory of a block of this shape at this C: the row tile (RX: the
// ring of x's k-steps), the W1 ring and the warps' partial logits.
size_t smem_of(int C, int es, int sh, bool rx) {
  const int bm = 32 * kShapes[sh].wm, nc = 32 * kShapes[sh].wn;
  const size_t x = rx ? (size_t)kRing * bm * kRingLd * es : (size_t)bm * row_ld(2 * pad16(C), es) * es;
  return x + (size_t)kRing * (nc / 8) * kWTerms * 256 + (size_t)kShapes[sh].wn * bm * 4;
}

// The first shape, in kShapes' order (most rows first), of 8 warps whose
// block fits two to an SM with the tile resident; else of 16 warps, then of
// 8, that fits one; else kRingShape with x streamed (whose shared memory
// does not depend on C).
struct Choice {
  int sh;
  bool rx;
};
Choice choice_of(int C, int es) {
  for (int sh = 0; sh < 3; ++sh)
    if (smem_of(C, es, sh, false) <= (size_t)kSmemTwoBlocks) return {sh, false};
  for (int sh : {3, 4, 2})
    if (smem_of(C, es, sh, false) <= (size_t)kSmemBlock) return {sh, false};
  return {kRingShape, true};
}

__host__ __device__ inline int ksteps_of(int C) { return 2 * pad16(C) / 16; }
// n-tiles of the fragment array: C padded to a multiple of 256 (the widest
// pass), so a pass never reads past it.
__host__ __device__ inline int ntiles_of(int C) { return (C + 255) / 256 * 32; }

// W1 [C][2C] (torch layout) -> fragments [ntiles][ksteps][3][32] uint2:
// B(k, n) = W1[n][k] for k < C, W1[n][C + k - Cp] for Cp <= k < Cp + C,
// zero elsewhere and for n >= C; lane 4g + t holds term i of B at k = 16s +
// 2t + (0, 1, 8, 9), n = 8j + g (ir_train_common.cuh::load_b's layout).
__global__ void __launch_bounds__(kThreads)
fusion_gate_fragments(const float* __restrict__ w1, uint2* __restrict__ frag, int C) {
  const int ks = ksteps_of(C), cp = pad16(C);
  const long long total = (long long)ntiles_of(C) * ks * 32;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const int lane = (int)(i & 31);
    const long long js = i >> 5;
    const int s = (int)(js % ks), j = (int)(js / ks);
    const int g = lane >> 2, t = lane & 3, n = 8 * j + g;
    float v[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int k = 16 * s + 2 * t + (d & 1) + 8 * (d >> 1);
      const int kin = k < cp ? (k < C ? k : -1) : (k - cp < C ? C + k - cp : -1);
      v[d] = n < C && kin >= 0 ? w1[(size_t)n * 2 * C + kin] : 0.f;
    }
    uint32_t lo[kTerms], hi[kTerms];
    split3(v[0], v[1], lo);
    split3(v[2], v[3], hi);
#pragma unroll
    for (int q = 0; q < kTerms; ++q)
      frag[((size_t)js * kTerms + q) * 32 + lane] = make_uint2(lo[q], hi[q]);
  }
}

struct Params {
  const void* cam;
  const void* lid;
  const uint2* w1f;
  const float* b1;
  const float* w2;
  const float* b2;
  void* out;
  int M, C, ldx, vec;
};

// Elements of a 16-byte chunk of T.
template <typename T> __device__ __forceinline__ void load_chunk(float (&v)[16 / sizeof(T)],
                                                                 const T* p);
template <> __device__ __forceinline__ void load_chunk<float>(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <> __device__ __forceinline__ void load_chunk<__nv_bfloat16>(float (&v)[8],
                                                                      const __nv_bfloat16* p) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <typename T> __device__ __forceinline__ void store_chunk(T* p,
                                                                  const float (&v)[16 / sizeof(T)]);
template <> __device__ __forceinline__ void store_chunk<float>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <> __device__ __forceinline__ void store_chunk<__nv_bfloat16>(__nv_bfloat16* p,
                                                                       const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = bf2_bits(__floats2bfloat162_rn(v[2 * i], v[2 * i + 1]));
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int WM, int WN, bool RX>
__global__ void __launch_bounds__(32 * WM * WN, 16 / (WM * WN))
fusion_gate_kernel(const Params P) {
  constexpr int AT = Mma<T>::terms;
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int BM = 32 * WM, NC = 32 * WN, NTH = 32 * WM * WN;
  constexpr int WSLOT = NC / 8 * kWTerms * 32;  // uint2 a ring slot
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  constexpr int XSLOT = BM * kRingLd;  // RX: elements a ring slot of x
  // [BM][ldx], or RX [kRing][BM][kRingLd]
  T* xs = reinterpret_cast<T*>(smem);
  uint2* ws = reinterpret_cast<uint2*>(
      smem + (RX ? (size_t)kRing * XSLOT : (size_t)BM * P.ldx) * sizeof(T));  // [kRing][WSLOT]
  float* dp = reinterpret_cast<float*>(ws + kRing * WSLOT);  // [WN][BM]; then the gates

  const T* __restrict__ cam = static_cast<const T*>(P.cam);
  const T* __restrict__ lid = static_cast<const T*>(P.lid);
  T* __restrict__ out = static_cast<T*>(P.out);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int C = P.C, cp = pad16(C);
  const int ks = 2 * cp / 16;
  const int npass = (C + NC - 1) / NC;
  const int items = npass * ks;
  const long long m0 = (long long)blockIdx.x * BM;

  // The tile's rows: [cam | lid], each half padded to cp channels with
  // zeros. With 16-byte rows, k-step s's columns arrive with item s of the
  // first pass (issue_x), so the first pass overlaps the tile's load.
  if (!RX && !P.vec) {
    for (int i = tid; i < BM * 2 * cp; i += NTH) {
      const int r = i / (2 * cp), k = i - r * 2 * cp;
      const int h = k >= cp, kk = k - h * cp;
      const bool ok = m0 + r < P.M && kk < C;
      xs[r * P.ldx + x_chunk<T>(r, k / E) * E + k % E] =
          ok ? (h ? lid : cam)[(m0 + r) * C + kk] : from_f<T>(0.f);
    }
  }
  auto issue_x = [&](int s) {
    constexpr int CPS = 16 / E;  // 16-byte chunks a row of one k-step
    const int half = cp / E;
#pragma unroll
    for (int u = 0; u < (BM * CPS + NTH - 1) / NTH; ++u) {
      const int i = tid + u * NTH;
      if (BM * CPS % NTH == 0 || i < BM * CPS) {
        const int r = i / CPS, c = s * CPS + (i - r * CPS);
        const int h = c >= half, cc = c - h * half;
        const bool ok = m0 + r < P.M && cc * E < C;
        const T* src = (h ? lid : cam) + (m0 + r) * C + cc * E;
        cp_async16(xs + r * P.ldx + x_chunk<T>(r, c) * E, ok ? (const void*)src : P.cam, ok);
      }
    }
  };
  // RX: k-step k's 16 columns of the rows into ring slot `slot` (zeros past
  // M and in the padding), by cp.async with 16-byte rows, else by loads.
  auto issue_xr = [&](int k, int slot) {
    T* dst = xs + (size_t)slot * XSLOT;
    if (P.vec) {
      constexpr int CPS = 16 / E;
      const int half = cp / E;
#pragma unroll
      for (int u = 0; u < (BM * CPS + NTH - 1) / NTH; ++u) {
        const int i = tid + u * NTH;
        if (BM * CPS % NTH == 0 || i < BM * CPS) {
          const int r = i / CPS, c = i - r * CPS, kc = k * CPS + c;
          const int h = kc >= half, cc = kc - h * half;
          const bool ok = m0 + r < P.M && cc * E < C;
          const T* src = (h ? lid : cam) + (m0 + r) * C + cc * E;
          cp_async16(dst + r * kRingLd + c * E, ok ? (const void*)src : P.cam, ok);
        }
      }
    } else {
      for (int i = tid; i < BM * 16; i += NTH) {
        const int r = i >> 4, kk = 16 * k + (i & 15);
        const int h = kk >= cp, c = kk - h * cp;
        const bool ok = m0 + r < P.M && c < C;
        dst[r * kRingLd + (i & 15)] = ok ? (h ? lid : cam)[(m0 + r) * C + c] : from_f<T>(0.f);
      }
    }
  };
  // W1's fragments of (pass p, k-step k) into slot s.
  auto issue_w = [&](int p, int k, int s) {
    constexpr int PER = kWTerms * 16;  // 16-byte pieces of one n-tile's k-step
    constexpr int TOTAL = NC / 8 * PER;
    const uint2* src = P.w1f + ((size_t)p * (NC / 8) * ks + k) * kWTerms * 32;
    uint2* dst = ws + (size_t)s * WSLOT;
#pragma unroll
    for (int u = 0; u < (TOTAL + NTH - 1) / NTH; ++u) {
      const int i = tid + u * NTH;
      if (TOTAL % NTH == 0 || i < TOTAL) {
        const int j = i / PER, piece = i - j * PER;
        cp_async16(dst + j * kWTerms * 32 + 2 * piece,
                   src + (size_t)j * ks * kWTerms * 32 + 2 * piece, true);
      }
    }
  };
  // Item i's group holds its W1 slot and its x columns: in the first pass,
  // or (RX) in every pass.
  int pi = 0, ki = 0;  // the pass and k-step of the next item to issue
  auto issue = [&](int i) {
    if (i < items) {
      if (RX)
        issue_xr(ki, i % kRing);
      else if (P.vec && i < ks)
        issue_x(i);
      issue_w(pi, ki, i % kRing);
      if (++ki == ks) {
        ki = 0;
        ++pi;
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) issue(i);

  // The thread's rows of the tile (rows 32 wm + 16 mt + g + 8 h share g's
  // swizzle, x_chunk<T>(g, c)).
  const T* xrow[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) xrow[mt][h] = xs + (32 * wm + 16 * mt + g + 8 * h) * P.ldx;

  float acc[2][4][4];
  float dsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // rows (mt, h): the logit so far
  int p = 0, k = 0;  // this item's pass and k-step
  for (int i = 0; i < items; ++i) {
    cp_wait<kRing - 2>();
    __syncthreads();  // item i landed; every warp is done with item i - 1's slot
    issue(i + kRing - 1);
    if (k == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0.f;
    }
    uint32_t a[2][AT][4];
    const T* xslot = xs + (size_t)(i % kRing) * XSLOT;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      typename Mma<T>::Pair xa[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        if (RX) {
          xa[f] = pair_at(xslot, 32 * wm + 16 * mt + g + 8 * (f & 1), 2 * t + 8 * (f >> 1),
                          kRingLd);
        } else {
          const int kk = 16 * k + 2 * t + 8 * (f >> 1);
          xa[f] = pair_at(xrow[mt][f & 1], 0, x_chunk<T>(g, kk / E) * E + kk % E, 0);
        }
      }
      terms_of(a[mt], xa);
    }
    const uint2* wt = ws + (size_t)(i % kRing) * WSLOT + (size_t)4 * wn * kWTerms * 32;
    uint32_t b[4][kWTerms][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) smem_b<float>(b[j], wt + j * kWTerms * 32, lane);
    mma_step_tiles<AT, kWTerms, 2, 4>(acc, a, b);
    if (k == ks - 1) {
      // relu(a + b1) . w2d over the warp's channels of this pass (zero past C).
      const int cb = p * NC + 32 * wn + 2 * t;
      float bias[4][2], w2d[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = cb + 8 * j + e;
          const bool ok = col < C;
          bias[j][e] = ok ? __ldg(P.b1 + col) : 0.f;
          w2d[j][e] = ok ? __fsub_rn(__ldg(P.w2 + col), __ldg(P.w2 + C + col)) : 0.f;
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              part = fmaf(fmax_nan(__fadd_rn(acc[mt][j][2 * h + e], bias[j][e]), 0.f), w2d[j][e],
                          part);
          part += __shfl_xor_sync(0xffffffffu, part, 1);
          part += __shfl_xor_sync(0xffffffffu, part, 2);
          dsum[mt][h] += part;
        }
    }
    if (++k == ks) {
      k = 0;
      ++p;
    }
  }
  cp_wait<0>();
  if (t == 0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) dp[wn * BM + 32 * wm + 16 * mt + 8 * h + g] = dsum[mt][h];
  }
  __syncthreads();
  if (tid < BM) {
    float d = dp[tid];
#pragma unroll
    for (int w = 1; w < WN; ++w) d += dp[w * BM + tid];
    d += __fsub_rn(__ldg(P.b2), __ldg(P.b2 + 1));
    dp[tid] = 1.f / (1.f + expf(-d));  // the row's gate, over its own logit
  }
  __syncthreads();
  const float* gs = dp;

  // The blend: from the staged rows, or (RX) from device memory.
  if (RX) {
    for (int i = tid; i < BM * C; i += NTH) {
      const int r = i / C, c = i - r * C;
      if (m0 + r >= P.M) continue;
      const size_t o = (size_t)(m0 + r) * C + c;
      const float gv = gs[r];
      out[o] = from_f<T>(gv * to_f(cam[o]) + (1.f - gv) * to_f(lid[o]));
    }
  } else if (P.vec) {
    const int half = cp / E, cw = C / E;
    for (int i = tid; i < BM * cw; i += NTH) {
      const int r = i / cw, c = i - r * cw;
      if (m0 + r >= P.M) continue;
      float cv[E], lv[E], o[E];
      load_chunk<T>(cv, xs + r * P.ldx + x_chunk<T>(r, c) * E);
      load_chunk<T>(lv, xs + r * P.ldx + x_chunk<T>(r, half + c) * E);
      const float gv = gs[r], hv = 1.f - gv;
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = gv * cv[e] + hv * lv[e];
      store_chunk<T>(out + (m0 + r) * C + c * E, o);
    }
  } else {
    for (int i = tid; i < BM * C; i += NTH) {
      const int r = i / C, c = i - r * C;
      if (m0 + r >= P.M) continue;
      const float cv = to_f(xs[r * P.ldx + x_chunk<T>(r, c / E) * E + c % E]);
      const int kl = cp + c;
      const float lv = to_f(xs[r * P.ldx + x_chunk<T>(r, kl / E) * E + kl % E]);
      const float gv = gs[r];
      out[(m0 + r) * C + c] = from_f<T>(gv * cv + (1.f - gv) * lv);
    }
  }
}

template <typename T, int SH, bool RX>
cudaError_t prepare(int C, size_t* smem) {
  *smem = smem_of(C, sizeof(T), SH, RX);
  return cudaFuncSetAttribute(fusion_gate_kernel<T, kShapes[SH].wm, kShapes[SH].wn, RX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <typename T, int SH, bool RX>
int launch_sh(const Params& P0, cudaStream_t s) {
  constexpr int WM = kShapes[SH].wm, WN = kShapes[SH].wn;
  size_t smem = 0;
  const cudaError_t e = prepare<T, SH, RX>(P0.C, &smem);
  if (e != cudaSuccess) return (int)e;
  Params P = P0;
  P.ldx = row_ld(2 * pad16(P.C), sizeof(T));
  const int grid = (P.M + 32 * WM - 1) / (32 * WM);
  fusion_gate_kernel<T, WM, WN, RX><<<grid, 32 * WM * WN, smem, s>>>(P);
  return (int)cudaGetLastError();
}

template <typename T, int SH, bool RX>
int occupancy_sh(int C) {
  size_t smem = 0;
  int per_sm = 0;
  cudaError_t e = prepare<T, SH, RX>(C, &smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fusion_gate_kernel<T, kShapes[SH].wm, kShapes[SH].wn, RX>,
        32 * kShapes[SH].wm * kShapes[SH].wn, smem);
  return e == cudaSuccess ? per_sm : -(int)e;
}

template <typename T>
int launch_t(const Params& P, cudaStream_t s) {
  const Choice ch = choice_of(P.C, sizeof(T));
  if (ch.rx) return launch_sh<T, kRingShape, true>(P, s);
  switch (ch.sh) {
    case 0: return launch_sh<T, 0, false>(P, s);
    case 1: return launch_sh<T, 1, false>(P, s);
    case 2: return launch_sh<T, 2, false>(P, s);
    case 3: return launch_sh<T, 3, false>(P, s);
    default: return launch_sh<T, 4, false>(P, s);
  }
}

template <typename T>
int occupancy_t(int C) {
  const Choice ch = choice_of(C, sizeof(T));
  if (ch.rx) return occupancy_sh<T, kRingShape, true>(C);
  switch (ch.sh) {
    case 0: return occupancy_sh<T, 0, false>(C);
    case 1: return occupancy_sh<T, 1, false>(C);
    case 2: return occupancy_sh<T, 2, false>(C);
    case 3: return occupancy_sh<T, 3, false>(C);
    default: return occupancy_sh<T, 4, false>(C);
  }
}

}  // namespace

// uint2 elements of W1's fragment array for this C (the wrapper allocates it).
extern "C" int fusion_gate_frag_uint2(int C) {
  return C > 0 ? ntiles_of(C) * ksteps_of(C) * kWTerms * 32 : 0;
}

// Rows of a block's tile and its warps, whether x streams through the ring
// (1, RX) or the tile stays resident (0), the shared memory a block uses
// and resident blocks per SM, for this C and dtype (0 = f32, 1 = bf16);
// negative on a CUDA error.
extern "C" int fusion_gate_rows(int C, int dtype) {
  if (C <= 0 || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  return 32 * kShapes[choice_of(C, dtype == 0 ? 4 : 2).sh].wm;
}
extern "C" int fusion_gate_warps(int C, int dtype) {
  if (C <= 0 || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  const Choice ch = choice_of(C, dtype == 0 ? 4 : 2);
  return kShapes[ch.sh].wm * kShapes[ch.sh].wn;
}
extern "C" int fusion_gate_streams(int C, int dtype) {
  if (C <= 0 || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  return choice_of(C, dtype == 0 ? 4 : 2).rx ? 1 : 0;
}
extern "C" int fusion_gate_smem(int C, int dtype) {
  if (C <= 0 || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  const Choice ch = choice_of(C, es);
  return (int)smem_of(C, es, ch.sh, ch.rx);
}
extern "C" int fusion_gate_occupancy(int C, int dtype) {
  if (C <= 0 || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  return dtype == 0 ? occupancy_t<float>(C) : occupancy_t<__nv_bfloat16>(C);
}

// cam, lid, out [M, C] (dtype 0 = f32, 1 = bf16); w1 [C, 2C], b1 [C],
// w2 [2, C], b2 [2] f32 (the torch layouts of attention.0 and attention.2);
// frag: scratch of fusion_gate_frag_uint2(C) uint2 (16-byte aligned), which
// the first kernel fills with W1's split fragments and the gate reads.
extern "C" int fusion_gate_fwd(const void* cam, const void* lid, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* frag,
                               void* out, int M, int C, int dtype, void* stream) {
  if (M <= 0 || C <= 0 || (dtype != 0 && dtype != 1) || reinterpret_cast<uintptr_t>(frag) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long fblocks = ((long long)ntiles_of(C) * ksteps_of(C) * 32 + kThreads - 1) / kThreads;
  const int fgrid = (int)(fblocks < 1024 ? fblocks : 1024);
  fusion_gate_fragments<<<fgrid, kThreads, 0, s>>>(static_cast<const float*>(w1),
                                                   static_cast<uint2*>(frag), C);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int es = dtype == 0 ? 4 : 2;
  Params P{};
  P.cam = cam;
  P.lid = lid;
  P.w1f = static_cast<const uint2*>(frag);
  P.b1 = static_cast<const float*>(b1);
  P.w2 = static_cast<const float*>(w2);
  P.b2 = static_cast<const float*>(b2);
  P.out = out;
  P.M = M;
  P.C = C;
  P.vec = (C * es) % 16 == 0 && reinterpret_cast<uintptr_t>(cam) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(lid) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return dtype == 0 ? launch_t<float>(P, s) : launch_t<__nv_bfloat16>(P, s);
}
