// Fused InvertedResidual training, pass 3: BN2 + ReLU6 + project 1x1, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/ir_fused.py::_proj_kernel (launched
// from _ir_train_forward once per 128-lane hidden chunk, grid (B,), the
// chunks' partial products added in XLA):
//
//   d_act = relu6(d * s2 + b2) rounded to the input dtype
//   y     = d_act . W2                       (f32 out)
//
// d [M, Ce] (M = B*Ho*Wo, NHWC) in f32 or bf16, s2/b2 [Ce] f32 (BN2 folded
// with the batch statistics), W2 [Ce, Cout] as the pre-split mma fragments
// of its input-dtype values (ops/ir_fused.py::mma_fragments). One launch
// covers every hidden channel: the sum over Ce is one f32 accumulation in
// registers.
//
// Design: a tensor-core GEMM (mma.sync.m16n8k16, bf16 in, f32 accumulate,
// through mma_step of ir_train_common.cuh) whose A-operand staging is the
// BN2 + ReLU6 prologue. A block owns BM pixels x BN output channels (BN =
// 128, BM = 128 when Cout > 64; else BN = 64, BM = 256) and walks Ce in
// k-chunks of one 128-byte row of d (32 f32 or 64 bf16 channels). Each
// chunk's d tile and W2's fragments for it are copied into a two-stage
// ring with cp.async, the next chunk's copy in flight while the current
// one multiplies. Each warp owns 32 pixels x 64 channels (2 x 8 mma tiles):
// per k-step it forms its A fragments from the staged d (scale_shift, relu6
// and round_to<T> once per element, with s2 and b2 for all of Ce held in
// shared memory), splits them into bf16 terms (f32: three, split3; bf16:
// one exact term) and multiplies them against each n-tile's fragment. The
// f32 sum follows mma_step's rule: a fresh accumulator per 16-channel
// k-step, added with __fadd_rn (the tensor cores' f32 sums drift toward
// zero otherwise). Two blocks share an SM.
//
// y has no bit-identity partner (K11 does not recompute it), so the tiling
// is free. Bound on the H100: f32 issues six bf16 products per f32-level
// product, 6 * 2*M*Ce*Cout at 989 TFLOP/s, which bounds the student's last
// stage (Ce 768 -> Cout 128); the other stages and every bf16 stage are
// bound by reading d and writing y (chip_smoke.py counts both).

#include "ir_train_common.cuh"

namespace {

using namespace irt;

constexpr int kStages = 2;  // cp.async ring depth

// Channels of d a k-chunk: one 128-byte staged row.
template <typename T> __host__ __device__ constexpr int chunk_c() { return 128 / (int)sizeof(T); }

// Block tile of a launch with WN warps along N (1 or 2): BN = 64 WN output
// channels, BM = 256 / WN pixels.
__host__ __device__ constexpr int bm_of(int wn) { return 256 / wn; }
__host__ __device__ constexpr int bn_of(int wn) { return 64 * wn; }

// Shared memory: kStages x (d tile [BM][chunk] of T, W2's fragments of the
// chunk [BN/8][chunk/16][terms][32] uint2), then (s2, b2) pairs for every
// channel of Ce, zero past it.
size_t smem_of(int Ce, int wn, int es) {
  const int kc = 128 / es, terms = es == 4 ? kTerms : 1;
  const size_t stage = (size_t)bm_of(wn) * 128 + (size_t)bn_of(wn) / 8 * (kc / 16) * terms * 256;
  const size_t nchunk = (Ce + kc - 1) / kc;
  return kStages * stage + nchunk * kc * sizeof(float2);
}

int wn_of(int Cout) { return Cout > 64 ? 2 : 1; }

// Two values at (row r, channel k) of a staged d tile (rows of 128 bytes,
// 16-byte chunks swizzled by x_chunk), as f32.
__device__ __forceinline__ float2 staged_pair(const float* t, int r, int k) {
  return *reinterpret_cast<const float2*>(t + r * 32 + x_chunk<float>(r, k >> 2) * 4 + (k & 3));
}
__device__ __forceinline__ float2 staged_pair(const __nv_bfloat16* t, int r, int k) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      t + r * 64 + x_chunk<__nv_bfloat16>(r, k >> 3) * 8 + (k & 7)));
}

__device__ __forceinline__ float2 as_pair(float a, float b, float) { return make_float2(a, b); }
__device__ __forceinline__ uint32_t as_pair(float a, float b, __nv_bfloat16) {
  return bf2_bits(__floats2bfloat162_rn(a, b));
}

template <typename T, int WN>
__global__ void __launch_bounds__(kThreads, 2)
proj_kernel(const T* __restrict__ d, const float* __restrict__ s2, const float* __restrict__ b2,
            const uint2* __restrict__ wf, float* __restrict__ y, long long M, int Ce, int Cout,
            int ks_w, int np8, int vec16) {
  constexpr int NT = Mma<T>::terms;
  constexpr int KC = chunk_c<T>();     // channels a chunk
  constexpr int KS = KC / 16;          // k-steps a chunk
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int BM = bm_of(WN), BN = bn_of(WN);
  constexpr int DS = BM * KC;                    // elements of T in a d tile
  constexpr int WS = BN / 8 * KS * NT * 32;      // uint2 of a fragment chunk
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* ds = reinterpret_cast<T*>(smem);                                        // [kStages][DS]
  uint2* ws = reinterpret_cast<uint2*>(smem + (size_t)kStages * DS * sizeof(T));  // [kStages][WS]
  float2* sb = reinterpret_cast<float2*>(ws + (size_t)kStages * WS);         // [nchunk * KC]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % WN, wm = warp / WN;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nchunk = (Ce + KC - 1) / KC;
  // n-tiles of this warp's 8 that hold output channels (uniform per warp).
  const int njv = min(8, max(0, (Cout - n0 - 64 * wn + 7) / 8));

  for (int i = tid; i < nchunk * KC; i += kThreads)
    sb[i] = i < Ce ? make_float2(s2[i], b2[i]) : make_float2(0.f, 0.f);

  // Chunk c of d (rows m0.., zero past M and Ce) and of W2's fragments
  // (n-tiles n0/8.., zero past the fragment array) into ring slot s.
  auto issue = [&](int c, int s) {
    T* dt = ds + (size_t)s * DS;
    const int c0 = c * KC;
    for (int i = tid; i < BM * 8; i += kThreads) {
      const int r = i >> 3, q = i & 7;
      const long long row = m0 + r;
      const int col = c0 + q * E;
      T* dst = dt + r * KC + x_chunk<T>(r, q) * E;
      if (vec16) {
        const bool ok = row < M && col < Ce;
        cp_async16(dst, ok ? (const void*)(d + row * Ce + col) : (const void*)d, ok);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          dst[e] = row < M && col + e < Ce ? d[row * Ce + col + e] : from_f<T>(0.f);
      }
    }
    constexpr int per = KS * NT * 16;  // 16-byte pieces of one n-tile's chunk
    uint2* wdst = ws + (size_t)s * WS;
    for (int i = tid; i < BN / 8 * per; i += kThreads) {
      const int j = i / per, p = i - j * per;
      const int nt = n0 / 8 + j;
      const bool ok = nt < np8;
      cp_async16(wdst + (size_t)j * KS * NT * 32 + 2 * p,
                 ok ? (const void*)(wf + ((size_t)nt * ks_w + (size_t)c * KS) * NT * 32 + 2 * p)
                    : (const void*)wf,
                 ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0.f;

  issue(0, 0);
  cp_commit();
  for (int c = 0; c < nchunk; ++c) {
    const int s = c % kStages;
    cp_wait<0>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1's slot
    if (c + 1 < nchunk) issue(c + 1, (c + 1) % kStages);
    cp_commit();
    const T* dt = ds + (size_t)s * DS;
    const uint2* wt = ws + (size_t)s * WS;
    const float2* sbc = sb + c * KC;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // A: d_act of rows 32 wm + 16 mt + g (+8), channels 16 ks + 2t (+8).
      float2 sv[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) sv[h][e] = sbc[16 * ks + 2 * t + 8 * h + e];
      uint32_t a[2][NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        typename Mma<T>::Pair xa[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int r = 32 * wm + 16 * mt + g + 8 * (f & 1), h = f >> 1;
          const float2 v = staged_pair(dt, r, 16 * ks + 2 * t + 8 * h);
          xa[f] = as_pair(round_to<T>(relu6(scale_shift(v.x, sv[h][0].x, sv[h][0].y))),
                          round_to<T>(relu6(scale_shift(v.y, sv[h][1].x, sv[h][1].y))), T());
        }
        terms_of(a[mt], xa);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= njv) break;
        uint32_t b[NT][2];
        smem_b<T>(b, wt + ((size_t)(8 * wn + j) * KS + ks) * NT * 32, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_step<NT, NT>(acc[mt][j], a[mt], b);
      }
    }
  }

  const bool pairs = (Cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + 32 * wm + 16 * mt + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= njv) break;
        const int col = n0 + 64 * wn + 8 * j + 2 * t;
        float* o = y + row * Cout + col;
        if (pairs && col < Cout) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        } else {
          if (col < Cout) o[0] = acc[mt][j][2 * h];
          if (col + 1 < Cout) o[1] = acc[mt][j][2 * h + 1];
        }
      }
    }
}

template <typename T, int WN>
cudaError_t prepare(int Ce, size_t* smem) {
  *smem = smem_of(Ce, WN, sizeof(T));
  return cudaFuncSetAttribute(proj_kernel<T, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <typename T, int WN>
int launch(const T* d, const float* s2, const float* b2, const uint2* wf, float* y, long long M,
           int Ce, int Cout, int ks_w, int np8, int vec16, cudaStream_t s) {
  size_t smem = 0;
  const cudaError_t e = prepare<T, WN>(Ce, &smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((M + bm_of(WN) - 1) / bm_of(WN)), (Cout + bn_of(WN) - 1) / bn_of(WN));
  proj_kernel<T, WN><<<grid, kThreads, smem, s>>>(d, s2, b2, wf, y, M, Ce, Cout, ks_w, np8, vec16);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy_t(int Ce, int Cout) {
  size_t smem = 0;
  int per_sm = 0;
  cudaError_t e;
  if (wn_of(Cout) == 2) {
    e = prepare<T, 2>(Ce, &smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, proj_kernel<T, 2>, kThreads, smem);
  } else {
    e = prepare<T, 1>(Ce, &smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, proj_kernel<T, 1>, kThreads, smem);
  }
  return e == cudaSuccess ? per_sm : -(int)e;
}

}  // namespace

// Shared memory a block uses, and resident blocks per SM, for this Ce,
// Cout and dtype (0 = f32, 1 = bf16); negative on a CUDA error.
extern "C" int ir_train_proj_smem(int Ce, int Cout, int dtype) {
  if (Ce <= 0 || Cout <= 0 || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  return (int)smem_of(Ce, wn_of(Cout), dtype == 0 ? 4 : 2);
}
extern "C" int ir_train_proj_occupancy(int Ce, int Cout, int dtype) {
  if (Ce <= 0 || Cout <= 0 || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  return dtype == 0 ? occupancy_t<float>(Ce, Cout) : occupancy_t<__nv_bfloat16>(Ce, Cout);
}

// d [M, Ce] (dtype 0 = f32, 1 = bf16), s2/b2 [Ce] f32, w2f the mma
// fragments of W2 [Ce, Cout] (ks_w k-steps and np8 n-tiles:
// ops/ir_fused.py::mma_fragments), y [M, Cout] f32 out.
extern "C" int ir_train_proj(const void* d, const void* s2, const void* b2, const void* w2f,
                             void* y, long long M, int Ce, int Cout, int ks_w, int np8, int dtype,
                             void* stream) {
  if (M <= 0 || Ce <= 0 || Cout <= 0 || (dtype != 0 && dtype != 1) || ks_w * 16 < Ce ||
      np8 * 8 < Cout || (M + 127) / 128 > 0x7fffffffLL || (Cout + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sv = static_cast<const float*>(s2);
  const float* bv = static_cast<const float*>(b2);
  const uint2* wf = static_cast<const uint2*>(w2f);
  float* out = static_cast<float*>(y);
  const int E = dtype == 0 ? 4 : 8;
  const int vec16 = Ce % E == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0;
  if (dtype == 0) {
    const float* dp = static_cast<const float*>(d);
    return wn_of(Cout) == 2 ? launch<float, 2>(dp, sv, bv, wf, out, M, Ce, Cout, ks_w, np8, vec16, s)
                            : launch<float, 1>(dp, sv, bv, wf, out, M, Ce, Cout, ks_w, np8, vec16, s);
  }
  const __nv_bfloat16* dp = static_cast<const __nv_bfloat16*>(d);
  return wn_of(Cout) == 2
             ? launch<__nv_bfloat16, 2>(dp, sv, bv, wf, out, M, Ce, Cout, ks_w, np8, vec16, s)
             : launch<__nv_bfloat16, 1>(dp, sv, bv, wf, out, M, Ce, Cout, ks_w, np8, vec16, s);
}
