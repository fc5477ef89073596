// KD feature-matching MSE partials, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/kd_loss_pallas.py::_feature_mse_kernel
// (launched from _mse_partials): per sample b,
//
//   part[b] = sum_{m, j} (S[b, m, j] - sum_k T[b, m, k] P[k, j])^2
//
// S [B, M, Cs] and T [B, M, Ct] in f32 or bf16, P [Ct, Cs] f32, all sums
// f32. The projected teacher T.P never leaves the chip: it is a GEMM whose
// epilogue squares the difference with S and reduces it.
//
// Arithmetic: T.P runs on the bf16 tensor cores (wgmma, f32 accumulators)
// with split operands. Each f32 value v is written as bf16 terms v0 + v1 +
// v2, each the bf16 rounding of what the earlier terms left; bf16 products
// are exact in f32, so the products T_i P_j with i + j < 3 give f32-level
// T.P (the dropped ones are below 2^-26 of it). P is split once per call by
// the wrapper; f32 T is split in registers (6 products), bf16 T is one exact
// term (3 products). The tensor cores' f32 sums drift toward zero over many
// steps, so each chunk's products go to a fresh accumulator that is then
// subtracted once, rounded to nearest. ops/kd_loss.py::mse_partials_emulated
// repeats this arithmetic on the CPU, and chose three terms: two leave a
// bias of more than 1e-5 of the loss in f32 when the student is within 1e-3
// of its projected teacher (tests/test_torch_kd_split.py).
//
// Design: persistent blocks, one per SM, in groups of Cs/64 (two for the
// main path's Cs = 128): the blocks of a group walk the same 128-row tiles
// (tile = group + i * groups) at about the same pace, each computing 64 of
// the output columns, so that T is read from device memory once and from L2
// by each, and each block keeps only its 64 columns of P's three bf16 terms
// in shared memory (96 KB at Ct = 256, laid out by the wrapper as the
// warpgroup product's B operand, ops/kd_loss.py::fragment_terms; P's rows
// padded with zeros to a multiple of 64). Each of the block's two
// warpgroups owns 64 rows of the tile and runs on its own: its own ring of
// 8 KB chunks (8 slots up to Ct = 256, 4 or 2 for wider teachers), filled
// by its own threads with cp.async all but one slot ahead (across tile
// boundaries), and its own named barrier, so that one warpgroup's products
// run while the other waits for data. A warpgroup's tile is Ctp/32 (f32) or
// Ctp/64 (bf16) chunks of T's columns, then 2 (f32) or 1 (bf16) chunks of S's
// rows in the block's columns. Slots are XOR-swizzled by 16-byte chunk, not
// padded, so that the reads below hit all banks. Per k-step each warp loads
// its 16 rows of T as an A fragment (ldmatrix for bf16; f32 pairs split in
// registers), then wgmma.m64n64k16 against each needed term of P. The S
// chunks square S - T.P in the accumulator layout; each warp reduces its
// 1024 terms to one partial, and a second kernel sums each sample's
// partials in a fixed order. No float atomics: the loss is deterministic.
//
// Bound on the H100: bytes. At B=128, M=4096, Ct=256, Cs=128 the kernel
// reads 805 MB (f32) / 403 MB (bf16): 0.240 / 0.120 ms at 3.35 TB/s, against
// 6 / 3 bf16 products of 34.4 GFLOP each at 989 TFLOP/s: 0.209 / 0.104 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;            // rows per tile
constexpr int kHN = 64;             // a block's output columns
constexpr int kKP = 64;             // P's rows are padded with zeros to a multiple of this
constexpr int kThreads = 256;       // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = 3;
constexpr int kChunk = 8192;        // bytes of a ring slot
constexpr int kPBytesPerK = kHN * 2 * kTerms;  // a block's P terms, one row of K
constexpr int kPBlock = 16 * kHN * 2;          // one term of one k-step, bytes (2 KB)
constexpr int kSmemMax = 232448;               // shared memory a block may opt in to
constexpr int kReduceThreads = 256;

// A chunk of one warpgroup: T's [64 rows x BK columns] or S's [SROWS rows x
// 64 columns]; every row of a T chunk is 128 bytes.
template <typename T> struct Cfg;
template <> struct Cfg<float> {
  static constexpr int BK = 32, SROWS = 32;
};
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int BK = 64, SROWS = 64;
};

size_t smem_bytes(int Ctp, int stages) {
  return (size_t)Ctp * kPBytesPerK + (size_t)2 * stages * kChunk;
}

// Ring slots of each warpgroup that fit beside P's terms: 8, else 4, else 2.
int ring_stages(int Ctp) {
  for (int st = 8; st >= 2; st /= 2)
    if (smem_bytes(Ctp, st) <= (size_t)kSmemMax) return st;
  return 0;
}

// Element offsets in a ring slot of 16-byte chunk c of row r. The XORs
// spread the rows that one ldmatrix phase (bf16 T: 8 rows, one chunk each),
// one half-warp's 8-byte A reads (f32 T: 4 rows, two chunks each) or one
// accumulator-layout read (S) touch over all banks.
__device__ __forceinline__ int t_off(float*, int r, int c) {
  return r * 32 + ((c ^ ((r & 3) << 1)) << 2);
}
__device__ __forceinline__ int t_off(__nv_bfloat16*, int r, int c) {
  return r * 64 + ((c ^ (r & 7)) << 3);
}
__device__ __forceinline__ int s_off(const float*, int r, int c) {  // rows of 16 chunks
  return r * kHN + ((c ^ ((r & 7) << 1)) << 2);
}
__device__ __forceinline__ int s_off(const __nv_bfloat16*, int r, int c) {  // rows of 8
  return r * kHN + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> three bf16x2 terms, x0 in the low half (the lower k index).
// Each term is the bf16 rounding of what the earlier ones left; the
// differences are exact in f32.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&o)[kTerms]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(x0, hf.x), r1 = __fsub_rn(x1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y));
  o[0] = bits(h);
  o[1] = bits(m);
  o[2] = bits(l);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// The warp's A fragment of one k-step (rows rw .. rw + 15, columns kk ..
// kk + 15 of the slot) as bf16 terms: a[i] is term i (f32 T: its three
// terms; bf16 T: itself, once).
__device__ __forceinline__ void load_a(uint32_t (&a)[kTerms][4], float* slot, int rw, int kk,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  float2 v[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {  // (row g, k 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)
    const int r = rw + g + 8 * (f & 1), k = kk + 2 * t + 8 * (f >> 1);
    v[f] = *reinterpret_cast<const float2*>(slot + t_off(slot, r, k >> 2) + (k & 3));
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    uint32_t q[kTerms];
    split3(v[f].x, v[f].y, q);
#pragma unroll
    for (int i = 0; i < kTerms; ++i) a[i][f] = q[i];
  }
}
__device__ __forceinline__ void load_a(uint32_t (&a)[kTerms][4], __nv_bfloat16* slot, int rw,
                                       int kk, int lane) {
  const int r = rw + (lane & 15);
  ldmatrix_x4(a[0], smem_u32(slot + t_off(slot, r, (kk >> 3) + (lane >> 4))));
}

// Warpgroup products (bf16): D [64 x 64] f32 in 32 registers a thread, A
// [64 x 16] from registers, B [16 x 64] from shared memory through a
// descriptor.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of d across the
// asynchronous products.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Makes the threads' cp.async writes visible to the tensor cores' reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Shared-memory matrix descriptor, no swizzle, K-major: core matrices of 8
// rows x 16 bytes, `lbo` bytes apart along K and `sbo` bytes apart along N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
// d = a . B (+ d when `accumulate`).
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate), "l"(desc));
}

// S's pair (row r, block columns n, n + 1) from a ring slot.
__device__ __forceinline__ float2 s_pair(const float* slot, int r, int n) {
  return *reinterpret_cast<const float2*>(slot + s_off(slot, r, n >> 2) + (n & 3));
}
__device__ __forceinline__ float2 s_pair(const __nv_bfloat16* slot, int r, int n) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(slot + s_off(slot, r, n >> 3) + (n & 7)));
}

// Barrier of one warpgroup's 128 threads (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

template <typename T, int kStages>
__global__ void __launch_bounds__(kThreads, 1)
kd_mse_tc(const T* __restrict__ S, const T* __restrict__ Tt, const __nv_bfloat16* __restrict__ Pt,
          float* __restrict__ partials, int M, int Cs, int Ct, int Ctp, int ng,
          int tiles_per_sample, int n_tiles) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int BK = Cfg<T>::BK, SROWS = Cfg<T>::SROWS;
  constexpr int WR = kBM / 2;                        // a warpgroup's rows
  constexpr int E = 16 / (int)sizeof(T);             // elements a 16-byte copy
  constexpr int CPR = BK / E;                        // copies a T row and chunk
  constexpr int SPR = kHN / E;                       // copies an S row
  constexpr int U = WR * CPR / 128;                  // this thread's copies a chunk
  static_assert(WR * BK * (int)sizeof(T) == kChunk && SROWS * kHN * (int)sizeof(T) == kChunk &&
                    WR * CPR == SROWS * SPR && U * 128 == WR * CPR && CPR == 8,
                "chunk shapes");
  // Products T_i P_j, smallest first: f32 (i + j < 3), bf16 (i = 0).
  constexpr int NP = F32 ? 6 : 3;
  constexpr int kI[6] = {F32 ? 2 : 0, F32 ? 1 : 0, 0, 1, 0, 0};
  constexpr int kJ[6] = {0, 1, 2, 0, 1, 0};
  constexpr int kJb[3] = {2, 1, 0};
  extern __shared__ float4 smem4[];
  const uint32_t p_base = smem_u32(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wt = tid & 127;          // warpgroup, thread in it
  const int g = lane >> 2, t = lane & 3;
  // A group of ng blocks shares each tile; block `part` computes columns
  // [64 part, +64).
  const int part = blockIdx.x % ng, grp = blockIdx.x / ng, groups = gridDim.x / ng;
  const int n0 = part * kHN;
  const int kch = Ctp / BK;
  const int cpt = kch + WR / SROWS;  // a warpgroup's chunks per tile: T's, then S's
  const int my_tiles = (n_tiles - grp + groups - 1) / groups;
  T* ring = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) + (size_t)Ctp * kPBytesPerK +
                                 (size_t)wg * kStages * kChunk);

  // The block's part of P's terms (its 2 KB of each k-step and term), read
  // by both warpgroups' products, before anything else.
  for (int i = tid; i < Ctp * kPBytesPerK / 16; i += kThreads) {
    const int blk = i / (kPBlock / 16), off = i % (kPBlock / 16);
    cp_async16(p_base + 16 * i,
               reinterpret_cast<const char*>(Pt) + ((size_t)blk * ng + part) * kPBlock + 16 * off,
               true);
  }
  cp_commit();
  cp_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // Each warpgroup runs on its own: its 64 rows of each tile stream through
  // its own ring, under its own barrier. The producer: chunk (p_tile, p_kc)
  // goes to slot p_q % kStages; T's columns [p_kc * BK, +BK) for p_kc < kch,
  // else S's rows [(p_kc - kch) * SROWS, +SROWS) of the warpgroup's rows in
  // the block's columns. Rows past M and columns past Cs are zeros.
  int p_tile = 0, p_kc = 0, p_q = 0, p_m0 = 0;
  const T* p_t = Tt;
  const T* p_s = S;
  auto start_tile = [&]() {
    const int tile = grp + p_tile * groups;
    const int b = tile / tiles_per_sample;
    p_m0 = (tile - b * tiles_per_sample) * kBM + wg * WR;
    p_t = Tt + ((size_t)b * M + p_m0) * Ct;
    p_s = S + ((size_t)b * M + p_m0) * Cs;
  };
  auto issue = [&]() {
    if (p_tile < my_tiles) {
      T* slot = ring + (size_t)(p_q % kStages) * (kChunk / sizeof(T));
      if (p_kc < kch) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int idx = wt + u * 128;
          const int r = idx / CPR, c = idx % CPR;
          const bool valid = p_m0 + r < M && p_kc * BK + c * E < Ct;
          cp_async16(smem_u32(slot + t_off(slot, r, c)),
                     valid ? (const void*)(p_t + (size_t)r * Ct + p_kc * BK + c * E) : Tt,
                     valid);
        }
      } else {
        const int r0 = (p_kc - kch) * SROWS;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int idx = wt + u * 128;
          const int r = idx / SPR, c = idx % SPR;
          const bool valid = p_m0 + r0 + r < M && n0 + c * E < Cs;
          cp_async16(smem_u32(slot + s_off(slot, r, c)),
                     valid ? (const void*)(p_s + (size_t)(r0 + r) * Cs + n0 + c * E) : S, valid);
        }
      }
      ++p_q;
      if (++p_kc == cpt) {
        p_kc = 0;
        if (++p_tile < my_tiles) start_tile();
      }
    }
    cp_commit();
  };
  if (my_tiles > 0) start_tile();
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) issue();

  // Warp w holds the warpgroup's rows lr .. lr + 15: acc[4 j + 2 h + e] at
  // row lr + g + 8 h, block column 8 j + 2 t + e. acc ends as -T.P; the S
  // chunks give S - T.P = S + acc, squared and summed. B for k-step s and
  // term i is the block's [8 n-groups][2 k-halves][8 x 8] part of P's block:
  // core matrices 128 bytes apart along K and 256 along N.
  float acc[32], tmp[32];
  const int lr = 16 * (warp & 3);
  int q = 0;
  for (int i = 0; i < my_tiles; ++i) {
    for (int kc = 0; kc < kch; ++kc, ++q) {
      cp_wait<kStages - 2>();
      wg_sync(wg);
      issue();
      T* slot = ring + (size_t)(q % kStages) * (kChunk / sizeof(T));
      fence_regs(tmp);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[kTerms][4];
        load_a(a, slot, lr, 16 * kk, lane);
        wgmma_fence();
#pragma unroll
        for (int pr = 0; pr < NP; ++pr) {
          const int ks = kc * (BK / 16) + kk;
          const int pj = F32 ? kJ[pr] : kJb[pr];
          wgmma_bf16(tmp, a[kI[pr]], smem_desc(p_base + (ks * kTerms + pj) * kPBlock, 128, 256),
                     !(kk == 0 && pr == 0));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(tmp);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = __fsub_rn(kc == 0 ? 0.f : acc[e], tmp[e]);
    }
    float sum = 0.f;
    for (int c = 0; c < WR / SROWS; ++c, ++q) {
      cp_wait<kStages - 2>();
      wg_sync(wg);
      issue();
      if (lr / SROWS != c) continue;
      const T* slot = ring + (size_t)(q % kStages) * (kChunk / sizeof(T));
      const int rl = lr + g - c * SROWS;
#pragma unroll
      for (int j = 0; j < kHN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = s_pair(slot, rl + 8 * h, 8 * j + 2 * t);
          const float d0 = v.x + acc[4 * j + 2 * h], d1 = v.y + acc[4 * j + 2 * h + 1];
          sum = fmaf(d0, d0, sum);
          sum = fmaf(d1, d1, sum);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (lane == 0)
      partials[((size_t)(grp + i * groups) * ng + part) * kWarps + warp] = sum;
  }
  cp_wait<0>();
}

// out[b] = sum of sample b's n partials, in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
kd_mse_reduce(const float* __restrict__ partials, float* __restrict__ out, int n) {
  __shared__ float warp_sums[kReduceThreads / 32];
  const float* pb = partials + (size_t)blockIdx.x * n;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) s += pb[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kReduceThreads / 32; ++w) t += warp_sums[w];
    out[blockIdx.x] = t;
  }
}

template <typename T, int kStages>
int launch(const void* S, const void* Tt, const void* Pt, float* part, float* out, int B, int M,
           int Cs, int Ct, cudaStream_t s) {
  const int Ctp = (Ct + kKP - 1) / kKP * kKP;
  const size_t smem = smem_bytes(Ctp, kStages);
  cudaError_t e = cudaFuncSetAttribute(kd_mse_tc<T, kStages>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int ng = (Cs + kHN - 1) / kHN;
  const int tps = (M + kBM - 1) / kBM;
  const long long n_tiles = (long long)B * tps;
  if (n_tiles * ng > 0x3fffffffLL || sms < ng) return (int)cudaErrorInvalidValue;
  const int groups = (int)(n_tiles < sms / ng ? n_tiles : sms / ng);
  kd_mse_tc<T, kStages><<<groups * ng, kThreads, smem, s>>>(
      static_cast<const T*>(S), static_cast<const T*>(Tt), static_cast<const __nv_bfloat16*>(Pt),
      part, M, Cs, Ct, Ctp, ng, tps, (int)n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kd_mse_reduce<<<B, kReduceThreads, 0, s>>>(part, out, tps * ng * kWarps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stages(const void* S, const void* Tt, const void* Pt, float* part, float* out, int B,
                  int M, int Cs, int Ct, cudaStream_t s) {
  switch (ring_stages((Ct + kKP - 1) / kKP * kKP)) {
    case 8: return launch<T, 8>(S, Tt, Pt, part, out, B, M, Cs, Ct, s);
    case 4: return launch<T, 4>(S, Tt, Pt, part, out, B, M, Cs, Ct, s);
    case 2: return launch<T, 2>(S, Tt, Pt, part, out, B, M, Cs, Ct, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Number of per-warp partials of one sample (the wrapper sizes the scratch
// buffer [B, n] with it).
extern "C" int kd_feature_mse_partials_per_sample(int M, int Cs) {
  return ((M + kBM - 1) / kBM) * ((Cs + kHN - 1) / kHN) * kWarps;
}

// S [B, M, Cs], T [B, M, Ct] (dtype 0 = f32, 1 = bf16, both the same, 16-byte
// aligned), P as its bf16 terms in the layout of ops/kd_loss.py::
// fragment_terms ([Ctp/16][3][Csp/8][2][8][8], rows zero-padded to Ctp, a
// multiple of 64, and columns to Csp, a multiple of 64), scratch [B,
// partials_per_sample] f32, out [B] f32. Cs % 8 == 0, Ct % 8 == 0, Ctp <= 512.
extern "C" int kd_feature_mse(const void* S, const void* T, const void* P, void* scratch,
                              void* out, int B, int M, int Cs, int Ct, int dtype,
                              void* stream) {
  if (B <= 0 || M <= 0 || Cs <= 0 || Cs % 8 || Ct <= 0 || Ct % 8 || Ct > 512 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch_stages<float>(S, T, P, part, o, B, M, Cs, Ct, s);
  if (dtype == 1) return launch_stages<__nv_bfloat16>(S, T, P, part, o, B, M, Cs, Ct, s);
  return (int)cudaErrorInvalidValue;
}
