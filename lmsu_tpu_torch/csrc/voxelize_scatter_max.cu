// BEV scatter-max over UNSORTED points, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmsu_tpu/ops/voxelize_pallas.py::_scatter_max_kernel
// (launched from _forward). The TPU kernel keeps one image's whole
// [HW, C] grid in VMEM (2 MB at 64x64 cells, C=128, f32) and updates one
// row per point in a serial loop. A Hopper block has at most 227 KB of
// shared memory, so this kernel cuts the grid by channels: a work item is
// (image, slice of `slice` channels), and its block keeps the item's
// [slice, HW] accumulator in shared memory and takes one shared-memory
// atomic max per point and channel. Invalid points (index outside [0, HW))
// are skipped; a cell no point touched is written as exactly 0.
//
// What bounds it: bytes. Each valid point's row is read once and the
// output written once: at B=128, C=128, f32, 301 MB + 268 MB over
// 3.35 TB/s = 0.155 ms (the index array, 2.6 MB, is re-read C / slice
// times, from L2).
//
// What held the first design back (1.068 ms at B=128 C=128 f32, 15% of its
// bound; bf16 no faster): latency, not bytes. One block of 16 warps a SM
// (its 128 KB accumulator), and each thread's loop step loaded the point's
// cell, branched on it, and only then loaded the point's 4-byte channel: two
// dependent loads, about 2 KB in flight per SM where the card needs about
// 20 KB (3.35 TB/s x ~0.8 us over 132 SMs). The -inf fill, the stream and
// a 4-byte strided write-out ran one after another.
//
// This design:
// - Keys, not floats. The accumulator holds order-preserving uint32 keys
//   (x >= 0: bits | 0x80000000; x < 0: ~bits), 0 meaning untouched. Keys
//   order as the floats do, with -0.0 below +0.0, so one unsigned
//   atomicMax is the update, the fill is a zero fill, and the write-out
//   turns key 0 into 0.0. A max takes no rounding: any order of updates
//   gives the same bits, so the result is exact and deterministic. bf16 is
//   widened to f32 bits (exact). A NaN of either sign takes the largest
//   key (0xffffffff, written back as the NaN 0x7fffffff): a cell holding a
//   NaN is NaN, as the reference's max gives it.
// - Loads in flight, held in registers. A thread owns one 16-byte vector
//   of the slice (4 f32 or 8 bf16 channels; a slice of 8 is two threads
//   a point in f32, one in bf16) and takes kU = 4 points a batch. The
//   batch's kU index loads and kU row loads are independent of each other
//   and of the cell's value (a point's row is loaded whether or not it is
//   valid), and the next batch's loads are issued before this batch's
//   atomics: 1,024 threads x kU x 16 B = 64 KB a SM in flight. This was
//   chosen over a cp.async / TMA ring in shared memory because the
//   accumulator takes 128 KB of the SM's 227 KB; the registers hold the
//   ring instead, and no barrier orders a producer and its consumers.
// - Persistent blocks over (image, slice) items, dealt round-robin, so the
//   blocks in flight hold the slices of a few images at once: the 32-byte
//   sectors of a point's row (and of a cell's output row) that its slices
//   share meet in L2, and so do the index re-reads. A block's next item's
//   first batch is loaded before this item's write-out, so its loads run
//   under the write-out, which also zeroes each key it reads (the next
//   item's fill) and stores 16-byte vectors.
// - Skew: every point takes its own atomics. Combining a warp's points that
//   share a cell first (__match_any_sync, then __reduce_max_sync of their
//   keys, one atomic a cell) was measured slower on the H100, on the
//   uniform cloud and on the skewed one (2,000 of 5,000 points in one cell)
//   alike: see PERF.md.
// - The accumulator is channel-major, [slice][ld] with ld = 1 mod 32, so
//   the atomics of one warp's points spread over the banks by cell.
// A thread-block cluster (CTAs owning shares of the cells of a wider slice,
// fed by one multicast load) would read the indices fewer times and bf16
// rows in full sectors; it is not taken: see PERF.md for what the
// measurement of this design leaves to gain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSlice = 8;  // channels an item
constexpr int kU = 4;         // points a thread loads per batch

// A NaN of either sign takes the largest key, so that it wins the max as
// the reference's max keeps it; the other keys order as the floats do.
__device__ __forceinline__ uint32_t key_of(uint32_t bits) {
  if ((bits & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}
// f32 bits of a nonzero key (the largest key gives back 0x7fffffff, a NaN).
__device__ __forceinline__ uint32_t bits_of(uint32_t key) {
  return (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
}

// V consecutive elements of T as raw words: f32 one word an element, bf16
// two elements a word (lower element in the low half).
template <typename T, int V, bool VEC>
struct Row {
  static constexpr int BYTES = V * (int)sizeof(T);
  static constexpr int W = BYTES >= 4 ? BYTES / 4 : 1;
  uint32_t w[W];

  // VEC: one aligned vector load; else V scalar loads, the first n valid.
  __device__ __forceinline__ void load(const T* p, int n) {
    if (VEC) {
      if constexpr (BYTES == 16) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
      } else if constexpr (BYTES == 8) {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = q.x; w[1] = q.y;
      } else if constexpr (BYTES == 4) {
        w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
      } else {
        w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
      }
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) w[i] = 0u;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (e >= n) break;
        if constexpr (sizeof(T) == 4) {
          w[e] = __ldg(reinterpret_cast<const unsigned int*>(p) + e);
        } else {
          const uint32_t h = __ldg(reinterpret_cast<const unsigned short*>(p) + e);
          w[e >> 1] |= h << (16 * (e & 1));
        }
      }
    }
  }
  // f32 bits of element e.
  __device__ __forceinline__ uint32_t bits(int e) const {
    if constexpr (sizeof(T) == 4) return w[e];
    else return (e & 1) ? (w[e >> 1] & 0xffff0000u) : (w[e >> 1] << 16);
  }
};

// Stores V values (f32 bits, exact in T) at p: one vector store when VEC,
// else the first n elements one by one.
template <typename T, int V, bool VEC>
__device__ __forceinline__ void store_row(T* p, const uint32_t (&b)[V], int n) {
  constexpr int BYTES = V * (int)sizeof(T);
  uint32_t w[BYTES >= 4 ? BYTES / 4 : 1];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < V; ++e) w[e] = b[e];
  } else {
#pragma unroll
    for (int i = 0; i < (BYTES >= 4 ? BYTES / 4 : 1); ++i) w[i] = 0u;
#pragma unroll
    for (int e = 0; e < V; ++e) w[e >> 1] |= (b[e] >> 16) << (16 * (e & 1));
  }
  if (VEC) {
    if constexpr (BYTES == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (BYTES == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (BYTES == 4) {
      *reinterpret_cast<unsigned int*>(p) = w[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)w[0];
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (e >= n) break;
      if constexpr (sizeof(T) == 4) reinterpret_cast<unsigned int*>(p)[e] = w[e];
      else reinterpret_cast<unsigned short*>(p)[e] = (unsigned short)(w[e >> 1] >> (16 * (e & 1)));
    }
  }
}

struct Params {
  const void* feats;
  const int* idx;
  void* out;
  int B, N, C, HW, slice, nslices, ld, nbatch;
};

template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
voxelize_scatter_max_kernel(const Params P) {
  extern __shared__ uint4 smem4[];
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem4);  // [slice][ld] keys
  const T* __restrict__ feats = static_cast<const T*>(P.feats);
  T* __restrict__ out = static_cast<T*>(P.out);
  const int tid = threadIdx.x;
  const int tp = P.slice / V;           // threads a point
  const int h = tid % tp;               // this thread's vector of the slice
  const int ppass = kThreads / tp;      // points a pass
  const int pt = tid / tp;
  // Items blockIdx.x, + gridDim.x, ...: the blocks in flight at any time
  // hold consecutive items, the slices of a few images, so the sectors of
  // a point's row and of an output row that their slices share meet in L2.
  const int words4 = (P.slice * P.ld + 3) / 4;

  for (int i = tid; i < words4; i += kThreads) smem4[i] = make_uint4(0u, 0u, 0u, 0u);

  // A step is (item, batch): kU points a thread; an item is (image b,
  // slice sl), item number b * nslices + sl. The counters advance without
  // divisions per step: batch by batch, then gridDim.x items on.
  struct Step { int b, sl, bi; };
  const int db = gridDim.x / P.nslices, dsl = gridDim.x - db * P.nslices;
  auto advance = [&](Step& st) {
    if (++st.bi < P.nbatch) return;
    st.bi = 0;
    st.b += db;
    st.sl += dsl;
    if (st.sl >= P.nslices) {
      st.sl -= P.nslices;
      ++st.b;
    }
  };
  // One batch: the kU points of a step, their cells (-1 past N or past C)
  // and this thread's vector of their rows.
  struct Batch {
    int cell[kU];
    Row<T, V, VEC> row[kU];
  };
  auto load = [&](const Step& st, Batch& bt) {
    const int b = st.b, bi = st.bi;
    const int c = st.sl * P.slice + h * V;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int p = (bi * kU + u) * ppass + pt;
      bt.cell[u] = -1;
      if (p < P.N && c < P.C) {
        const size_t r = (size_t)b * P.N + p;
        bt.cell[u] = __ldg(P.idx + r);
        bt.row[u].load(feats + r * P.C + c, P.C - c);
      } else {
#pragma unroll
        for (int i = 0; i < Row<T, V, VEC>::W; ++i) bt.row[u].w[i] = 0u;
      }
    }
  };

  const int b0 = blockIdx.x / P.nslices;
  Step st = {b0, (int)blockIdx.x - b0 * P.nslices, 0};  // this step
  Step nx = st;                                         // the next load
  Batch cur;
  if (nx.b < P.B) {
    load(nx, cur);
    advance(nx);
  }
  // The fill is done before any thread's first atomic (the first batch's
  // loads are already issued). Later items need no barrier of their own:
  // the write-out's closing barrier orders their zeroing.
  __syncthreads();
  while (st.b < P.B) {
    Batch nxt;
    if (nx.b < P.B) {
      load(nx, nxt);
      advance(nx);
    }
    const int b = st.b;
    const int c0 = st.sl * P.slice, c = c0 + h * V;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int cell = cur.cell[u];
      if (cell < 0 || cell >= P.HW) continue;
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (c + e < P.C) atomicMax(acc + (h * V + e) * P.ld + cell, key_of(cur.row[u].bits(e)));
    }
    if (st.bi == P.nbatch - 1) {
      // Write the item out (0 where untouched) and zero each key read: the
      // next item's fill. The next item's first batch is already loading.
      __syncthreads();
      T* ob = out + (size_t)b * P.HW * P.C + c0;
      for (int i = tid; i < P.HW * tp; i += kThreads) {
        const int cell = i / tp, hh = i - cell * tp;
        const int cc = c0 + hh * V;
        if (cc >= P.C) continue;
        uint32_t v[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          uint32_t* a = acc + (hh * V + e) * P.ld + cell;
          const uint32_t kk = *a;
          *a = 0u;
          v[e] = kk ? bits_of(kk) : 0u;
        }
        store_row<T, V, VEC>(ob + (size_t)cell * P.C + hh * V, v, P.C - cc);
      }
      __syncthreads();
    }
    advance(st);
    cur = nxt;
  }
}

struct Plan {
  int slice = 0, vec = 0, ld = 0, per_sm = 0, nbatch = 0;
  size_t smem = 0;
  long long items = 0, grid = 0;
};

// The widest slice (8, 4, 2, 1 channels) whose accumulator fits a block's
// shared memory; ld pads HW to 1 mod 32 where a padded row still fits.
cudaError_t plan_of(int B, int N, int C, int HW, int es, Plan* L) {
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const long long padded = ((long long)HW + 31) / 32 * 32 + 1;
  auto bytes = [](long long s, long long ld) { return (s * ld + 3) / 4 * 16; };
  for (int s = kMaxSlice; s >= 1; s /= 2) {
    const long long ld = s > 1 ? padded : HW;
    if (bytes(s, ld) <= max_smem) {
      L->slice = s;
      L->ld = (int)ld;
      L->smem = (size_t)bytes(s, ld);
      break;
    }
  }
  if (!L->slice) return cudaErrorInvalidValue;
  const int per_vec = 16 / es;
  L->vec = L->slice < per_vec ? L->slice : per_vec;
  const int ppass = kThreads / (L->slice / L->vec);
  L->nbatch = (N + ppass * kU - 1) / (ppass * kU);
  L->items = (long long)B * ((C + L->slice - 1) / L->slice);
  return cudaSuccess;
}

template <typename T, int V, bool VEC>
cudaError_t run(const Params& p, Plan* L, bool launch, cudaStream_t s) {
  const auto kernel = voxelize_scatter_max_kernel<T, V, VEC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L->smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&L->per_sm, kernel, kThreads, L->smem);
  if (e != cudaSuccess) return e;
  if (L->per_sm <= 0) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long g = (long long)L->per_sm * sms;
  L->grid = L->items < g ? L->items : g;
  if (!launch) return cudaSuccess;
  kernel<<<(unsigned)L->grid, kThreads, L->smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, Plan* L, bool vec, bool launch, cudaStream_t s) {
  switch (L->vec) {
    case 1: return vec ? run<T, 1, true>(p, L, launch, s) : run<T, 1, false>(p, L, launch, s);
    case 2: return vec ? run<T, 2, true>(p, L, launch, s) : run<T, 2, false>(p, L, launch, s);
    case 4: return vec ? run<T, 4, true>(p, L, launch, s) : run<T, 4, false>(p, L, launch, s);
    default:
      if constexpr (sizeof(T) == 2)
        return vec ? run<T, 8, true>(p, L, launch, s) : run<T, 8, false>(p, L, launch, s);
      return cudaErrorInvalidValue;
  }
}

// Plans (and with `launch`, runs) one call.
cudaError_t call(const void* feats, const void* idx, void* out, int B, int N, int C, int HW,
                 int dtype, bool launch, Plan* L, cudaStream_t s) {
  if (B <= 0 || N <= 0 || C <= 0 || HW <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  cudaError_t e = plan_of(B, N, C, HW, es, L);
  if (e != cudaSuccess) return e;
  // Vector loads and stores need whole, aligned vectors of at least 4 bytes.
  const int vb = L->vec * es;
  const bool vec = vb >= 4 && C % L->vec == 0 &&
                   reinterpret_cast<uintptr_t>(feats) % vb == 0 &&
                   reinterpret_cast<uintptr_t>(out) % vb == 0;
  Params p;
  p.feats = feats;
  p.idx = static_cast<const int*>(idx);
  p.out = out;
  p.N = N; p.C = C; p.HW = HW;
  p.slice = L->slice;
  p.nslices = (C + L->slice - 1) / L->slice;
  p.ld = L->ld;
  p.nbatch = L->nbatch;
  p.B = B;
  return dtype == 0 ? dispatch<float>(p, L, vec, launch, s)
                    : dispatch<__nv_bfloat16>(p, L, vec, launch, s);
}

}  // namespace

// The plan of a call, into out[4]: slice (channels an item), shared memory
// a block (bytes), resident blocks per SM, blocks launched. Returns the CUDA
// error (0 on success).
extern "C" int voxelize_scatter_max_plan(int B, int N, int C, int HW, int dtype, void* out) {
  Plan L;
  const cudaError_t e = call(reinterpret_cast<const void*>(16), nullptr,
                             reinterpret_cast<void*>(16), B, N, C, HW, dtype, false, &L, nullptr);
  if (e != cudaSuccess) return (int)e;
  int* o = static_cast<int*>(out);
  o[0] = L.slice; o[1] = (int)L.smem; o[2] = L.per_sm; o[3] = (int)L.grid;
  return 0;
}

// feats [B, N, C] (dtype 0 = f32, 1 = bf16), idx [B, N] int32 in [0, HW]
// (HW for invalid points), out [B, HW, C] of the feature dtype.
extern "C" int voxelize_scatter_max(const void* feats, const void* idx, void* out, int B,
                                    int N, int C, int HW, int dtype, void* stream) {
  Plan L;
  return (int)call(feats, idx, out, B, N, C, HW, dtype, true, &L,
                   static_cast<cudaStream_t>(stream));
}
